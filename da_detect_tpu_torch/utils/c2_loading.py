"""Pretrained-weight converters (port of ``da_detect_tpu/utils/c2_loading.py``;
reference utils/c2_model_loading.py:13-206 and
utils/model_serialization.py:18-95): Detectron C2 pickles and
maskrcnn-benchmark torch checkpoints -> the port's ``state_dict`` names.

The port's modules carry maskrcnn-benchmark's names and layouts (OIHW
convolutions, [out, in] linears, fc6 over the (C, H, W) flatten), so a torch
checkpoint maps key for key, and a C2 blob name maps to one name:

    conv1_w                  -> backbone.body.stem.conv1.weight
    res_conv1_bn_{s,b}       -> backbone.body.stem.bn1.{weight,bias}
    res{S}_{j}_branch2a_w    -> backbone.body.layer{S-1}.{j}.conv1.weight
    res{S}_{j}_branch1_bn_s  -> backbone.body.layer{S-1}.{j}
                                .downsample.1.weight
    res5_* with a C4 head    -> roi_heads.box.feature_extractor.head.layer4.*

FrozenBatchNorm: C2 pickles ship the folded scale and bias; a torch
checkpoint's running statistics are folded as the reference's
layers/batch_norm.py:20-22 does (scale = weight / sqrt(running_var), no
eps; bias = bias - running_mean * scale), in float64.

Weight files are the user's own inputs: a C2 pickle is unpickled, as the
reference does, so load only files from a source you trust.
"""

from __future__ import annotations

import math
import pickle
import re

import numpy as np

# branch -> (conv module, bn module)
_BRANCH = {"branch2a": ("conv1", "bn1"), "branch2b": ("conv2", "bn2"),
           "branch2c": ("conv3", "bn3"),
           "branch1": ("downsample.0", "downsample.1")}
_C2_BLOB = re.compile(r"^res(\d)_(\d+)_(branch[12][abc]?)_(w|bn_s|bn_b)$")


def load_c2_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "blobs" in data:
        data = data["blobs"]
    return data


def c2_resnet_state(blobs: dict, *, c4_head: bool) -> dict:
    """Detectron ImageNet R-50/101/152 (or X-101) blobs -> {state_dict name:
    array} for the ResNet body, and the res5 box head with ``c4_head``."""
    state = {"backbone.body.stem.conv1.weight": blobs["conv1_w"],
             "backbone.body.stem.bn1.weight": blobs["res_conv1_bn_s"],
             "backbone.body.stem.bn1.bias": blobs["res_conv1_bn_b"]}
    for key, val in blobs.items():
        m = _C2_BLOB.match(key)
        if not m:
            continue
        stage, block, branch, kind = (int(m.group(1)), int(m.group(2)),
                                      m.group(3), m.group(4))
        conv, bn = _BRANCH[branch]
        if stage <= 4 or not c4_head:
            base = f"backbone.body.layer{stage - 1}.{block}"
        else:
            base = f"roi_heads.box.feature_extractor.head.layer4.{block}"
        if kind == "w":
            state[f"{base}.{conv}.weight"] = val
        else:
            part = "weight" if kind == "bn_s" else "bias"
            state[f"{base}.{bn}.{part}"] = val
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def _strip_prefix(state: dict) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def torch_state(state: dict) -> dict:
    """A maskrcnn-benchmark (or the port's own) state_dict -> {name: numpy
    array}, FrozenBN running statistics folded into weight and bias."""
    state = {k: np.asarray(v) for k, v in _strip_prefix(state).items()}
    for prefix in sorted({k[:-len(".running_var")] for k in state
                          if k.endswith(".running_var")}):
        w = state.pop(prefix + ".weight").astype(np.float64)
        b = state.pop(prefix + ".bias").astype(np.float64)
        mean = state.pop(prefix + ".running_mean").astype(np.float64)
        var = state.pop(prefix + ".running_var").astype(np.float64)
        scale = w / np.sqrt(var)
        state[prefix + ".weight"] = scale.astype(np.float32)
        state[prefix + ".bias"] = (b - mean * scale).astype(np.float32)
    return state


def infer_pool_resolution(state: dict):
    """The box pooler resolution R of a torch checkpoint: fc6's input dim
    is C * R * R with C the FPN's channels. None when the checkpoint has no
    fc6 (C4 head) or the shapes pin no unique R."""
    state = _strip_prefix(state)
    fc6 = state.get("roi_heads.box.feature_extractor.fc6.weight")
    if fc6 is None:
        return None
    in_f = int(np.asarray(fc6).shape[1])
    chans = None
    for k in ("backbone.fpn.fpn_layer1.weight",
              "backbone.fpn.fpn_layer2.weight"):
        if k in state:
            chans = int(np.asarray(state[k]).shape[0])
            break
    if not chans or in_f % chans:
        return None
    r = math.isqrt(in_f // chans)
    return r if r * r * chans == in_f else None
