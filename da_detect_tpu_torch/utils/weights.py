"""Bridge the JAX package's variables into the port's ``state_dict``.

``load_jax_variables(model, variables)`` takes ``{"params": ..., "frozen":
..., "batch_stats": ...}`` (each collection optional) as nested dicts of
arrays (numpy, or anything ``np.asarray`` reads) and loads them into a
``GeneralizedRCNN`` or a ``RetinaNet`` of this package. Names map onto
maskrcnn-benchmark's state_dict names, the correspondence the JAX package's
checkpoint converter uses in the other direction:

    params/backbone/body/layer1/block0/conv1/kernel
        -> backbone.body.layer1.0.conv1.weight      (HWIO -> OIHW)
    frozen/backbone/body/layer1/block0/downsample_bn/scale
        -> backbone.body.layer1.0.downsample.1.weight
    params/backbone/body/layer1/block0/bn1/scale   (GroupNorm, trainable)
        -> backbone.body.layer1.0.bn1.weight
    params/backbone/fpn/fpn_inner1_norm/bias
        -> backbone.fpn.fpn_inner1_norm.bias
    params/rpn_head/conv/bias            -> rpn.head.conv.bias
    params/feature_extractor/head/...    -> roi_heads.box.feature_extractor.head...
    params/predictor/cls_score/kernel    -> roi_heads.box.predictor.cls_score.weight
                                            ([in, out] -> [out, in])
    params/backbone/fpn/fpn_inner1/kernel   -> backbone.fpn.fpn_inner1.weight
    params/backbone/body/layer2/block0/conv2/conv_offset/kernel
        -> backbone.body.layer2.0.conv2.conv_offset.weight
    params/feature_extractor/fc6/kernel  -> roi_heads.box.feature_extractor.fc6.weight
        (its input rows permuted from JAX's (H, W, C) flatten of the pooled
        map to maskrcnn-benchmark's (C, H, W), then [in, out] -> [out, in])
    params/backbone/stages/block3/dw/kernel -> backbone.stages.3.dw.weight
        (FBNet; a depthwise HWIO [k, k, 1, C] -> OIHW [C, 1, k, k])
    params/backbone/first_bn/scale          -> backbone.first_bn.weight
    batch_stats/backbone/first_bn/mean      -> backbone.first_bn.running_mean
    batch_stats/backbone/first_bn/var       -> backbone.first_bn.running_var
    params/rpn_head_module/head/block0/pw/kernel
        -> rpn.head.head.0.pw.weight        (the FBNet RPN head)
    params/head/cls_tower0/kernel        -> rpn.head.cls_tower0.weight
                                            (RetinaNet's head)
    params/backbone/fpn/fpn_p6/kernel    -> backbone.fpn.fpn_p6.weight
    params/da_heads/imghead/conv1_da/kernel -> da_heads.imghead.conv1_da.weight
    params/da_heads/inshead/fc1_da/kernel   -> da_heads.inshead.fc1_da.weight
    params/mask_head/extractor/mask_fcn1/kernel
        -> roi_heads.mask.feature_extractor.mask_fcn1.weight
    params/mask_head/predictor/conv5_mask/kernel
        -> roi_heads.mask.predictor.conv5_mask.weight
        (Flax's ConvTranspose kernel [kh, kw, in, out] flipped in both
        spatial axes, then [in, out, kh, kw]: with SAME padding and
        ``transpose_kernel=False`` Flax applies the kernel unflipped,
        ``torch.nn.ConvTranspose2d`` flipped)
    params/keypoint_head/extractor/conv_fcn1/kernel
        -> roi_heads.keypoint.feature_extractor.conv_fcn1.weight
    params/keypoint_head/predictor/kps_score_lowres/kernel
        -> roi_heads.keypoint.predictor.kps_score_lowres.weight
        (flipped as ``conv5_mask``: Flax's padding (1, 1) on the dilated
        input is torch's ``padding=2``)

Any key that names nothing in the model raises, as does any model entry left
unset or a shape that disagrees, with one exception: variables with no
``da_heads`` subtree at all (what the JAX package's eval ``init`` creates,
since the DA heads act in training only) leave the port's DA heads as they
are.

``load_jax_train_state(state, jax_state)`` carries a JAX ``TrainState``
(params, frozen, ``DAState``, step, SGD momentum, GroupNorm's included) into
the port's, so that a run started with the JAX package continues here.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_PREFIXES = (
    ("backbone/", "backbone."),
    ("rpn_head/", "rpn.head."),
    ("rpn_head_module/", "rpn.head."),
    ("head/", "rpn.head."),
    ("feature_extractor/", "roi_heads.box.feature_extractor."),
    ("predictor/", "roi_heads.box.predictor."),
    ("da_heads/", "da_heads."),
    ("mask_head/extractor/", "roi_heads.mask.feature_extractor."),
    ("mask_head/predictor/", "roi_heads.mask.predictor."),
    ("keypoint_head/extractor/", "roi_heads.keypoint.feature_extractor."),
    ("keypoint_head/predictor/", "roi_heads.keypoint.predictor."),
)

_PARTS = {
    "downsample_conv": "downsample.0",
    "downsample_bn": "downsample.1",
    "kernel": "weight",
    "scale": "weight",
}


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def torch_name(path: str) -> str:
    """JAX module path (collection stripped) -> state_dict name."""
    for jax_prefix, torch_prefix in _PREFIXES:
        if path.startswith(jax_prefix):
            rest = path[len(jax_prefix):].split("/")
            parts = [re.sub(r"^block(\d+)$", r"\1", _PARTS.get(p, p))
                     for p in rest]
            return torch_prefix + ".".join(parts)
    raise KeyError(f"JAX variable {path!r} has no counterpart in the port")


def _to_torch_layout(path: str, value: np.ndarray,
                     fc6_chw=None) -> np.ndarray:
    if path == "feature_extractor/fc6/kernel":
        if fc6_chw is None:
            raise ValueError("an fc6 kernel needs the pooled (C, P, P) shape "
                             "to reorder its inputs")
        c, ph, pw = fc6_chw
        value = value.reshape(ph, pw, c, -1).transpose(2, 0, 1, 3).reshape(
            c * ph * pw, -1)
    if path.endswith(("conv5_mask/kernel", "kps_score_lowres/kernel")):
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    if path.endswith("/kernel") and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if path.endswith("/kernel") and value.ndim == 2:
        return value.T                          # [in, out] -> [out, in]
    return value


# the BatchNorm statistics' names in ``batch_stats``
_STATS = {"mean": "running_mean", "var": "running_var"}


def jax_state_dict(variables: dict,
                   fc6_chw=None) -> dict[str, torch.Tensor]:
    """The port's state_dict entries for the JAX ``variables``.
    ``fc6_chw``: the (C, P, P) pooled map an FPN MLP head's fc6 reads."""
    unknown = set(variables) - {"params", "frozen", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections: {sorted(unknown)}")
    state = {}
    for collection in ("params", "frozen", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            value = _to_torch_layout(path, np.array(value, np.float32),
                                     fc6_chw)
            name = torch_name(path)
            if collection == "batch_stats":
                head, _, leaf = name.rpartition(".")
                if leaf not in _STATS:
                    raise KeyError(f"JAX variable batch_stats/{path!r} has "
                                   "no counterpart in the port")
                name = f"{head}.{_STATS[leaf]}"
            state[name] = torch.from_numpy(np.ascontiguousarray(value))
    return state


def fc6_chw(model: torch.nn.Module):
    """The (C, P, P) pooled map the model's FPN MLP head flattens into fc6,
    or None for a model without one."""
    if not hasattr(model, "roi_heads"):  # RetinaNet
        return None
    box = model.roi_heads["box"]
    ext = box["feature_extractor"] if "feature_extractor" in box else None
    if ext is None or not hasattr(ext, "fc6"):
        return None
    p = ext.pooler["output_size"]
    return ext.fc6.in_features // (p * p), p, p


def load_jax_variables(model: torch.nn.Module, variables: dict) -> None:
    """Load the JAX model's variables into ``model`` in place, strictly."""
    state = jax_state_dict(variables, fc6_chw(model))
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    if extra:
        raise KeyError(f"JAX variables with no port counterpart: {extra}")
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: JAX shape {tuple(value.shape)} vs "
                             f"port {tuple(own[name].shape)}")
    if not any(name.startswith("da_heads.") for name in state):
        # eval variables: the DA heads keep their own weights
        state.update({k: v for k, v in own.items()
                      if k.startswith("da_heads.")})
    model.load_state_dict(state, strict=True)


def load_jax_train_state(state, jax_state) -> None:
    """Carry a JAX ``TrainState`` (``step``, ``params``, ``frozen``,
    ``da_state``, ``opt_state`` = (step, SGDState(momentum))) into the port's
    ``TrainState`` in place: the model's weights, the four ``DAState``
    scalars, the step and the momentum of every trainable parameter. The
    JAX key has no PyTorch counterpart; the generator is left as it is."""
    model = state.model
    load_jax_variables(model, {"params": jax_state.params,
                               "frozen": jax_state.frozen})
    dev = next(model.parameters()).device
    da = jax_state.da_state
    state.da_state = type(state.da_state)(**{
        f: torch.tensor(np.asarray(getattr(da, f), np.float32), device=dev)
        for f in ("margin_img", "margin_ins", "last_triplet_img",
                  "last_triplet_ins")})
    state.step = int(np.asarray(jax_state.step))
    momentum = jax_state_dict({"params": jax_state.opt_state[1].momentum},
                              fc6_chw(model))
    trainable = dict(model.named_parameters())
    state.optimizer.set_momentum_buffers(
        {k: v for k, v in momentum.items() if trainable[k].requires_grad})
