"""Bridge the JAX package's variables into the port's ``state_dict``.

``load_jax_variables(model, variables)`` takes ``{"params": ..., "frozen":
...}`` as nested dicts of arrays (numpy, or anything ``np.asarray`` reads) and
loads them into a ``GeneralizedRCNN`` of this package. Names map onto
maskrcnn-benchmark's state_dict names, the correspondence the JAX package's
checkpoint converter uses in the other direction:

    params/backbone/body/layer1/block0/conv1/kernel
        -> backbone.body.layer1.0.conv1.weight      (HWIO -> OIHW)
    frozen/backbone/body/layer1/block0/downsample_bn/scale
        -> backbone.body.layer1.0.downsample.1.weight
    params/rpn_head/conv/bias            -> rpn.head.conv.bias
    params/feature_extractor/head/...    -> roi_heads.box.feature_extractor.head...
    params/predictor/cls_score/kernel    -> roi_heads.box.predictor.cls_score.weight
                                            ([in, out] -> [out, in])

The domain-adaptation heads act in training only and are skipped by
``SKIPPED_PREFIXES``. Any other key that names nothing in the model raises, as
does any model entry left unset or a shape that disagrees.
"""

from __future__ import annotations

import re

import numpy as np
import torch

SKIPPED_PREFIXES = ("da_heads/",)

_PREFIXES = (
    ("backbone/", "backbone."),
    ("rpn_head/", "rpn.head."),
    ("feature_extractor/", "roi_heads.box.feature_extractor."),
    ("predictor/", "roi_heads.box.predictor."),
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


def _to_torch_layout(path: str, value: np.ndarray) -> np.ndarray:
    if path.endswith("/kernel") and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if path.endswith("/kernel") and value.ndim == 2:
        return value.T                          # [in, out] -> [out, in]
    return value


def jax_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """The port's state_dict entries for the JAX ``variables``."""
    unknown = set(variables) - {"params", "frozen"}
    if unknown:
        raise KeyError(f"unknown variable collections: {sorted(unknown)}")
    state = {}
    for collection in ("params", "frozen"):
        for path, value in _flatten(variables.get(collection, {})):
            if path.startswith(SKIPPED_PREFIXES):
                continue
            value = _to_torch_layout(path, np.asarray(value, np.float32))
            state[torch_name(path)] = torch.from_numpy(
                np.ascontiguousarray(value))
    return state


def load_jax_variables(model: torch.nn.Module, variables: dict) -> None:
    """Load the JAX model's variables into ``model`` in place, strictly."""
    state = jax_state_dict(variables)
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    if extra:
        raise KeyError(f"JAX variables with no port counterpart: {extra}")
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: JAX shape {tuple(value.shape)} vs "
                             f"port {tuple(own[name].shape)}")
    model.load_state_dict(state, strict=True)
