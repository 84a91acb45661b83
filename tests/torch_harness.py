"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both the
JAX reference and the port. Weights never come from either framework's own
initializer: the two draw different numbers from one seed.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

import __graft_entry__ as graft


def tiny_cfgs():
    """(JAX cfg, port cfg) of the flagship model, narrowed for the CPU:
    canvas 64x96, 64 -> 16 proposals, stem 16, width 8, res2 32, float32."""
    from da_detect_tpu_torch.entry import flagship_cfg

    jcfg = graft._flagship_cfg(canvas=(64, 96), test_tops=(64, 16))
    pcfg = flagship_cfg(canvas=(64, 96), test_tops=(64, 16))
    for cfg in (jcfg, pcfg):
        cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
        cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
        cfg.TPU.COMPUTE_DTYPE = "float32"
    return jcfg, pcfg


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def random_variables(shapes, seed: int, scales: dict | None = None) -> dict:
    """numpy variables with the structure of ``shapes`` (a tree of
    ShapeDtypeStructs, e.g. from ``jax.eval_shape`` of an init).

    Conv and Dense kernels: normal with std 1/sqrt(fan_in); biases:
    normal(0.1); FrozenBN scales uniform(0.5, 1.5), biases normal(0.1) — so
    the folded affine is exercised, not the identity. ``scales`` maps a path
    suffix (e.g. "cls_logits/kernel") to a factor, which spreads the scores
    that proposal and detection selection sort (random-init scores otherwise
    sit within float32 noise of each other)."""
    rng = np.random.RandomState(seed)
    scales = scales or {}

    def draw(path, s):
        name = _path_str(path)
        if name.endswith("/kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.randn(*s.shape) / np.sqrt(fan_in)
        elif name.endswith("/scale"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.randn(*s.shape)
        for suffix, factor in scales.items():
            if name.endswith(suffix):
                v = v * factor
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def nhwc_to_torch(x) -> torch.Tensor:
    """numpy NHWC -> torch logical NCHW in channels-last memory."""
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def torch_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def module_state(variables: dict, jax_prefix: str, torch_prefix: str) -> dict:
    """The port state_dict of one submodule: wrap ``variables`` of a JAX
    submodule under ``jax_prefix`` (e.g. "backbone/body"), map them with the
    port's loader and strip ``torch_prefix`` from the names."""
    from da_detect_tpu_torch.utils.weights import jax_state_dict

    wrapped = {}
    for coll, tree in variables.items():
        for part in reversed(jax_prefix.split("/")):
            tree = {part: tree}
        wrapped[coll] = tree
    state = jax_state_dict(wrapped)
    return {k[len(torch_prefix):]: v for k, v in state.items()}
