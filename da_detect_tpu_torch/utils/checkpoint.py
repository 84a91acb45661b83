"""Train-state checkpoints with ``torch.save`` (the port's counterpart of the
JAX package's orbax ``utils/checkpoint.py``).

``Checkpointer.save(step, state)`` writes ``model_{step:07d}.pth`` under the
output directory (model ``state_dict``, optimizer state, ``DAState``, step,
generator state; on the main process only in a process group) and points
``last_checkpoint`` at it; ``resume(state)``
restores the newest into a ``TrainState`` in place, ``resume_model(model)``
only its model (evaluation); ``all_steps()`` and ``load_model(model, step)``
reach every checkpoint of the directory (batch evaluation). A checkpoint
is loaded with ``weights_only=True``: it holds tensors and plain
containers only.

``load_weight_file(path, model)`` loads external weights (``MODEL.WEIGHT``):
``catalog://`` ids, Detectron C2 ``.pkl`` ImageNet weights and
maskrcnn-benchmark (or the port's) ``.pth`` checkpoints, through
``utils/c2_loading.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re

import numpy as np
import torch

from ..config.catalog import ModelCatalog
from . import c2_loading, comm

log = logging.getLogger(__name__)


class Checkpointer:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)

    def _pointer(self) -> str:
        return os.path.join(self.output_dir, "last_checkpoint")

    def save(self, step: int, state) -> str:
        """Write the checkpoint of ``step``; returns its path. In a process
        group every rank calls it: the main process writes (with every
        rank's generator state, ``generators``), the others wait at a
        barrier until the file is there."""
        path = os.path.join(self.output_dir, f"model_{step:07d}.pth")
        generators = comm.all_gather(state.generator.get_state())
        if comm.is_main_process():
            os.makedirs(self.output_dir, exist_ok=True)
            ckpt = {
                "step": int(step),
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "da_state": dataclasses.asdict(state.da_state),
                "generator": generators[0],
            }
            if len(generators) > 1:
                ckpt["generators"] = generators
            torch.save(ckpt, path)
            with open(self._pointer(), "w") as f:
                f.write(os.path.basename(path))
        comm.synchronize()
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._pointer())

    def _newest(self) -> str:
        with open(self._pointer()) as f:
            return os.path.join(self.output_dir, f.read().strip())

    def all_steps(self) -> list[int]:
        """The steps of the directory's ``model_<step>.pth`` files, oldest
        first."""
        if not os.path.isdir(self.output_dir):
            return []
        return sorted(int(m.group(1)) for m in (
            re.fullmatch(r"model_(\d+)\.pth", name)
            for name in os.listdir(self.output_dir)) if m)

    def resume_model(self, model) -> int:
        """Load the newest checkpoint's model weights into ``model``; returns
        its step. Raises when there is none. The DA heads act in training
        only: a model built without them (an eval config) takes the rest."""
        if not self.has_checkpoint():
            raise FileNotFoundError(f"no checkpoint under {self.output_dir}")
        return self.load_model(model)

    def load_model(self, model, step: int | None = None) -> int:
        """``resume_model`` from the checkpoint of ``step`` (None: the
        newest); returns its step."""
        path = self._newest() if step is None else os.path.join(
            self.output_dir, f"model_{step:07d}.pth")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        weights = ckpt["model"]
        if model.da_heads is None:
            weights = {k: v for k, v in weights.items()
                       if not k.startswith("da_heads.")}
        model.load_state_dict(weights)
        log.info("loaded the model of %s (iteration %d)", path, ckpt["step"])
        return ckpt["step"]

    def resume(self, state):
        """Load the newest checkpoint into ``state`` (a TrainState); returns
        (state, step), or (state, 0) when there is none. Every rank of a
        process group resumes: its own generator state when the checkpoint
        was written by as many ranks, else the main process's."""
        if not self.has_checkpoint():
            return state, 0
        path = self._newest()
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        dev = next(state.model.parameters()).device
        state.da_state = type(state.da_state)(
            **{k: v.to(dev) for k, v in ckpt["da_state"].items()})
        generators = ckpt.get("generators", [ckpt["generator"]])
        rank, world = comm.get_rank(), comm.get_world_size()
        state.generator.set_state(generators[rank] if len(generators) == world
                                  else ckpt["generator"])
        state.step = ckpt["step"]
        log.info("resumed from %s at iteration %d", path, state.step)
        comm.synchronize()
        return state, state.step


def load_weight_file(path: str, model: torch.nn.Module,
                     pool_resolution: int | None = None) -> list[str]:
    """Load external weights into ``model`` in place; returns the names
    loaded. Names the model lacks are logged and skipped (an ImageNet file
    has a classifier, a detector checkpoint may have heads this model has
    not); a shape that disagrees raises. ``pool_resolution``
    (``MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION``): a torch checkpoint whose fc6
    implies another box pooler resolution raises."""
    if path.startswith("catalog://"):
        path = ModelCatalog.get(path)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"weight file not found: {path} (place pretrained weights under "
            "$DA_DETECT_WEIGHTS_DIR)")
    own = model.state_dict()
    if path.endswith(".pkl"):
        c4 = any(k.startswith("roi_heads.box.feature_extractor.head.")
                 for k in own)
        state = c2_loading.c2_resnet_state(c2_loading.load_c2_pickle(path),
                                           c4_head=c4)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        raw = ckpt.get("model", ckpt)
        inferred = c2_loading.infer_pool_resolution(raw)
        if pool_resolution is not None and inferred is not None \
                and inferred != pool_resolution:
            raise ValueError(
                f"{path}: its fc6 implies box pooler resolution {inferred}, "
                f"the model's is {pool_resolution}")
        state = c2_loading.torch_state(raw)
    applied, unmatched = [], []
    for name, value in state.items():
        if name not in own:
            unmatched.append(name)
            continue
        if tuple(np.shape(value)) != tuple(own[name].shape):
            raise ValueError(f"{name}: file shape {tuple(np.shape(value))} "
                             f"vs model {tuple(own[name].shape)}")
        with torch.no_grad():
            own[name].copy_(torch.from_numpy(
                np.ascontiguousarray(value, np.float32)))
        applied.append(name)
    log.info("loaded %d tensors from %s", len(applied), path)
    if unmatched:
        log.info("names in %s the model lacks (first 10): %s", path,
                 unmatched[:10])
    return applied
