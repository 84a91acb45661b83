"""Train-state checkpoints with ``torch.save`` (the port's counterpart of the
JAX package's orbax ``utils/checkpoint.py``).

``Checkpointer.save(step, state)`` writes ``model_{step:07d}.pth`` under the
output directory (model ``state_dict``, optimizer state, ``DAState``, step,
generator state) and points ``last_checkpoint`` at it; ``resume(state)``
restores the newest into a ``TrainState`` in place. A checkpoint is loaded
with ``weights_only=True``: it holds tensors and plain containers only.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

log = logging.getLogger(__name__)


class Checkpointer:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)

    def _pointer(self) -> str:
        return os.path.join(self.output_dir, "last_checkpoint")

    def save(self, step: int, state) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, f"model_{step:07d}.pth")
        torch.save({
            "step": int(step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "da_state": dataclasses.asdict(state.da_state),
            "generator": state.generator.get_state(),
        }, path)
        with open(self._pointer(), "w") as f:
            f.write(os.path.basename(path))
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._pointer())

    def resume(self, state):
        """Load the newest checkpoint into ``state`` (a TrainState); returns
        (state, step), or (state, 0) when there is none."""
        if not self.has_checkpoint():
            return state, 0
        with open(self._pointer()) as f:
            path = os.path.join(self.output_dir, f.read().strip())
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        dev = next(state.model.parameters()).device
        state.da_state = type(state.da_state)(
            **{k: v.to(dev) for k, v in ckpt["da_state"].items()})
        state.generator.set_state(ckpt["generator"])
        state.step = ckpt["step"]
        log.info("resumed from %s at iteration %d", path, state.step)
        return state, state.step
