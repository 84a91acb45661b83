"""Detectron SGD (port of ``da_detect_tpu/solver/optim.py``).

SGD with momentum and torch-SGD semantics (weight decay added to the
gradient before the momentum buffer). Biases form their own group with their
own schedule (base lr x ``BIAS_LR_FACTOR``, the shared warmup floor and
minimum) and ``WEIGHT_DECAY_BIAS``; everything else takes ``BASE_LR`` and
``WEIGHT_DECAY``. A parameter is a bias by its name, as in the JAX
package's label tree: a GroupNorm's ``bias`` is one, its ``weight`` (Flax's
``scale``) is a weight. Parameters frozen by ``FREEZE_CONV_BODY_AT`` have
``requires_grad`` off and stay out of the optimizer.
"""

from __future__ import annotations

from typing import Callable

import torch

from .schedules import make_lr_scheduler


class DetectronSGD:
    """``torch.optim.SGD`` over two groups, "weight" and "bias", whose
    learning rates are set from their schedules at each step."""

    def __init__(self, named_params, momentum: float, weight_decay: float,
                 weight_decay_bias: float, schedule: Callable,
                 bias_schedule: Callable):
        weights, biases = [], []
        self.names = {}
        for name, p in named_params:
            if not p.requires_grad:
                continue
            (biases if name.endswith("bias") else weights).append(p)
            self.names[p] = name
        self.schedules = (schedule, bias_schedule)
        self.sgd = torch.optim.SGD(
            [dict(params=weights, weight_decay=weight_decay, name="weight"),
             dict(params=biases, weight_decay=weight_decay_bias,
                  name="bias")],
            lr=schedule(0), momentum=momentum)

    def lrs(self, iteration: int) -> tuple[float, float]:
        return tuple(s(iteration) for s in self.schedules)

    def step(self, iteration: int) -> None:
        """One update at the learning rates of ``iteration`` (the count of
        updates made before this one). A parameter that took no gradient
        this step is updated with a zero one (decay and momentum still act),
        as the JAX package's optimizer does."""
        for group, lr in zip(self.sgd.param_groups, self.lrs(iteration)):
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.sgd.step()

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def momentum_buffers(self) -> dict:
        """Parameter name -> momentum buffer (after the first step)."""
        return {self.names[p]: st["momentum_buffer"]
                for p, st in self.sgd.state.items()
                if st.get("momentum_buffer") is not None}

    def set_momentum_buffers(self, buffers: dict) -> None:
        by_name = {n: p for p, n in self.names.items()}
        unknown = sorted(set(buffers) - set(by_name))
        if unknown:
            raise KeyError(f"momentum for no trainable parameter: {unknown}")
        for name, buf in buffers.items():
            p = by_name[name]
            self.sgd.state[p]["momentum_buffer"] = buf.to(
                device=p.device, dtype=p.dtype).clone()

    def state_dict(self) -> dict:
        return self.sgd.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state)


def make_optimizer(cfg, model: torch.nn.Module,
                   schedule_kind: str = "multistep") -> DetectronSGD:
    s = cfg.SOLVER
    return DetectronSGD(
        model.named_parameters(), s.MOMENTUM, s.WEIGHT_DECAY,
        s.WEIGHT_DECAY_BIAS, make_lr_scheduler(cfg, schedule_kind),
        make_lr_scheduler(cfg, schedule_kind, base_scale=s.BIAS_LR_FACTOR))
