"""Learning-rate schedules (port of ``da_detect_tpu/solver/schedules.py``).

* ``warmup_multistep``: linear or constant warmup, then step decay (the
  reference's WarmupMultiStepLR).
* ``warmup_cosine``: the triplet trainer's timm CosineLRScheduler with
  ``t_in_epochs=False`` and ``warmup_prefix=False``: the cosine phase counts
  iterations from 0, the warmup span included.

A schedule is a function iteration -> learning rate (a Python float, so that
setting it costs no device work).
"""

from __future__ import annotations

import math


def warmup_multistep(base_lr: float, steps, gamma: float = 0.1,
                     warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                     warmup_method: str = "linear"):
    steps = tuple(sorted(steps))

    def schedule(it: int) -> float:
        if it < warmup_iters:
            if warmup_method == "constant":
                warm = warmup_factor
            else:
                alpha = it / max(warmup_iters, 1)
                warm = warmup_factor * (1 - alpha) + alpha
        else:
            warm = 1.0
        return base_lr * warm * gamma ** sum(it >= s for s in steps)

    return schedule


def warmup_cosine(base_lr: float, max_iter: int, lr_min: float = 1e-6,
                  warmup_lr_init: float = 1e-4, warmup_iters: int = 0):
    def schedule(it: int) -> float:
        if it < warmup_iters:
            return (warmup_lr_init
                    + it * (base_lr - warmup_lr_init) / max(warmup_iters, 1))
        return lr_min + 0.5 * (base_lr - lr_min) * (
            1.0 + math.cos(math.pi * it / max_iter))

    return schedule


def make_lr_scheduler(cfg, kind: str = "multistep", base_scale: float = 1.0):
    """``base_scale`` scales the base learning rate only, not WARMUP_LR or
    LR_MIN: each parameter group keeps the shared warmup floor and minimum,
    as both reference schedulers treat per-group rates."""
    s = cfg.SOLVER
    if kind == "cosine":
        return warmup_cosine(s.BASE_LR * base_scale, s.MAX_ITER, s.LR_MIN,
                             s.WARMUP_LR, s.WARMUP_ITERS)
    if kind == "multistep":
        return warmup_multistep(s.BASE_LR * base_scale, s.STEPS, s.GAMMA,
                                s.WARMUP_FACTOR, s.WARMUP_ITERS,
                                s.WARMUP_METHOD)
    raise ValueError(f"unknown schedule kind: {kind!r}")
