"""Gradient scaling / reversal layer (port of ``da_detect_tpu/ops/grl.py``).

Identity forward, ``grad * weight`` backward. A negative weight reverses the
gradient for adversarial domain classifiers; the consistency branch uses a
positive one. The weight may be a Python float or a 0-d tensor on the
device (AdvGRL computes it from a probe loss): it is never read on the host
and takes no gradient. The gradient is scaled in its own dtype (a
bfloat16 gradient by the weight rounded to bfloat16), as in the JAX package.
"""

from __future__ import annotations

import torch


class _GradientScalar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.weight = weight
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        weight = ctx.weight
        if isinstance(weight, torch.Tensor):
            weight = weight.to(grad.dtype)
        elif grad.dtype != torch.float32:
            # rounded on the host: no tensor made on the device
            weight = float(torch.tensor(weight, dtype=grad.dtype))
        return grad * weight, None


def gradient_scalar(x: torch.Tensor, weight) -> torch.Tensor:
    if isinstance(weight, torch.Tensor):
        weight = weight.detach()
    return _GradientScalar.apply(x, weight)
