"""Normalization layers (port of ``da_detect_tpu/layers/norms.py``).

FrozenBatchNorm: BN with inference statistics folded into a per-channel
affine (reference layers/batch_norm.py:6-24). The scale and bias are buffers,
never parameters, so nothing can train them. They keep maskrcnn-benchmark's
state_dict names (``weight``, ``bias``) and hold the folded values, which the
JAX package calls ``scale`` and ``bias``. They stay float32 and are cast to
the input's dtype at use, as in the JAX package: a bfloat16 activation gets
a bfloat16 affine (a float32 buffer would promote it to float32).

GroupNorm: Flax's ``nn.GroupNorm`` as the JAX package builds it (32 groups,
eps 1e-5, float32 ``scale``/``bias`` parameters, here ``weight``/``bias``):
float32 statistics over each group and a float32 output **whatever the
input's dtype**. Flax's ``dtype=None`` promotes a bfloat16 input against the
float32 statistics, so every GroupNorm output of a bfloat16 model is a
float32 island (the next conv casts it back at use); here the input is
widened to float32 and normalized by ``F.group_norm`` (one fused launch
forward, PyTorch's; Flax takes the variance as E[x²] - E[x]², PyTorch by
Welford's sums: the two differ by float32 rounding). It is never rounded to
bfloat16.

BatchNorm: Flax's ``nn.BatchNorm(use_running_average=True)`` as the FBNet
bodies and heads use it: trained ``scale`` and ``bias`` (here ``weight`` and
``bias`` parameters) over fixed statistics ``mean`` and ``var`` (buffers
``running_mean`` and ``running_var``, which nothing updates: not
``nn.BatchNorm2d``, which takes the batch's statistics under
``model.train()``), eps 1e-5, computed as Flax does, ``(x - mean) *
(rsqrt(var + eps) * scale) + bias``, in float32 and with a float32 output
whatever the input's dtype (Flax's promotion, as GroupNorm's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x [N, C, H, W]
        scale = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return x * scale + self.bias.to(x.dtype).view(1, -1, 1, 1)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` on logical NCHW; returns float32."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{num_channels} channels")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        # PyTorch's CUDA kernel writes NCHW memory; keep channels-last (the
        # ROIAlign kernels read C as the contiguous axis)
        if x.is_contiguous(memory_format=torch.channels_last):
            return y.contiguous(memory_format=torch.channels_last)
        return y


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(use_running_average=True)`` on logical NCHW;
    returns float32."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean.view(1, -1, 1, 1))
                * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1))


def make_norm(kind: str, num_channels: int) -> nn.Module:
    """The JAX package's factory: "frozen_bn", "gn" (32 groups, eps 1e-5) or
    "none"."""
    if kind == "frozen_bn":
        return FrozenBatchNorm(num_channels)
    if kind == "gn":
        return GroupNorm(num_channels)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm kind: {kind}")
