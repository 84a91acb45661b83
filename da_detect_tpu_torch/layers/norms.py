"""Normalization layers (port of ``da_detect_tpu/layers/norms.py``).

FrozenBatchNorm: BN with inference statistics folded into a per-channel
affine (reference layers/batch_norm.py:6-24). The scale and bias are buffers,
never parameters, so nothing can train them. They keep maskrcnn-benchmark's
state_dict names (``weight``, ``bias``) and hold the folded values, which the
JAX package calls ``scale`` and ``bias``.
"""

from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x [N, C, H, W]
        return x * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
