"""Normalization layers (port of ``da_detect_tpu/layers/norms.py``).

FrozenBatchNorm: BN with inference statistics folded into a per-channel
affine (reference layers/batch_norm.py:6-24). The scale and bias are buffers,
never parameters, so nothing can train them. They keep maskrcnn-benchmark's
state_dict names (``weight``, ``bias``) and hold the folded values, which the
JAX package calls ``scale`` and ``bias``. They stay float32 and are cast to
the input's dtype at use, as in the JAX package: a bfloat16 activation gets
a bfloat16 affine (a float32 buffer would promote it to float32).
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
        scale = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return x * scale + self.bias.to(x.dtype).view(1, -1, 1, 1)
