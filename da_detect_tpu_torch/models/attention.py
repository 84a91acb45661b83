"""Position and channel attention (port of
``da_detect_tpu/models/attention.py``; the reference's SAGAN-style PAM and
CAM, optional building blocks that its forward never instantiates).

Maps are logical NCHW. The affinities are float32 products of the inputs
(the JAX package's ``preferred_element_type=float32``: a bfloat16 map's
values widened, so their products are exact), softmaxed in float32 and
rounded to the map's dtype before the weighted sum. ``gamma`` starts at 0,
so an untrained module is the identity; its product with the attended map,
and the residual, are float32 (JAX promotes a bfloat16 map with the float32
``gamma``). The products are plain ``torch.matmul``: no TPU kernel stands
behind them. Quadratic in the pixels (PAM) or the channels (CAM).
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import Conv2d


class PAM(nn.Module):
    """Position attention: softmax over pairwise pixel affinities of
    ``query`` and ``key`` (1x1 convs to C // 8), applied to ``value``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query = Conv2d(channels, channels // 8, 1, compute_dtype=dtype)
        self.key = Conv2d(channels, channels // 8, 1, compute_dtype=dtype)
        self.value = Conv2d(channels, channels, 1, compute_dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q = self.query(x).flatten(2).transpose(1, 2)          # [B, N, C/8]
        k = self.key(x).flatten(2).transpose(1, 2)
        v = self.value(x).flatten(2).transpose(1, 2)          # [B, N, C]
        att = torch.softmax(torch.matmul(q.float(), k.float().transpose(1, 2)),
                            dim=-1).to(x.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * out.float() + x.float()


class CAM(nn.Module):
    """Channel attention: softmax over the max-normalized channel-channel
    affinities."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = x.reshape(b, c, h * w)                          # [B, C, N]
        energy = torch.matmul(flat.float(), flat.float().transpose(1, 2))
        # the reference's max-normalized energy before the softmax
        energy = energy.amax(dim=-1, keepdim=True) - energy
        att = torch.softmax(energy, dim=-1).to(x.dtype)
        out = torch.matmul(att, flat).reshape(b, c, h, w)
        return self.gamma * out.float() + x.float()
