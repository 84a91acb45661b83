"""Convolutions and linear layers that compute in a configured dtype, as
Flax's ``nn.Conv(dtype=...)``, ``nn.ConvTranspose(dtype=...)`` and
``nn.Dense(dtype=...)`` do in the JAX package (``TPU.COMPUTE_DTYPE``).

The parameters stay float32 (Flax's ``param_dtype``); at each call the
input, the weight and the bias are cast to ``compute_dtype`` and the output
comes out in it. In bfloat16 the bias is added after the product, in
bfloat16, as Flax adds it (a rounding of the product, then one of the sum);
cuDNN's and oneDNN's fused bias rounds once, which differs from the JAX
package. In float32 the layers are plain ``nn.Conv2d``,
``nn.ConvTranspose2d`` and ``nn.Linear``. The cast's backward hands the float32
parameters float32 gradients. State-dict names are those of the torch
layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(cfg) -> torch.dtype:
    """``TPU.COMPUTE_DTYPE`` as a torch dtype: bfloat16 or float32."""
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" \
        else torch.float32


def _bias_after(y: torch.Tensor, bias, channel_dim: int) -> torch.Tensor:
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(y.dtype).view(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (float32 parameters)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight, self.bias, self.padding,
                         self.groups)

    def conv(self, x, weight, bias, padding, groups: int) -> torch.Tensor:
        """The layer's computation on these operands (the mesh's row shards
        and split kernels pass their own)."""
        d = self.compute_dtype
        if d == torch.float32:
            return F.conv2d(x, weight, bias, self.stride, padding,
                            self.dilation, groups)
        y = F.conv2d(x.to(d), weight.to(d), None, self.stride, padding,
                     self.dilation, groups)
        return y if bias is None else _bias_after(y, bias, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` (float32
    parameters)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight, self.bias)

    def conv(self, x, weight, bias) -> torch.Tensor:
        """The layer's computation on these operands."""
        d = self.compute_dtype
        if d == torch.float32:
            return F.conv_transpose2d(x, weight, bias, self.stride,
                                      self.padding, self.output_padding,
                                      self.groups, self.dilation)
        y = F.conv_transpose2d(x.to(d), weight.to(d), None, self.stride,
                               self.padding, self.output_padding, self.groups,
                               self.dilation)
        return y if bias is None else _bias_after(y, bias, 1)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (float32 parameters)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x, self.weight, self.bias)

    def linear(self, x, weight, bias) -> torch.Tensor:
        """The layer's computation on these operands."""
        d = self.compute_dtype
        if d == torch.float32:
            return F.linear(x, weight, bias)
        y = F.linear(x.to(d), weight.to(d))
        return y if bias is None else _bias_after(y, bias, -1)
