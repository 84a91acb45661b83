"""The two operations of a backbone's forward that read across rows
without being layers of their own: a max pool and the FPN's nearest 2x
upsample. The backbone modules that use them (the ResNet stem, the FPN,
VGG-16) call them as ``RowOps`` methods, so that a mesh putting the
backbone on row shards (``parallel/spatial.py``) replaces these two and
leaves the rest of each forward as it is."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class RowOps:
    def max_pool(self, x: torch.Tensor, kernel_size: int, stride: int,
                 padding: int = 0) -> torch.Tensor:
        return F.max_pool2d(x, kernel_size, stride, padding)

    def upsample_2x(self, x: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
        """Nearest 2x upsample [B, C, H, W] -> [B, C, 2H, 2W], cropped to
        ``like``'s H and W (odd lateral sizes)."""
        up = F.interpolate(x, scale_factor=2, mode="nearest")
        return up[:, :, :like.shape[2], :like.shape[3]]
