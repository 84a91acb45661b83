"""The operations of a backbone's forward that read across rows without
being layers of their own: a max pool, the FPN's nearest 2x upsample and
FBNet's SAME padding. The backbone modules that use them (the ResNet stem,
the FPN, VGG-16, the FBNet trunk and its blocks) call them as ``RowOps``
methods, so that a mesh putting the backbone on row shards
(``parallel/spatial.py``) replaces these three and leaves the rest of each
forward as it is."""

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

    def same_pad(self, x: torch.Tensor, kernel: int,
                 stride: int) -> torch.Tensor:
        return same_pad(x, kernel, stride)


def same_pads(n: int, kernel: int, stride: int) -> list:
    """[before, after]: Flax's ``padding="SAME"`` on a side of ``n`` for a
    ``kernel``-wide window at ``stride``: a total of
    ``max((ceil(n / s) - 1) * s + k - n, 0)``, the smaller half before."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return [total // 2, total - total // 2]


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``x`` [B, C, H, W] padded with zeros as Flax's ``padding="SAME"``
    pads for a ``kernel`` x ``kernel`` conv at ``stride`` (``same_pads``
    on each side); the conv that follows pads nothing."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        pads += same_pads(n, kernel, stride)
    return F.pad(x, pads).contiguous(memory_format=torch.channels_last)
