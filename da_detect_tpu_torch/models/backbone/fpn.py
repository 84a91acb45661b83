"""Feature Pyramid Network (port of ``da_detect_tpu/models/backbone/fpn.py``,
the two-stage form).

Lateral 1x1 convs (``fpn_inner{i}``), nearest 2x top-down then cropped to
the lateral's size, 3x3 output convs (``fpn_layer{i}``), and
``LastLevelMaxPool`` (kernel 1, stride 2) for P6. Module names follow
maskrcnn-benchmark's state_dict (``backbone.fpn.fpn_inner1.weight``). The
RetinaNet top block (P6/P7 convs), GroupNorm and ReLU variants are later
slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def upsample_nearest_2x(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest 2x upsample [B, C, H, W] -> [B, C, 2H, 2W], cropped to
    ``out_hw`` (odd lateral sizes)."""
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return up[:, :, :out_hw[0], :out_hw[1]]


class FPN(nn.Module):
    def __init__(self, in_channels_list, out_channels: int = 256):
        super().__init__()
        self.num_levels = len(in_channels_list)
        for i, cin in enumerate(in_channels_list, start=1):
            self.add_module(f"fpn_inner{i}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_layer{i}",
                            nn.Conv2d(out_channels, out_channels, 3,
                                      padding=1))

    def forward(self, features: list[torch.Tensor]) -> list[torch.Tensor]:
        inner = [getattr(self, f"fpn_inner{i + 1}")(f)
                 for i, f in enumerate(features)]
        merged = [inner[-1]]
        for i in range(len(inner) - 2, -1, -1):
            td = upsample_nearest_2x(merged[0], inner[i].shape[2:])
            merged.insert(0, inner[i] + td)
        outs = [getattr(self, f"fpn_layer{i + 1}")(m)
                for i, m in enumerate(merged)]
        # LastLevelMaxPool: max pool of kernel 1, stride 2
        outs.append(F.max_pool2d(outs[-1], kernel_size=1, stride=2))
        return outs
