"""Feature Pyramid Network (port of ``da_detect_tpu/models/backbone/fpn.py``,
the two-stage form).

Lateral 1x1 convs (``fpn_inner{i}``), nearest 2x top-down then cropped to
the lateral's size, 3x3 output convs (``fpn_layer{i}``), and
``LastLevelMaxPool`` (kernel 1, stride 2) for P6. Module names follow
maskrcnn-benchmark's state_dict (``backbone.fpn.fpn_inner1.weight``).
``norm="gn"`` (``FPN.USE_GN``) puts a GroupNorm after each conv
(``fpn_inner{i}_norm``, ``fpn_layer{i}_norm``) and drops the convs' biases;
``use_relu`` (``FPN.USE_RELU``) a ReLU after each conv and norm.
``top_block="p6p7"`` (the RetinaNet bodies, the FPN over C3-C5) replaces
the max pool with ``fpn_p6``, a 3x3 stride-2 conv (symmetric padding 1) on
C5, the last input, and ``fpn_p7``, the same conv on ``relu(P6)``. The JAX
package always takes P6 from C5 (its ``p6p7_in_from_c5`` is never unset),
so ``RETINANET.USE_C5`` (False in the ``_P5_`` YAMLs) is read by neither
package. Every conv computes in ``dtype``; the top-down sums stay in it, or
in float32 after GroupNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, RowOps, make_norm


class FPN(RowOps, nn.Module):
    def __init__(self, in_channels_list, out_channels: int = 256,
                 norm: str = "none", use_relu: bool = False,
                 top_block: str = "maxpool",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if top_block not in ("maxpool", "p6p7"):
            raise ValueError(f"unknown FPN top block: {top_block}")
        self.num_levels = len(in_channels_list)
        self.top_block = top_block
        self.normed = norm != "none"
        self.use_relu = use_relu
        for i, cin in enumerate(in_channels_list, start=1):
            self.add_module(f"fpn_inner{i}", Conv2d(
                cin, out_channels, 1, bias=not self.normed,
                compute_dtype=dtype))
            self.add_module(f"fpn_layer{i}", Conv2d(
                out_channels, out_channels, 3, padding=1,
                bias=not self.normed, compute_dtype=dtype))
            if self.normed:
                self.add_module(f"fpn_inner{i}_norm",
                                make_norm(norm, out_channels))
                self.add_module(f"fpn_layer{i}_norm",
                                make_norm(norm, out_channels))
        if top_block == "p6p7":
            self.fpn_p6 = Conv2d(in_channels_list[-1], out_channels, 3,
                                 stride=2, padding=1, compute_dtype=dtype)
            self.fpn_p7 = Conv2d(out_channels, out_channels, 3, stride=2,
                                 padding=1, compute_dtype=dtype)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        if self.normed:
            x = getattr(self, f"{name}_norm")(x)
        return F.relu(x) if self.use_relu else x

    def forward(self, features: list[torch.Tensor]) -> list[torch.Tensor]:
        inner = [self._conv(f"fpn_inner{i + 1}", f)
                 for i, f in enumerate(features)]
        merged = [inner[-1]]
        for i in range(len(inner) - 2, -1, -1):
            merged.insert(0, inner[i] + self.upsample_2x(merged[0],
                                                         inner[i]))
        outs = [self._conv(f"fpn_layer{i + 1}", m)
                for i, m in enumerate(merged)]
        if self.top_block == "p6p7":
            p6 = self.fpn_p6(features[-1])
            return outs + [p6, self.fpn_p7(F.relu(p6))]
        # LastLevelMaxPool: max pool of kernel 1, stride 2
        outs.append(self.max_pool(outs[-1], 1, 2))
        return outs
