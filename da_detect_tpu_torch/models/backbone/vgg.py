"""VGG-16 backbone (port of ``da_detect_tpu/models/backbone/vgg.py``).

conv1_1..conv5_3 (3x3, padding 1, ReLU) with a 2x2 max pool after each of
the first four blocks and none after conv5_3: one stride-16 map of 512
channels, the body of the original DA-Faster R-CNN. Paired with
``FPN2MLPFeatureExtractor`` over that one level (``POOLER_SCALES
(0.0625,)``, ``POOLER_RESOLUTION 7``) it gives the classic fc6/fc7 head.
The convolutions compute in ``dtype`` (``TPU.COMPUTE_DTYPE``) through
``layers/cast.py``; the input is cast once, at the first conv. State-dict
names are ``backbone.conv{b}_{c}.weight`` / ``.bias``, the JAX package's
``backbone/conv{b}_{c}/kernel`` / ``bias``. No stage is frozen: the JAX
package's ``param_labels`` freezes the paths ``backbone/body/stem`` and
``backbone/body/layer{i}``, which a VGG body does not have.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, RowOps

# channels per conv block (VGG-16 "D" configuration)
_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(RowOps, nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.names = []
        in_ch = 3
        for bi, (ch, n) in enumerate(_BLOCKS):
            block = []
            for ci in range(n):
                name = f"conv{bi + 1}_{ci + 1}"
                self.add_module(name, Conv2d(in_ch, ch, 3, padding=1,
                                             compute_dtype=dtype))
                block.append(name)
                in_ch = ch
            self.names.append(block)

    def forward(self, x, impl: str = "cuda"):
        x = x.to(self.dtype)
        for bi, block in enumerate(self.names):
            for name in block:
                x = F.relu(getattr(self, name)(x))
            if bi < len(self.names) - 1:  # no pool after conv5_3: stride 16
                x = self.max_pool(x, 2, 2)
        return [x]


def build_vgg_backbone(dtype: torch.dtype) -> tuple[VGG16, int]:
    """(the body, its output channels)."""
    return VGG16(dtype), 512
