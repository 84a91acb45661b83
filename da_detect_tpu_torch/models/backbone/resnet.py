"""ResNe[X]t body and res5 head (port of
``da_detect_tpu/models/backbone/resnet.py``).

Stem + stages of bottleneck blocks with the Caffe2 ``stride_in_1x1``
convention; ``norm`` is "frozen_bn" (FrozenBatchNorm) or "gn" (GroupNorm,
``BACKBONE.USE_GN`` / ``ROI_BOX_HEAD.USE_GN``) in the stem, every block and
the downsample. ``dtype`` is the compute dtype (``TPU.COMPUTE_DTYPE``):
every conv casts its input and float32 weights to it, the FrozenBN affine
follows its input, and the residual adds stay in it; a deformable ``conv2``
returns float32, as in the JAX package, so its ``bn2`` runs in float32 and
``conv3`` casts back. GroupNorm returns float32 whatever its input (Flax's
promotion), so in a bfloat16 GN model every norm output, residual sum and
stage output is float32, and each conv casts its input back to bfloat16.
Module names follow maskrcnn-benchmark's state_dict (``stem.conv1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``), so ``utils/weights.py``
maps the JAX package's variables onto them one to one. Activations are logical NCHW
in ``torch.channels_last`` memory.

ResNeXt's grouped ``conv2`` is ``nn.Conv2d(groups=...)``: the JAX package's
block-diagonal dense lowering (``BlockDiagGroupedConv``) computes the same
function with the same parameter layout. Stages in ``stage_with_dcn`` put a
``DeformConv2d`` in ``conv2``; ``impl`` reaches it through ``forward``.
"""

from __future__ import annotations

import torch.nn.functional as F
import torch
from torch import nn

from ...layers import Conv2d, DeformConv2d, RowOps, make_norm


def _conv(cin, cout, k, stride=1, padding=0, dilation=1, groups=1,
          dtype=torch.float32):
    return Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=False,
                  compute_dtype=dtype)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, dilation: int = 1,
                 num_groups: int = 1, stride_in_1x1: bool = True,
                 with_dcn: bool = False, with_modulated_dcn: bool = False,
                 deformable_groups: int = 1, dcn_gather: str = "four",
                 norm: str = "frozen_bn", dtype: torch.dtype = torch.float32):
        super().__init__()
        stride_1x1, stride_3x3 = ((stride, 1) if stride_in_1x1
                                  else (1, stride))
        self.downsample = None
        if in_channels != out_channels or stride != 1:
            self.downsample = nn.Sequential(
                _conv(in_channels, out_channels, 1, stride=stride,
                      dtype=dtype),
                make_norm(norm, out_channels))
        self.conv1 = _conv(in_channels, bottleneck_channels, 1,
                           stride=stride_1x1, dtype=dtype)
        self.bn1 = make_norm(norm, bottleneck_channels)
        if with_dcn:
            self.conv2 = DeformConv2d(
                bottleneck_channels, bottleneck_channels, 3,
                stride=stride_3x3, dilation=dilation, groups=num_groups,
                deformable_groups=deformable_groups,
                modulated=with_modulated_dcn, gather_mode=dcn_gather,
                dtype=dtype)
        else:
            self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3,
                               stride=stride_3x3, padding=dilation,
                               dilation=dilation, groups=num_groups,
                               dtype=dtype)
        self.bn2 = make_norm(norm, bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1, dtype=dtype)
        self.bn3 = make_norm(norm, out_channels)

    def forward(self, x, impl: str = "cuda"):
        shortcut = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        if isinstance(self.conv2, DeformConv2d):
            out = self.conv2(out, impl=impl)
        else:
            out = self.conv2(out)
        out = F.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        return F.relu(out + shortcut)


class Stem(RowOps, nn.Module):
    def __init__(self, out_channels: int = 64, norm: str = "frozen_bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(3, out_channels, 7, stride=2, padding=3,
                           dtype=dtype)
        self.bn1 = make_norm(norm, out_channels)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return self.max_pool(x, 3, 2, 1)


class ResStage(nn.Sequential):
    """A sequence of bottleneck blocks (reference resnet.py _make_stage)."""

    def __init__(self, block_count: int, in_channels: int,
                 bottleneck_channels: int, out_channels: int,
                 first_stride: int, dilation: int = 1, num_groups: int = 1,
                 stride_in_1x1: bool = True, **dcn):
        blocks = []
        for i in range(block_count):
            blocks.append(Bottleneck(
                in_channels if i == 0 else out_channels, bottleneck_channels,
                out_channels, stride=first_stride if i == 0 else 1,
                dilation=dilation, num_groups=num_groups,
                stride_in_1x1=stride_in_1x1, **dcn))
        super().__init__(*blocks)

    def forward(self, x, impl: str = "cuda"):
        for block in self:
            x = block(x, impl=impl)
        return x


# blocks per stage for R-50, R-101, R-152
_BLOCK_COUNTS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class ResNet(nn.Module):
    """cfg-driven ResNet body returning the last stage's map (C4: 3 stages),
    or with ``return_all`` every stage's map (FPN).

    Stages before ``freeze_at`` (the stem is stage 1) take no gradient, as
    maskrcnn-benchmark's ``_freeze_backbone`` does. ``stage_with_dcn`` has
    one flag a stage (res2..res5)."""

    def __init__(self, depth: int = 50, stages: int = 4, num_groups: int = 1,
                 width_per_group: int = 64, stem_out_channels: int = 64,
                 res2_out_channels: int = 256, stride_in_1x1: bool = True,
                 res5_dilation: int = 1, freeze_at: int = 0,
                 return_all: bool = False,
                 stage_with_dcn=(False, False, False, False),
                 with_modulated_dcn: bool = False, deformable_groups: int = 1,
                 dcn_gather: str = "four", norm: str = "frozen_bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_all = return_all
        self.dtype = dtype
        self.stem = Stem(stem_out_channels, norm=norm, dtype=dtype)
        counts = _BLOCK_COUNTS[depth]
        in_ch = stem_out_channels
        self.stage_names = []
        for idx in range(stages):
            stage2_relative = 2 ** idx
            out_ch = res2_out_channels * stage2_relative
            first_stride = (1 if idx == 0 or (idx == 3 and res5_dilation == 2)
                            else 2)
            name = f"layer{idx + 1}"
            self.add_module(name, ResStage(
                counts[idx], in_ch,
                num_groups * width_per_group * stage2_relative, out_ch,
                first_stride, dilation=res5_dilation if idx == 3 else 1,
                num_groups=num_groups, stride_in_1x1=stride_in_1x1,
                with_dcn=bool(stage_with_dcn[idx]),
                with_modulated_dcn=with_modulated_dcn,
                deformable_groups=deformable_groups, dcn_gather=dcn_gather,
                norm=norm, dtype=dtype))
            self.stage_names.append(name)
            in_ch = out_ch
        for i in range(freeze_at):
            (self.stem if i == 0 else getattr(self, f"layer{i}")
             ).requires_grad_(False)

    def forward(self, x, impl: str = "cuda"):
        x = self.stem(x.to(self.dtype))  # the input cast at the stem
        outputs = []
        for name in self.stage_names:
            x = getattr(self, name)(x, impl=impl)
            outputs.append(x)
        return outputs if self.return_all else outputs[-1:]


class ResNetHead(nn.Module):
    """The res5 stage used as the C4 box-head feature extractor: pooled ROI
    features [N, 1024, 14, 14] -> [N, 2048, 7, 7]. The input is cast to
    ``dtype`` once, as the JAX package's ``ResNetHead`` does (a float32 GN
    map pooled by the float32 ROIAlign)."""

    def __init__(self, depth: int = 50, num_groups: int = 1,
                 width_per_group: int = 64, res2_out_channels: int = 256,
                 stride_in_1x1: bool = True, first_stride: int = 2,
                 dilation: int = 1, norm: str = "frozen_bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        stage2_relative = 8  # res5
        self.layer4 = ResStage(
            _BLOCK_COUNTS[depth][3], res2_out_channels * 4,
            num_groups * width_per_group * stage2_relative,
            res2_out_channels * stage2_relative, first_stride,
            dilation=dilation, num_groups=num_groups,
            stride_in_1x1=stride_in_1x1, norm=norm, dtype=dtype)

    def forward(self, x):
        return self.layer4(x.to(self.dtype))
