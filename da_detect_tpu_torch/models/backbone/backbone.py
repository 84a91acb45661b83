"""Backbone factory (port of ``da_detect_tpu/models/backbone/backbone.py``).

This slice builds the ResNet C4 bodies (``R-50-C4``, ``R-101-C4``,
``R-152-C4``) with FrozenBatchNorm. FPN, FBNet, VGG, GroupNorm and
deformable-conv bodies are later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from .resnet import ResNet


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    out_channels: int
    strides: tuple[int, ...]  # feature stride per output level


class ResNetBackbone(nn.Module):
    """ResNet body (``backbone.body`` in the state_dict)."""

    def __init__(self, body: ResNet):
        super().__init__()
        self.body = body

    def forward(self, x):
        return self.body(x)


_C4_DEPTHS = {"R-50-C4": 50, "R-101-C4": 101, "R-152-C4": 152}


def build_backbone(cfg) -> tuple[nn.Module, BackboneSpec]:
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if body not in _C4_DEPTHS:
        raise NotImplementedError(
            f"CONV_BODY {body}: the PyTorch port builds the C4 ResNet bodies "
            f"only ({', '.join(_C4_DEPTHS)}); the others are later slices")
    r = cfg.MODEL.RESNETS
    if cfg.MODEL.BACKBONE.USE_GN:
        raise NotImplementedError("GroupNorm bodies are a later slice")
    if any(r.STAGE_WITH_DCN):
        raise NotImplementedError("deformable-conv bodies are a later slice")
    stages = 3
    module = ResNetBackbone(ResNet(
        depth=_C4_DEPTHS[body], stages=stages, num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stride_in_1x1=r.STRIDE_IN_1X1, res5_dilation=r.RES5_DILATION,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT))
    out_ch = r.RES2_OUT_CHANNELS * 2 ** (stages - 1)
    return module, BackboneSpec(out_channels=out_ch,
                                strides=(4 * 2 ** (stages - 1),))
