"""Backbone factory (port of ``da_detect_tpu/models/backbone/backbone.py``).

This port builds the ResNe[X]t bodies with FrozenBatchNorm: the C4 bodies
(``R-50-C4``, ``R-101-C4``, ``R-152-C4``) and the FPN bodies (``R-50-FPN``,
``R-101-FPN``, ``R-152-FPN``, ``X-101-32x8d-FPN``, the last with its groups
and width from ``MODEL.RESNETS``), each with deformable ``conv2`` in the
stages of ``STAGE_WITH_DCN``. RetinaNet FPN, FBNet, VGG and GroupNorm bodies
are later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from .fpn import FPN
from .resnet import ResNet


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    out_channels: int
    strides: tuple[int, ...]  # feature stride per output level


class ResNetBackbone(nn.Module):
    """ResNet body (``backbone.body`` in the state_dict), optionally topped
    with an FPN (``backbone.fpn``). ``impl`` picks the deformable
    convolutions' gathers (``layers/deform_conv.py``)."""

    def __init__(self, body: ResNet, fpn: FPN | None = None):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, x, impl: str = "cuda"):
        feats = self.body(x, impl=impl)
        return feats if self.fpn is None else self.fpn(feats)


# CONV_BODY -> (depth, with FPN)
_BODIES = {
    **{f"R-{d}-C4": (d, False) for d in (50, 101, 152)},
    **{f"R-{d}-FPN": (d, True) for d in (50, 101, 152)},
    "X-101-32x8d-FPN": (101, True),
}


def build_backbone(cfg) -> tuple[nn.Module, BackboneSpec]:
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if body not in _BODIES:
        raise NotImplementedError(
            f"CONV_BODY {body}: the PyTorch port builds "
            f"{', '.join(_BODIES)}; the others are later slices")
    if cfg.MODEL.BACKBONE.USE_GN:
        raise NotImplementedError("GroupNorm bodies are a later slice")
    depth, with_fpn = _BODIES[body]
    if with_fpn and (cfg.MODEL.FPN.USE_GN or cfg.MODEL.FPN.USE_RELU):
        raise NotImplementedError(
            "GroupNorm and ReLU FPN variants are a later slice")
    r = cfg.MODEL.RESNETS
    stages = 4 if with_fpn else 3
    resnet = ResNet(
        depth=depth, stages=stages, num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stride_in_1x1=r.STRIDE_IN_1X1, res5_dilation=r.RES5_DILATION,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
        return_all=with_fpn, stage_with_dcn=tuple(r.STAGE_WITH_DCN),
        with_modulated_dcn=r.WITH_MODULATED_DCN,
        deformable_groups=r.DEFORMABLE_GROUPS,
        dcn_gather=cfg.TPU.DCN_GATHER)
    if not with_fpn:
        return ResNetBackbone(resnet), BackboneSpec(
            out_channels=r.RES2_OUT_CHANNELS * 2 ** (stages - 1),
            strides=(4 * 2 ** (stages - 1),))
    out_ch = cfg.MODEL.BACKBONE.OUT_CHANNELS
    fpn = FPN([r.RES2_OUT_CHANNELS * 2 ** i for i in range(stages)], out_ch)
    return ResNetBackbone(resnet, fpn), BackboneSpec(
        out_channels=out_ch, strides=(4, 8, 16, 32, 64))
