"""Backbone factory (port of ``da_detect_tpu/models/backbone/backbone.py``).

``build_backbone(cfg)`` returns (module, BackboneSpec). ``BACKBONES`` holds
the ResNe[X]t bodies under the JAX package's CONV_BODY names, in its order:
the C4 bodies (``R-50-C4``, ``R-101-C4``, ``R-152-C4``: 3 stages, one
stride-16 map), the C5 bodies (``R-50-C5``, ``R-101-C5``, ``R-152-C5``: 4
stages, no FPN, one stride-32 map), the FPN bodies (``R-50-FPN``,
``R-101-FPN``, ``R-152-FPN``, ``X-101-32x8d-FPN``, the last with its groups
and width from ``MODEL.RESNETS``) and the RetinaNet bodies
(``R-{50,101,152}-FPN-RETINANET``: the FPN over C3-C5 with the P6/P7 top
block, strides 8 to 128); each with deformable ``conv2`` in the stages of
``STAGE_WITH_DCN``, with FrozenBatchNorm or, under ``BACKBONE.USE_GN``,
GroupNorm; the FPN with ``FPN.USE_GN`` and ``FPN.USE_RELU``. A CONV_BODY
starting with "FBNet" builds the FBNet trunk (``FBNET.ARCH``; ``fbnet.py``:
one map at stride 16), one starting with "V" the VGG-16 body (``vgg.py``:
one stride-16 map of 512 channels). Any other name raises ``KeyError``, as
in the JAX package. Bodies and FPN compute in ``TPU.COMPUTE_DTYPE``
(GroupNorm and FBNet's BatchNorm output float32, ``layers/norms.py``).
"""

from __future__ import annotations

import dataclasses

from torch import nn

from ...layers import compute_dtype
from ...utils.registry import Registry
from .fpn import FPN
from .resnet import ResNet

# CONV_BODY -> (depth, stages, with FPN, FPN top block)
BACKBONES = Registry()


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    out_channels: int
    strides: tuple[int, ...]  # feature stride per output level


class ResNetBackbone(nn.Module):
    """ResNet body (``backbone.body`` in the state_dict), optionally topped
    with an FPN (``backbone.fpn``) over the body's outputs from
    ``first_level`` on (1 for RetinaNet's C3-C5). ``impl`` picks the
    deformable convolutions' gathers (``layers/deform_conv.py``)."""

    def __init__(self, body: ResNet, fpn: FPN | None = None,
                 first_level: int = 0):
        super().__init__()
        self.body = body
        self.fpn = fpn
        self.first_level = first_level

    def forward(self, x, impl: str = "cuda"):
        feats = self.body(x, impl=impl)
        if self.fpn is None:
            return feats
        return self.fpn(feats[self.first_level:])


def _register_resnets():
    for depth in (50, 101, 152):
        BACKBONES.register(f"R-{depth}-C4", (depth, 3, False, "maxpool"))
        BACKBONES.register(f"R-{depth}-C5", (depth, 4, False, "maxpool"))
        BACKBONES.register(f"R-{depth}-FPN", (depth, 4, True, "maxpool"))
        BACKBONES.register(f"R-{depth}-FPN-RETINANET",
                           (depth, 4, True, "p6p7"))
    # ResNeXt bodies use the same specs; groups/width come from cfg
    BACKBONES.register("X-101-32x8d-FPN", (101, 4, True, "maxpool"))


_register_resnets()


def build_backbone(cfg) -> tuple[nn.Module, BackboneSpec]:
    body = cfg.MODEL.BACKBONE.CONV_BODY
    dtype = compute_dtype(cfg)
    if body.startswith("FBNet"):
        from .fbnet import build_fbnet_backbone

        trunk, out_ch = build_fbnet_backbone(cfg, dtype)
        return trunk, BackboneSpec(out_channels=out_ch, strides=(16,))
    if body.startswith("V"):  # VGG-16 (the original DA-Faster backbone)
        from .vgg import build_vgg_backbone

        vgg, out_ch = build_vgg_backbone(dtype)
        return vgg, BackboneSpec(out_channels=out_ch, strides=(16,))
    if body not in BACKBONES:
        raise KeyError(f"unknown CONV_BODY: {body}")
    depth, stages, with_fpn, top_block = BACKBONES[body]
    r = cfg.MODEL.RESNETS
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
        dcn_gather=cfg.TPU.DCN_GATHER,
        norm="gn" if cfg.MODEL.BACKBONE.USE_GN else "frozen_bn", dtype=dtype)
    if not with_fpn:
        return ResNetBackbone(resnet), BackboneSpec(
            out_channels=r.RES2_OUT_CHANNELS * 2 ** (stages - 1),
            strides=(4 * 2 ** (stages - 1),))
    out_ch = cfg.MODEL.BACKBONE.OUT_CHANNELS
    first = 1 if top_block == "p6p7" else 0
    fpn = FPN([r.RES2_OUT_CHANNELS * 2 ** i for i in range(first, stages)],
              out_ch, norm="gn" if cfg.MODEL.FPN.USE_GN else "none",
              use_relu=cfg.MODEL.FPN.USE_RELU, top_block=top_block,
              dtype=dtype)
    return ResNetBackbone(resnet, fpn, first), BackboneSpec(
        out_channels=out_ch,
        strides=(8, 16, 32, 64, 128) if first else (4, 8, 16, 32, 64))
