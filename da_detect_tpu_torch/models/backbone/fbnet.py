"""FBNet mobile bodies and heads (port of
``da_detect_tpu/models/backbone/fbnet.py``).

Each architecture is a table of stages, each a run of groups (expansion,
channels, blocks, stride, kernel) of inverted-residual blocks (``MBConv``),
split between the trunk (the backbone, one stride-16 map), the RPN head, the
box head and the mask head. Channels follow ``FBNET.SCALE_FACTOR`` and
``FBNET.WIDTH_DIVISOR`` (``_divisible``). The heads register as
"FBNet.rpn_head", "FBNet.roi_head" and "FBNet.roi_head_mask".

As in the JAX package:

* every BatchNorm is Flax's with fixed statistics (``layers.BatchNorm``):
  its output is float32 whatever the compute dtype, so in a bfloat16 model
  the activations between blocks are float32, each conv casts its input to
  bfloat16, and the poolers pool float32 maps;
* a stride-2 conv pads as Flax's ``padding="SAME"`` does, asymmetrically
  (``same_pad``: on an even side 0 before and ``k - 2`` after at k 3, 1/2 at
  5, 2/3 at 7), not ``k // 2`` on both sides; the trunk and its blocks call
  it as a ``layers.RowOps`` method, which a space mesh replaces;
* a negative stride upsamples by nearest neighbour after the pointwise
  expansion (``jax.image.resize(..., "nearest")`` at an integer factor is
  ``F.interpolate(mode="nearest")``), then the depthwise conv runs at
  stride 1;
* the pointwise expansion is built even at expansion 1, and the residual
  add applies at stride 1 with equal widths only;
* ``FBNET.DET_HEAD_LAST_SCALE`` and the other ``FBNET.*_HEAD_*`` keys are
  read by neither package.

Module names follow the JAX package's (``backbone.first``,
``backbone.stages.3.pw``, ``rpn.head.head.0.dw``), so ``utils/weights.py``
maps its variables one to one; activations are logical NCHW in
``torch.channels_last`` memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import BatchNorm, Conv2d, RowOps
from ...layers.rows import same_pad  # noqa: F401 (the plain function)

# per arch: first conv (channels, stride), stages as groups of
# (expansion, channels, num_blocks, stride, kernel), and which stage indices
# form the trunk / rpn head / bbox head / mask head
_ARCHS = {
    "default": dict(
        first=(32, 2),
        stages=(
            ((1, 16, 1, 1, 3),),
            ((6, 24, 2, 2, 3),),
            ((6, 32, 3, 2, 3),),
            ((6, 64, 4, 2, 3), (6, 96, 3, 1, 3)),
            ((4, 160, 1, 2, 3), (6, 160, 2, 1, 3), (6, 240, 1, 1, 3)),
            ((6, 96, 3, 1, 3),),
            ((4, 160, 1, 1, 3), (6, 160, 3, 1, 3), (3, 80, 1, -2, 3)),
        ),
        backbone=(0, 1, 2, 3), bbox=4, rpn=5, mask=6),
    "xirb16d_dsmask": dict(
        first=(16, 2),
        stages=(
            ((1, 16, 1, 1, 3),),
            ((6, 32, 2, 2, 3),),
            ((6, 48, 3, 2, 3),),
            ((6, 96, 4, 2, 3), (6, 128, 3, 1, 3)),
            ((4, 128, 1, 2, 3), (6, 128, 2, 1, 3), (6, 160, 1, 1, 3)),
            ((6, 128, 3, 1, 3),),
            ((4, 128, 1, 2, 3), (6, 128, 2, 1, 3), (6, 128, 1, -2, 3),
             (3, 64, 1, -2, 3)),
        ),
        backbone=(0, 1, 2, 3), bbox=4, rpn=5, mask=6),
    "mobilenet_v2": dict(
        first=(32, 2),
        stages=(
            ((1, 16, 1, 1, 3),),
            ((6, 24, 2, 2, 3),),
            ((6, 32, 3, 2, 3),),
            ((6, 64, 4, 2, 3), (6, 96, 3, 1, 3)),
            ((6, 160, 3, 1, 3), (6, 320, 1, 1, 3)),
        ),
        backbone=(0, 1, 2, 3), bbox=4, rpn=None, mask=None),
    "cham_v1a": dict(
        first=(32, 2),
        stages=(
            ((1, 24, 1, 1, 3),),
            ((4, 48, 2, 2, 7),),
            ((7, 64, 5, 2, 3),),
            ((12, 56, 7, 2, 5), (8, 88, 5, 1, 3)),
            ((7, 152, 4, 2, 3), (10, 104, 1, 1, 3)),
            ((8, 88, 3, 1, 3),),
        ),
        backbone=(0, 1, 2, 3), bbox=4, rpn=5, mask=None),
    "cham_v2": dict(
        first=(32, 2),
        stages=(
            ((1, 24, 1, 1, 3),),
            ((8, 32, 4, 2, 5),),
            ((5, 48, 6, 2, 7),),
            ((9, 56, 3, 2, 5), (6, 56, 6, 1, 3)),
            ((2, 160, 6, 2, 3), (6, 112, 1, 1, 3)),
            ((6, 56, 1, 1, 3),),
        ),
        backbone=(0, 1, 2, 3), bbox=4, rpn=5, mask=None),
}
_ARCHS["mnv2"] = _ARCHS["mobilenet_v2"]
_ARCHS["chamv1a"] = _ARCHS["cham_v1a"]
_ARCHS["chamv2"] = _ARCHS["cham_v2"]


def _divisible(c: float, divisor: int) -> int:
    """fbnet_builder._get_divisible_by."""
    d = max(1, divisor)
    return max(d, int(c + d / 2) // d * d)


class MBConv(RowOps, nn.Module):
    """Inverted residual block (fbnet_builder.IRFBlock): ``pw`` 1x1
    expansion + ``pw_bn`` + ReLU, nearest upsampling at a negative stride,
    ``dw`` depthwise k x k (``dw_bn`` unless ``dw_skip_bn``, ReLU unless
    ``dw_skip_relu``), ``pwl`` 1x1 + ``pwl_bn``, and the residual add at
    stride 1 with equal widths."""

    def __init__(self, in_channels: int, features: int, expansion: int = 6,
                 stride: int = 1, kernel: int = 3, dw_skip_bn: bool = True,
                 dw_skip_relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_channels * expansion
        self.stride, self.kernel = stride, kernel
        self.dw_skip_relu = dw_skip_relu
        self.residual = stride == 1 and in_channels == features
        self.pw = Conv2d(in_channels, mid, 1, bias=False, compute_dtype=dtype)
        self.pw_bn = BatchNorm(mid)
        # stride 1 pads k // 2 on both sides, as SAME does for an odd k
        self.dw = Conv2d(mid, mid, kernel, stride=max(stride, 1),
                         padding=kernel // 2 if stride <= 1 else 0,
                         groups=mid, bias=False, compute_dtype=dtype)
        self.dw_bn = None if dw_skip_bn else BatchNorm(mid)
        self.pwl = Conv2d(mid, features, 1, bias=False, compute_dtype=dtype)
        self.pwl_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.pw_bn(self.pw(x)))
        if self.stride < 0:
            h = F.interpolate(h, scale_factor=-self.stride, mode="nearest")
        elif self.stride > 1:
            h = self.same_pad(h, self.kernel, self.stride)
        h = self.dw(h)
        if self.dw_bn is not None:
            h = self.dw_bn(h)
        if not self.dw_skip_relu:
            h = F.relu(h)
        h = self.pwl_bn(self.pwl(h))
        return h + x if self.residual else h


def _arch(cfg) -> dict:
    name = cfg.MODEL.FBNET.ARCH
    if name not in _ARCHS:
        raise KeyError(f"unknown FBNET.ARCH: {name}")
    return _ARCHS[name]


def _stage_groups(arch: dict, ids) -> tuple:
    out = []
    for i in (ids if isinstance(ids, (tuple, list)) else (ids,)):
        out.extend(arch["stages"][i])
    return tuple(out)


def _head_out_channels(arch: dict, which: str, scale: float,
                       divisor: int) -> int:
    return _divisible(_stage_groups(arch, arch[which])[-1][1] * scale,
                      divisor)


class _Opts:
    """The FBNET keys every block reads."""

    def __init__(self, cfg, dtype: torch.dtype):
        f = cfg.MODEL.FBNET
        self.arch = _arch(cfg)
        self.scale, self.divisor = f.SCALE_FACTOR, f.WIDTH_DIVISOR
        self.dw_skip_bn, self.dw_skip_relu = (f.DW_CONV_SKIP_BN,
                                              f.DW_CONV_SKIP_RELU)
        self.dtype = dtype

    def stages(self, which, in_channels: int) -> nn.Sequential:
        """The blocks of the arch's ``which`` stages (a key of the arch, or
        stage indices) on ``in_channels``, as one ``nn.Sequential``."""
        ids = self.arch[which] if isinstance(which, str) else which
        blocks = []
        for t, c, n, s, k in _stage_groups(self.arch, ids):
            ch = _divisible(c * self.scale, self.divisor)
            for j in range(n):
                blocks.append(MBConv(in_channels, ch, t, s if j == 0 else 1,
                                     k, self.dw_skip_bn, self.dw_skip_relu,
                                     self.dtype))
                in_channels = ch
        return nn.Sequential(*blocks)

    def out_channels(self, which: str) -> int:
        return _head_out_channels(self.arch, which, self.scale, self.divisor)


class FBNetTrunk(RowOps, nn.Module):
    """``first`` 3x3 conv (SAME at its stride) + ``first_bn`` + ReLU, then
    the trunk's blocks (``stages``): one stride-16 map, float32."""

    def __init__(self, opts: _Opts):
        super().__init__()
        first_ch, self.first_stride = opts.arch["first"]
        ch = _divisible(first_ch * opts.scale, opts.divisor)
        self.dtype = opts.dtype
        self.first = Conv2d(3, ch, 3, stride=self.first_stride,
                            padding=1 if self.first_stride == 1 else 0,
                            bias=False, compute_dtype=opts.dtype)
        self.first_bn = BatchNorm(ch)
        self.stages = opts.stages(opts.arch["backbone"], ch)

    def forward(self, x: torch.Tensor, impl: str = "cuda"):
        x = x.to(self.dtype)
        if self.first_stride > 1:
            x = self.same_pad(x, 3, self.first_stride)
        x = F.relu(self.first_bn(self.first(x)))
        return [self.stages(x).contiguous(memory_format=torch.channels_last)]


class FBNetRPNHead(nn.Module):
    """The RPN stage's blocks (``head``), then twin 1x1 convs
    (``cls_logits``, ``bbox_pred``), on each level; the same outputs as
    ``models.rpn.RPNHead``: per level (logits [B, A, H, W], deltas
    [B, A*4, H, W]) in the compute dtype."""

    def __init__(self, opts: _Opts, in_channels: int, num_anchors: int):
        super().__init__()
        if opts.arch["rpn"] is None:
            raise KeyError("this FBNET.ARCH has no rpn stage")
        self.dtype = opts.dtype
        self.head = opts.stages("rpn", in_channels)
        ch = opts.out_channels("rpn")
        self.cls_logits = Conv2d(ch, num_anchors, 1, compute_dtype=opts.dtype)
        self.bbox_pred = Conv2d(ch, num_anchors * 4, 1,
                                compute_dtype=opts.dtype)

    def forward(self, features):
        logits, deltas = [], []
        for f in features:
            t = self.head(f.to(self.dtype))
            logits.append(self.cls_logits(t))
            deltas.append(self.bbox_pred(t))
        return logits, deltas


class FBNetRoIHead(nn.Module):
    """``pooler`` (``models/poolers.py``: the ROIAlign kernels on the card),
    then the ``which`` stage's blocks (``head``) over the pooled ROIs as one
    batch, the pooled map cast to the compute dtype first: [B, R, C, p, p].
    The box head ("bbox", "FBNet.roi_head") feeds ``FastRCNNPredictor``
    (average pool + linear); the mask head ("mask",
    "FBNet.roi_head_mask"), whose -2 strides upsample back to
    ``RESOLUTION``, the 1x1 mask predictor."""

    def __init__(self, opts: _Opts, which: str, pooler: dict,
                 in_channels: int):
        super().__init__()
        if opts.arch.get(which) is None:
            raise KeyError(f"this FBNET.ARCH has no {which} stage")
        self.pooler = pooler
        self.dtype = opts.dtype
        self.head = opts.stages(which, in_channels)

    def forward(self, features, rois, *, impl: str):
        from ..poolers import pool_rois

        x = pool_rois(features, rois, **self.pooler, impl=impl)
        b, r = x.shape[:2]
        x = x.reshape((b * r,) + x.shape[2:]).contiguous(
            memory_format=torch.channels_last).to(self.dtype)
        x = self.head(x)
        return x.reshape((b, r) + x.shape[1:])


def make_fbnet_roi_head(cfg, in_channels: int, dtype: torch.dtype):
    """(the "FBNet.roi_head" box extractor, its output channels)."""
    from ..poolers import pooler_config

    opts = _Opts(cfg, dtype)
    return (FBNetRoIHead(opts, "bbox", pooler_config(cfg, "ROI_BOX_HEAD"),
                         in_channels), opts.out_channels("bbox"))


def make_fbnet_mask_extractor(cfg, in_channels: int, dtype: torch.dtype):
    """(the "FBNet.roi_head_mask" mask extractor, its output channels)."""
    from ..poolers import pooler_config

    opts = _Opts(cfg, dtype)
    return (FBNetRoIHead(opts, "mask", pooler_config(cfg, "ROI_MASK_HEAD"),
                         in_channels), opts.out_channels("mask"))


def make_fbnet_rpn_head(cfg, in_channels: int, num_anchors: int,
                        dtype: torch.dtype) -> FBNetRPNHead:
    return FBNetRPNHead(_Opts(cfg, dtype), in_channels, num_anchors)


def build_fbnet_backbone(cfg, dtype: torch.dtype):
    """(the trunk, its output channels): one map at stride 16."""
    opts = _Opts(cfg, dtype)
    return FBNetTrunk(opts), opts.out_channels("backbone")
