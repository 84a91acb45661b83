"""Mask R-CNN head (port of ``da_detect_tpu/models/mask_head.py``; reference
modeling/roi_heads/mask_head/).

* feature extractor: the box extractor's res5 output, shared (C4,
  ``SHARE_BOX_FEATURE_EXTRACTOR``), or its own pooler and stacked 3x3 convs
  (``MaskRCNNFPNFeatureExtractor``: 14x14 from the FPN levels, four convs of
  256, GroupNorm under ``USE_GN``), or FBNet's mask stage
  (``FBNet.roi_head_mask``, ``backbone/fbnet.py``: P 6 from the stride-16
  map, its -2 strides upsampling to ``RESOLUTION``). Its pooler is
  ``models/poolers.py``'s, so on the card it runs the ROIAlign forward and
  backward kernels.
* predictor: a 2x2 stride-2 transposed conv and per-class 1x1 logits
  (``MaskRCNNC4Predictor``), or the 1x1 logits alone
  (``MaskRCNNConv1x1Predictor``). Both, as the JAX package's, round their
  input to ``dtype`` and compute in float32: their Flax convs have no
  ``dtype`` and promote to their float32 kernels.
* training targets: the GT masks arrive rasterized in their own GT box's
  frame ([G, M, M], ``Targets.masks``) and are resampled into each sampled
  ROI's frame by a bilinear affine map (``project_gt_masks``): fixed shapes,
  no host round trip.
* loss: BCE over the GT-class channel of the positive source rows
  (reference mask_head/loss.py:110-144), divided by their pixel count over
  the global batch.

The extractors compute in ``dtype`` (``TPU.COMPUTE_DTYPE``); logits come
out as [B, R, K, Hm, Wm] float32, the loss in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d, make_norm
from ..ops import box_ops
from ..ops.losses import bce_with_logits
from ..parallel.ddp import global_mean
from .box_head import _take
from .poolers import pool_rois, pooler_config


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, R, C, H, W] -> a channels-last [B * R, C, H, W] batch."""
    return x.reshape((-1,) + x.shape[2:]).contiguous(
        memory_format=torch.channels_last)


class MaskRCNNC4Predictor(nn.Module):
    """``conv5_mask`` (2x2 transposed conv, stride 2) with ReLU, then the
    1x1 ``mask_fcn_logits``: [B, R, C, H, W] -> [B, R, K, 2H, 2W] float32.
    As the JAX package's (its Flax convs have no ``dtype`` and promote to
    their float32 kernels), the input is rounded to ``dtype`` and both
    layers compute in float32."""

    def __init__(self, in_channels: int, num_classes: int,
                 dim_reduced: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2,
                                          stride=2)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1)

    def forward(self, x):
        b, r = x.shape[:2]
        x = _rows(x).to(self.dtype).float()
        x = self.mask_fcn_logits(F.relu(self.conv5_mask(x)))
        return x.reshape((b, r) + x.shape[1:])


class MaskRCNNConv1x1Predictor(nn.Module):
    """The 1x1 per-class logits alone (reference roi_mask_predictors.py;
    the FBNet mask configs select it: their mask stage upsamples)."""

    def __init__(self, in_channels: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mask_fcn_logits = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x):
        # the 1x1 conv as a float32 product over the channels of the
        # channels-last rows (NHWC views), on the input rounded to ``dtype``
        b, r = x.shape[:2]
        conv = self.mask_fcn_logits
        y = F.linear(_rows(x).to(self.dtype).float().permute(0, 2, 3, 1),
                     conv.weight[:, :, 0, 0], conv.bias)
        return y.permute(0, 3, 1, 2).reshape((b, r, -1) + y.shape[1:3])


class MaskRCNNFPNFeatureExtractor(nn.Module):
    """P x P from each ROI's level, then ``mask_fcn{i}`` 3x3 convs (dilated
    by ``dilation``; GroupNorm ``mask_fcn{i}_gn`` and no bias under
    ``use_gn``) with ReLU (reference roi_mask_feature_extractors.py):
    [B, R, layers[-1], P, P]."""

    def __init__(self, pooler: dict, in_channels: int,
                 layers=(256, 256, 256, 256), dilation: int = 1,
                 use_gn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pooler = pooler
        self.num_layers = len(layers)
        self.use_gn = use_gn
        for i, ch in enumerate(layers):
            self.add_module(f"mask_fcn{i + 1}", Conv2d(
                in_channels if i == 0 else layers[i - 1], ch, 3,
                padding=dilation, dilation=dilation, bias=not use_gn,
                compute_dtype=dtype))
            if use_gn:
                self.add_module(f"mask_fcn{i + 1}_gn", make_norm("gn", ch))

    def forward(self, features, rois, *, impl: str):
        x = pool_rois(features, rois, **self.pooler, impl=impl)
        b, r = x.shape[:2]
        x = _rows(x)
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"mask_fcn{i}")(x)
            if self.use_gn:
                x = getattr(self, f"mask_fcn{i}_gn")(x)
            x = F.relu(x)
        return x.reshape((b, r) + x.shape[1:])


class MaskHead(nn.Module):
    """The extractor (absent: the box extractor's features are shared) and
    the predictor; state-dict names ``roi_heads.mask.feature_extractor.*``
    and ``roi_heads.mask.predictor.*``."""

    def __init__(self, predictor: nn.Module,
                 feature_extractor: Optional[nn.Module] = None):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.predictor = predictor

    def forward(self, features, rois, shared_box_features=None, *,
                impl: str):
        if self.feature_extractor is None:
            x = shared_box_features
        else:
            x = self.feature_extractor(features, rois, impl=impl)
        return self.predictor(x)


def _linspace(start: torch.Tensor, stop: torch.Tensor, n: int
              ) -> torch.Tensor:
    """[N] endpoints -> [N, n], ``jnp.linspace``'s arithmetic:
    start * (1 - t) + stop * t at t = i / (n - 1), the last value stop."""
    t = torch.arange(n - 1, dtype=torch.float32, device=start.device) \
        / (n - 1)
    out = start[:, None] * (1 - t) + stop[:, None] * t
    return torch.cat([out, stop[:, None]], dim=1)


def project_gt_masks(gt_masks: torch.Tensor, gt_boxes: torch.Tensor,
                     proposal_boxes: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """GT masks in their GT boxes' frames, resampled into the proposals'
    frames: gt_masks [N, M, M], gt_boxes [N, 4] and proposal_boxes [N, 4]
    (the matched GT of each proposal already gathered) -> [N, out, out].
    Samples at ``out`` points from corner to corner of each proposal (box
    corners inclusive), bilinear with out-of-box samples 0, as
    ``wy @ mask @ wx.T``."""
    m = gt_masks.shape[-1]
    gb, pb = gt_boxes.float(), proposal_boxes.float()
    gw = (gb[:, 2] - gb[:, 0]).clamp(min=1e-3)
    gh = (gb[:, 3] - gb[:, 1]).clamp(min=1e-3)
    ys = (_linspace(pb[:, 1], pb[:, 3], out_size) - gb[:, 1, None]) \
        / gh[:, None] * (m - 1)
    xs = (_linspace(pb[:, 0], pb[:, 2], out_size) - gb[:, 0, None]) \
        / gw[:, None] * (m - 1)
    pos = torch.arange(m, dtype=torch.float32, device=gt_masks.device)

    def axis_w(coords):
        w = (1.0 - (coords[..., None] - pos).abs()).clamp(min=0.0)
        inb = (coords >= 0) & (coords <= m - 1)
        return w * inb[..., None]

    wy, wx = axis_w(ys), axis_w(xs)                           # [N, out, M]
    return wy @ gt_masks.float() @ wx.transpose(1, 2)


def mask_rcnn_loss(mask_head: MaskHead, det_feats, sampled, targets,
                   shared_box_features=None, *, impl: str) -> torch.Tensor:
    """BCE over the GT-class mask channel of the positive source rows,
    summed and divided by their pixel count over the global batch
    (``parallel.global_mean``, floor 1). Each sampled ROI is matched again
    to its GT by IoU over the valid GT (first index on a tie), not by the
    matcher's indices, as the JAX package does. Without GT masks (the DA
    loaders carry none) it is 0 and the head does not run."""
    if targets.masks is None:
        return torch.zeros((), device=targets.boxes.device)
    logits = mask_head(det_feats, sampled.rois, shared_box_features,
                       impl=impl)                          # [B, S, K, H, W]
    b, s, _, out_size = logits.shape[:4]
    iou = box_ops.box_iou(sampled.rois, targets.boxes)     # [B, S, G]
    iou = torch.where(targets.valid[:, None, :], iou, -1.0)
    midx = iou.argmax(dim=2)
    proj = project_gt_masks(
        _take(targets.masks, midx).reshape((b * s,) + targets.masks.shape[2:]),
        _take(targets.boxes, midx).reshape(b * s, 4),
        sampled.rois.reshape(b * s, 4), out_size).reshape(b, s, out_size, -1)
    # the GT-class channel before the float32 cast
    cls = sampled.labels.clamp(min=0)[:, :, None, None, None].expand(
        b, s, 1, *logits.shape[3:])
    cls_logits = torch.gather(logits, 2, cls)[:, :, 0].float()
    pos = (sampled.labels > 0) & sampled.valid & sampled.domain_mask
    w = pos[:, :, None, None].expand_as(cls_logits).float()
    return global_mean(
        bce_with_logits(cls_logits, (proj > 0.5).float(), weights=w,
                        reduction="sum"), w.sum(), 1.0)


def make_mask_head(cfg, in_channels: int, box_channels: int,
                   dtype: torch.dtype = torch.float32) -> MaskHead:
    """The mask head of ``cfg``: ``in_channels`` are the backbone's (the
    FPN levels' width), ``box_channels`` the box extractor's output (the
    predictor's input when the extractor is shared)."""
    h = cfg.MODEL.ROI_MASK_HEAD
    nc = cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
    if h.SHARE_BOX_FEATURE_EXTRACTOR:
        extractor, ext_ch = None, box_channels
    elif h.FEATURE_EXTRACTOR == "FBNet.roi_head_mask":
        from .backbone.fbnet import make_fbnet_mask_extractor
        extractor, ext_ch = make_fbnet_mask_extractor(cfg, in_channels,
                                                      dtype)
    elif h.FEATURE_EXTRACTOR in ("MaskRCNNFPNFeatureExtractor",
                                 "ResNet50Conv5ROIFeatureExtractor"):
        # an unshared C4 name builds the conv stack on its own pooler, as
        # the JAX package does
        extractor = MaskRCNNFPNFeatureExtractor(
            pooler_config(cfg, "ROI_MASK_HEAD"), in_channels,
            layers=tuple(h.CONV_LAYERS), dilation=h.DILATION,
            use_gn=h.USE_GN, dtype=dtype)
        ext_ch = h.CONV_LAYERS[-1] if h.CONV_LAYERS else in_channels
    else:
        raise KeyError(f"unknown mask extractor: {h.FEATURE_EXTRACTOR}")
    if h.PREDICTOR == "MaskRCNNC4Predictor":
        predictor = MaskRCNNC4Predictor(
            ext_ch, nc, h.CONV_LAYERS[-1] if h.CONV_LAYERS else 256,
            dtype=dtype)
    elif h.PREDICTOR == "MaskRCNNConv1x1Predictor":
        predictor = MaskRCNNConv1x1Predictor(ext_ch, nc, dtype=dtype)
    else:
        raise KeyError(f"unknown mask predictor: {h.PREDICTOR}")
    return MaskHead(predictor, extractor)


def mask_layers(head: MaskHead) -> list[nn.Module]:
    """The head's own convolutions (``mask_fcn*``, ``conv5_mask``,
    ``mask_fcn_logits``; not an FBNet extractor's blocks): the ones
    ``init_parameters`` draws kaiming fan-out normal."""
    return [m for n, m in head.named_modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
            and n.rpartition(".")[2].startswith(("mask_fcn", "conv5_mask"))]
