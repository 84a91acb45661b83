"""Keypoint R-CNN head (port of ``da_detect_tpu/models/keypoint_head.py``;
reference modeling/roi_heads/keypoint_head/).

* feature extractor (``KeypointRCNNFeatureExtractor``): P x P from each
  ROI's level (``models/poolers.py``, so on the card the ROIAlign forward
  and backward kernels), then ``conv_fcn1..8``, 3x3 convs of 512 with ReLU,
  computed in ``dtype`` (``TPU.COMPUTE_DTYPE``).
* predictor (``KeypointRCNNPredictor``): ``kps_score_lowres``, a 4x4
  transposed conv of stride 2 (Flax's padding (1, 1): 14 -> 26, not the
  reference's 28), then a 2x bilinear upsample (-> 52): K heatmaps a ROI.
  The transposed conv is a channel product and a fold
  (``FoldedConvTranspose2d``), and the upsample's gradient is two products
  with its interpolation matrices (``upsample2x``), so the predictor's
  sums, forward and backward, have a fixed order on the card.
  As the JAX package's (its Flax conv has no ``dtype`` and promotes to its
  float32 kernel), the input is rounded to ``dtype`` and the layer computes
  in float32; the logits are float32. Their size comes from their shape,
  never from ``RESOLUTION``.
* loss (``keypoint_rcnn_loss``): softmax cross-entropy over each heatmap,
  at the GT keypoint's cell, for the visible keypoints inside their ROI of
  the positive source rows (reference keypoint_head/loss.py), divided by
  their count over the global batch. As the JAX package does, the head runs
  on every sampled ROI (the weights keep the positives) and each ROI takes
  the keypoints of its GT by IoU over the valid GT.
* decode (``heatmaps_to_keypoints``): each heatmap's argmax cell (the first
  on a tie), its centre mapped into the ROI, and its softmax probability as
  the score; no resize back to the ROI's own size.

Heatmaps are [..., K, H, W] (channels first); GT keypoints [..., K, 3] as
(x, y, visibility) in the resized image's frame.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d
from ..ops import box_ops
from ..parallel.ddp import global_mean
from .box_head import _take
from .mask_head import _rows
from .poolers import pool_rois, pooler_config


class KeypointRCNNFeatureExtractor(nn.Module):
    """P x P from each ROI's level, then ``conv_fcn{i}`` 3x3 convs with ReLU:
    [B, R, layers[-1], P, P]."""

    def __init__(self, pooler: dict, in_channels: int,
                 layers=(512,) * 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pooler = pooler
        self.num_layers = len(layers)
        for i, ch in enumerate(layers):
            self.add_module(f"conv_fcn{i + 1}", Conv2d(
                in_channels if i == 0 else layers[i - 1], ch, 3, padding=1,
                compute_dtype=dtype))

    def forward(self, features, rois, *, impl: str):
        x = pool_rois(features, rois, **self.pooler, impl=impl)
        b, r = x.shape[:2]
        x = _rows(x)
        for i in range(1, self.num_layers + 1):
            x = F.relu(getattr(self, f"conv_fcn{i}")(x))
        return x.reshape((b, r) + x.shape[1:])


class FoldedConvTranspose2d(ConvTranspose2d):
    """A transposed convolution (groups 1) as a product over the input
    channels, then a fold: each input pixel's [K, kh, kw] patch is
    ``x[pixel] @ weight.reshape(C, K * kh * kw)`` (one matmul over the
    channels-last rows), and ``F.fold`` (col2im) sums the patches that
    overlap each output pixel. Both sum in a fixed order on the card
    (cuBLAS without atomics; col2im gathers each output pixel's taps in a
    loop), so a rerun gives the same bits, where cuDNN's transposed
    convolution may pick a kernel that sums with atomics. Its backward is
    the matmul's and im2col's, fixed too. The parameters and their
    state-dict names are ``nn.ConvTranspose2d``'s."""

    def conv(self, x, weight, bias) -> torch.Tensor:
        n, c, h, w = x.shape
        k, kh, kw = weight.shape[1:]
        out = [(size - 1) * s - 2 * p + d * (kk - 1) + op + 1
               for size, s, p, d, kk, op in zip(
                   (h, w), self.stride, self.padding, self.dilation,
                   (kh, kw), self.output_padding)]
        cols = x.permute(0, 2, 3, 1).reshape(n * h * w, c) \
            @ weight.to(x.dtype).reshape(c, k * kh * kw)
        y = F.fold(cols.view(n, h * w, -1).transpose(1, 2), out, (kh, kw),
                   dilation=self.dilation, padding=self.padding,
                   stride=self.stride)
        return y if bias is None else y + bias.to(y.dtype).view(1, -1, 1, 1)


def _upsample_matrix(n: int, like: torch.Tensor) -> torch.Tensor:
    """[2n, n]: the weights of a 2x bilinear upsample (half-pixel centres)
    along one axis, as ``F.interpolate`` applies them (0.25, 0.75 or 1)."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return F.interpolate(eye[None, None], scale_factor=(2, 1),
                         mode="bilinear", align_corners=False)[0, 0]


class _Upsample2x(torch.autograd.Function):
    """``F.interpolate``'s 2x bilinear upsample, whose gradient is
    ``A_h^T @ g @ A_w`` (two matmuls, fixed sum order) instead of the CUDA
    backward's atomic adds."""

    @staticmethod
    def forward(ctx, x):
        ctx.hw = x.shape[-2:]
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.hw
        return _upsample_matrix(h, g).t() @ g @ _upsample_matrix(w, g)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of [N, C, H, W], ``F.interpolate``'s values,
    whose gradient sums in a fixed order (``_Upsample2x``)."""
    return _Upsample2x.apply(x)


class KeypointRCNNPredictor(nn.Module):
    """``kps_score_lowres`` and the 2x bilinear upsample: [B, R, C, P, P]
    -> [B, R, K, 4P - 4, 4P - 4] float32. ``kps_score_lowres`` is a
    ``FoldedConvTranspose2d`` and the upsample ``upsample2x``: the
    heatmaps and their gradients rerun bit for bit on the card."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kps_score_lowres = FoldedConvTranspose2d(
            in_channels, num_keypoints, 4, stride=2, padding=2)

    def forward(self, x):
        b, r = x.shape[:2]
        x = self.kps_score_lowres(_rows(x).to(self.dtype).float())
        x = upsample2x(x)
        return x.reshape((b, r) + x.shape[1:])


class KeypointHead(nn.Module):
    """The extractor and the predictor; state-dict names
    ``roi_heads.keypoint.feature_extractor.*`` and
    ``roi_heads.keypoint.predictor.*``."""

    def __init__(self, feature_extractor: nn.Module, predictor: nn.Module):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.predictor = predictor

    def forward(self, features, rois, *, impl: str):
        return self.predictor(self.feature_extractor(features, rois,
                                                     impl=impl))


def keypoints_to_heatmap_targets(keypoints: torch.Tensor, rois: torch.Tensor,
                                 heatmap_size: int):
    """keypoints [R, K, 3] (x, y, visibility) and rois [R, 4] -> (flat cell
    index [R, K] int64, valid [R, K] bool) in each ROI's heatmap frame
    (reference keypoint_head/loss.py keypoints_to_heat_map): a keypoint is
    valid when visible (v > 0) and its cell lies inside the heatmap (one on
    the ROI's far edge does not)."""
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    # a true division (a Python number over a tensor is its reciprocal
    # times the number, another rounding that moves far-edge cells)
    size = rois.new_tensor(float(heatmap_size))
    sw = size / (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1e-3)
    sh = size / (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1e-3)
    px = torch.floor((keypoints[..., 0] - x1) * sw).long()
    py = torch.floor((keypoints[..., 1] - y1) * sh).long()
    inb = (px >= 0) & (px < heatmap_size) & (py >= 0) & (py < heatmap_size)
    valid = inb & (keypoints[..., 2] > 0)
    pos = py.clamp(0, heatmap_size - 1) * heatmap_size \
        + px.clamp(0, heatmap_size - 1)
    return pos, valid


def keypoint_rcnn_loss(kp_head: KeypointHead, det_feats, sampled,
                       gt_keypoints: torch.Tensor, targets, *,
                       impl: str) -> torch.Tensor:
    """Cross-entropy over the flattened heatmap of each visible keypoint
    of the positive source rows, summed and divided by their count over
    the global batch (``parallel.global_mean``, floor 1). ``gt_keypoints``
    [B, G, K, 3]; each sampled ROI takes the keypoints of its GT by IoU
    over the valid GT (the first on a tie)."""
    logits = kp_head(det_feats, sampled.rois, impl=impl)   # [B, S, K, H, H]
    b, s, k, hm = logits.shape[:4]
    iou = box_ops.box_iou(sampled.rois, targets.boxes)     # [B, S, G]
    iou = torch.where(targets.valid[:, None, :], iou, -1.0)
    kp = _take(gt_keypoints, iou.argmax(dim=2))            # [B, S, K, 3]
    pos, kp_valid = keypoints_to_heatmap_targets(
        kp.reshape(b * s, k, 3), sampled.rois.reshape(b * s, 4), hm)
    roi_ok = ((sampled.labels > 0) & sampled.valid
              & sampled.domain_mask).reshape(b * s)
    w = (kp_valid & roi_ok[:, None]).float()
    logp = F.log_softmax(logits.float().reshape(b * s, k, -1), dim=-1)
    nll = -torch.gather(logp, 2, pos[..., None])[..., 0]
    return global_mean((nll * w).sum(), w.sum(), 1.0)


def heatmaps_to_keypoints(heatmaps: torch.Tensor,
                          rois: torch.Tensor) -> torch.Tensor:
    """[R, K, H, W] logits and rois [R, 4] -> keypoints [R, K, 3] (x, y,
    score) in image coordinates (reference keypoint inference)."""
    r, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(r, k, h * w)
    idx = flat.argmax(dim=2)                                # [R, K]
    score = torch.gather(torch.softmax(flat, dim=2), 2, idx[..., None])[
        ..., 0]
    py = torch.div(idx, w, rounding_mode="floor").float() + 0.5
    px = (idx % w).float() + 0.5
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    sw = (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1e-3) / w
    sh = (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1e-3) / h
    return torch.stack([px * sw + x1, py * sh + y1, score], dim=-1)


def make_keypoint_head(cfg, in_channels: int,
                       dtype: torch.dtype = torch.float32) -> KeypointHead:
    """The keypoint head of ``cfg`` over maps of ``in_channels`` (the FPN
    levels' width)."""
    h = cfg.MODEL.ROI_KEYPOINT_HEAD
    layers = tuple(h.CONV_LAYERS)
    extractor = KeypointRCNNFeatureExtractor(
        pooler_config(cfg, "ROI_KEYPOINT_HEAD"), in_channels, layers,
        dtype=dtype)
    predictor = KeypointRCNNPredictor(layers[-1] if layers else in_channels,
                                      h.NUM_CLASSES, dtype=dtype)
    return KeypointHead(extractor, predictor)


def keypoint_layers(head: KeypointHead) -> list[nn.Module]:
    """``conv_fcn*`` and ``kps_score_lowres``: the convolutions
    ``init_parameters`` draws kaiming fan-out normal."""
    return [m for m in head.modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
