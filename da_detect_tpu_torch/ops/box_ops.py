"""Box geometry + Faster-RCNN box coding (port of
``da_detect_tpu/ops/box_ops.py``).

Detectron legacy ``TO_REMOVE = 1`` pixel convention (width = x2 - x1 + 1)
by default; ``legacy_plus1=False`` takes continuous coordinates (width =
x2 - x1), as in the JAX package. Every function broadcasts over leading
batch dims, and the arithmetic keeps the JAX package's operation order, so
that IoU values near an NMS threshold compare the same way in both.
"""

from __future__ import annotations

import math

import torch

# decode clamp: same constant as the reference box coder
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def _wh(boxes: torch.Tensor, legacy_plus1: bool = True):
    off = 1.0 if legacy_plus1 else 0.0
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    return w, h


def box_area(boxes: torch.Tensor, legacy_plus1: bool = True) -> torch.Tensor:
    w, h = _wh(boxes, legacy_plus1)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor,
            legacy_plus1: bool = True) -> torch.Tensor:
    """Pairwise IoU. a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    off = 1.0 if legacy_plus1 else 0.0
    area_a = box_area(a, legacy_plus1)[..., :, None]
    area_b = box_area(b, legacy_plus1)[..., None, :]
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + off).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a + area_b - inter).clamp(min=1e-10)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 legacy_plus1: bool = True) -> torch.Tensor:
    """Encode gt ``reference_boxes`` w.r.t. ``proposals`` as (dx,dy,dw,dh)
    regression targets."""
    wx, wy, ww, wh = weights
    ex_w, ex_h = _wh(proposals, legacy_plus1)
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w, gt_h = _wh(reference_boxes, legacy_plus1)
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    # guard against degenerate padded rows
    ex_w = ex_w.clamp(min=1e-6)
    ex_h = ex_h.clamp(min=1e-6)
    gt_w = gt_w.clamp(min=1e-6)
    gt_h = gt_h.clamp(min=1e-6)
    return torch.stack([
        wx * (gt_cx - ex_cx) / ex_w,
        wy * (gt_cy - ex_cy) / ex_h,
        ww * torch.log(gt_w / ex_w),
        wh * torch.log(gt_h / ex_h),
    ], dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 legacy_plus1: bool = True) -> torch.Tensor:
    """Apply (dx,dy,dw,dh) deltas to anchor/proposal ``boxes``.
    deltas [..., N, 4*k], boxes [..., N, 4] -> [..., N, 4*k]."""
    wx, wy, ww, wh = weights
    w, h = _wh(boxes, legacy_plus1)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = (deltas[..., 2::4] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3::4] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    off = 1.0 if legacy_plus1 else 0.0
    out = torch.stack([
        pred_cx - 0.5 * pred_w,
        pred_cy - 0.5 * pred_h,
        pred_cx + 0.5 * pred_w - off,
        pred_cy + 0.5 * pred_h - off,
    ], dim=-1)  # [..., N, k, 4]
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, height, width,
               legacy_plus1: bool = True) -> torch.Tensor:
    """Clamp to the image frame. ``height``/``width`` are scalars or tensors
    that broadcast against ``boxes[..., 0]``."""
    off = 1.0 if legacy_plus1 else 0.0
    f32 = dict(dtype=boxes.dtype, device=boxes.device)
    hmax = torch.as_tensor(height, **f32) - off
    wmax = torch.as_tensor(width, **f32) - off
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), wmax)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), hmax)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), wmax)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def min_size_mask(boxes: torch.Tensor, min_size: float,
                  legacy_plus1: bool = True) -> torch.Tensor:
    """True where both sides >= min_size."""
    w, h = _wh(boxes, legacy_plus1)
    return (w >= min_size) & (h >= min_size)


def scale_boxes(boxes: torch.Tensor, scale_y, scale_x) -> torch.Tensor:
    """Per-axis rescale (BoxList.resize for the non-uniform case);
    ``scale_y``/``scale_x`` scalars or tensors that broadcast against
    ``boxes[..., 0]``."""
    sx = torch.as_tensor(scale_x, dtype=boxes.dtype, device=boxes.device)
    sy = torch.as_tensor(scale_y, dtype=boxes.dtype, device=boxes.device)
    return boxes * torch.stack(torch.broadcast_tensors(sx, sy, sx, sy),
                               dim=-1)


def hflip_boxes(boxes: torch.Tensor, image_width,
                legacy_plus1: bool = True) -> torch.Tensor:
    """Horizontal flip within a frame ``image_width`` wide."""
    off = 1.0 if legacy_plus1 else 0.0
    w = torch.as_tensor(image_width, dtype=boxes.dtype, device=boxes.device)
    x1 = w - off - boxes[..., 2]
    x2 = w - off - boxes[..., 0]
    return torch.stack(torch.broadcast_tensors(x1, boxes[..., 1], x2,
                                               boxes[..., 3]), dim=-1)


def xywh_to_xyxy(boxes: torch.Tensor, legacy_plus1: bool = True
                 ) -> torch.Tensor:
    off = 1.0 if legacy_plus1 else 0.0
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + (w - off).clamp(min=0.0),
                        y + (h - off).clamp(min=0.0)], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor, legacy_plus1: bool = True
                 ) -> torch.Tensor:
    off = 1.0 if legacy_plus1 else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1 + off, y2 - y1 + off], dim=-1)
