"""Paste per-ROI mask probabilities into image frames, and binary-mask IoU
for the segm evaluations (port of ``da_detect_tpu/data/masker.py``;
reference roi_heads/mask_head/inference.py Masker).

Host numpy and cv2: masks leave the device as [D, Hm, Wm] probabilities in
each detection box's frame; pasting resizes each into its (clipped) box on
the original image and thresholds. Each function raises without cv2.
"""

from __future__ import annotations

import numpy as np

from .image_io import require_cv2


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, image_hw,
                threshold: float = 0.5, padding: int = 1) -> np.ndarray:
    """mask_probs [D, Hm, Wm]; boxes [D, 4] xyxy (original frame).
    Returns [D, H, W] bool. ``padding`` is the reference's 1-pixel zero pad
    with the box grown to match, which softens the border artifacts."""
    cv2 = require_cv2("paste_masks")
    h, w = image_hw
    out = np.zeros((len(boxes), h, w), bool)
    for i, (prob, box) in enumerate(zip(mask_probs, boxes)):
        if padding:
            m = prob.shape[-1]
            padded = np.zeros((prob.shape[0] + 2 * padding,
                               prob.shape[1] + 2 * padding), np.float32)
            padded[padding:-padding, padding:-padding] = prob
            scale = (m + 2 * padding) / m
            cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
            bw, bh = (box[2] - box[0]) * scale, (box[3] - box[1]) * scale
            box = np.array([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                            cy + bh / 2])
            prob = padded
        x1, y1 = int(np.floor(box[0])), int(np.floor(box[1]))
        x2, y2 = int(np.ceil(box[2])) + 1, int(np.ceil(box[3])) + 1
        x1c, y1c = max(x1, 0), max(y1, 0)
        x2c, y2c = min(x2, w), min(y2, h)
        if x2c <= x1c or y2c <= y1c:
            continue
        resized = cv2.resize(prob.astype(np.float32),
                             (max(x2 - x1, 1), max(y2 - y1, 1)))
        out[i, y1c:y2c, x1c:x2c] = (
            resized[y1c - y1: y2c - y1, x1c - x1: x2c - x1] >= threshold)
    return out


def paste_single_crop(prob: np.ndarray, box, image_hw,
                      threshold: float = 0.5):
    """Paste one [Hm, Wm] probability map into its (clipped, integer) box.
    Returns (bool mask crop, (y offset, x offset)): enough for an exact
    pairwise IoU without full-frame masks."""
    cv2 = require_cv2("paste_single_crop")
    h, w = image_hw
    x1 = max(int(np.floor(box[0])), 0)
    y1 = max(int(np.floor(box[1])), 0)
    x2 = min(int(np.ceil(box[2])) + 1, w)
    y2 = min(int(np.ceil(box[3])) + 1, h)
    if x2 <= x1 or y2 <= y1:
        return np.zeros((1, 1), bool), (0, 0)
    resized = cv2.resize(prob.astype(np.float32), (x2 - x1, y2 - y1))
    return resized >= threshold, (y1, x1)


def rasterize_polygons_crop(segmentations, image_hw):
    """COCO polygon(s) -> (bool mask crop at pixel resolution, (y, x)
    offset)."""
    h, w = image_hw
    polys = [np.asarray(s, np.float64).reshape(-1, 2) for s in segmentations
             if s is not None and len(s) >= 6]
    if not polys:
        return np.zeros((1, 1), bool), (0, 0)
    cv2 = require_cv2("rasterize_polygons_crop")
    x1 = max(int(np.floor(min(p[:, 0].min() for p in polys))), 0)
    y1 = max(int(np.floor(min(p[:, 1].min() for p in polys))), 0)
    x2 = min(int(np.ceil(max(p[:, 0].max() for p in polys))) + 1, w)
    y2 = min(int(np.ceil(max(p[:, 1].max() for p in polys))) + 1, h)
    if x2 <= x1 or y2 <= y1:
        return np.zeros((1, 1), bool), (0, 0)
    canvas = np.zeros((y2 - y1, x2 - x1), np.uint8)
    shifted = [np.round(p - [x1, y1]).astype(np.int32) for p in polys]
    cv2.fillPoly(canvas, shifted, 1)
    return canvas.astype(bool), (y1, x1)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)
