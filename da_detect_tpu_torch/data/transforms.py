"""Host-side preprocessing (port of ``da_detect_tpu/data/transforms.py``).

Caffe2 convention: BGR, 0-255, mean subtraction only (PIXEL_STD 1). The resize
keeps the reference's min-side/max-side rule and the result lands on a fixed
padded canvas, so every batch has a static shape. Geometry (min size, flip)
is passed in, so the triplet loader gives the three aligned domains the
same.

The resize is ``torch.nn.functional.interpolate`` (bilinear, half-pixel
centres, no antialiasing) on the uint8 image, where the JAX package calls
``cv2.resize(..., INTER_LINEAR)``. Both round to uint8; they differ by at most
one level on some pixels (by design: cv2's fixed-point weights against
PyTorch's float ones), which is below the bfloat16 rounding of the model's
input.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def compute_resize_hw(height: int, width: int, min_size: int,
                      max_size: int | None):
    """Reference Resize.get_size (transforms.py:35-60): scale so the short
    side hits ``min_size`` unless the long side would exceed ``max_size``."""
    w, h = width, height
    size = min_size
    if max_size is not None:
        min_o, max_o = min(w, h), max(w, h)
        if max_o / min_o * size > max_size:
            size = int(round(max_size * min_o / max_o))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def transform_boxes(boxes: np.ndarray, h: int, w: int, oh: int, ow: int,
                    hflip: bool) -> np.ndarray:
    """Boxes of an (h, w) image in the resized (oh, ow), optionally mirrored
    frame (legacy flip: x -> ow - 1 - x)."""
    if len(boxes):
        boxes = boxes * np.array([ow / w, oh / h, ow / w, oh / h], np.float32)
        if hflip:
            x1 = ow - 1 - boxes[:, 2]
            x2 = ow - 1 - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], 1)
    return boxes.astype(np.float32)


def resize_u8(image: np.ndarray, rh: int, rw: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [rh, rw, 3], bilinear with half-pixel
    centres, on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(rh, rw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).numpy()


def apply_geometry(image: np.ndarray, boxes: np.ndarray, *, min_size: int,
                   max_size: int | None, hflip: bool):
    """Resize (``compute_resize_hw``, ``resize_u8``), then an optional
    horizontal flip, of a uint8 [H, W, 3] image and its boxes [N, 4].
    Returns (image, boxes float32, (rh, rw)). The loaders and the demo do
    the same through ``resize_flip_pad_u8`` and ``transform_boxes``."""
    h, w = image.shape[:2]
    oh, ow = compute_resize_hw(h, w, min_size, max_size)
    if (oh, ow) != (h, w):
        image = resize_u8(image, oh, ow)
    if hflip:
        image = image[:, ::-1]
    return (np.ascontiguousarray(image),
            transform_boxes(boxes, h, w, oh, ow, hflip), (oh, ow))


def resize_flip_pad_u8(image: np.ndarray, canvas_hw, rh: int, rw: int,
                       hflip: bool) -> np.ndarray:
    """The uint8 transport (``TPU.TRANSPORT_PIXELS: uint8``): resize, flip
    and pad the raw pixels; ``ImageBatch.normalized`` normalizes them on the
    device."""
    h, w = image.shape[:2]
    if (rh, rw) != (h, w):
        image = resize_u8(image, rh, rw)
    if hflip:
        image = image[:, ::-1]
    ch, cw = canvas_hw
    out = np.zeros((ch, cw, 3), np.uint8)
    out[:rh, :rw] = image
    return out


def normalize_and_pad(canvas_u8: np.ndarray, rh: int, rw: int, pixel_mean,
                      to_bgr255: bool = True,
                      pixel_std=(1.0, 1.0, 1.0)) -> np.ndarray:
    """``TPU.TRANSPORT_PIXELS: float32``: a ``resize_flip_pad_u8`` canvas
    normalized on the host, float32 [H, W, 3] with zeros outside the image
    (the JAX package's ``apply_geometry`` + ``normalize_and_pad``)."""
    out = np.zeros(canvas_u8.shape, np.float32)
    img = canvas_u8[:rh, :rw].astype(np.float32)
    if not to_bgr255:
        img = img[..., ::-1] / 255.0  # torch convention: RGB 0-1
    out[:rh, :rw] = (img - np.asarray(pixel_mean, np.float32)) / np.asarray(
        pixel_std, np.float32)
    return out


def canvas_for(cfg, is_train: bool):
    """Static canvas (H, W) from config; TPU.IMAGE_SHAPE overrides."""
    th, tw = cfg.TPU.IMAGE_SHAPE
    if th and tw:
        return int(th), int(tw)
    div = max(cfg.DATALOADER.SIZE_DIVISIBILITY, 1)
    mins = cfg.INPUT.MIN_SIZE_TRAIN if is_train else (cfg.INPUT.MIN_SIZE_TEST,)
    max_side = (cfg.INPUT.MAX_SIZE_TRAIN if is_train
                else cfg.INPUT.MAX_SIZE_TEST)

    def up(x):
        return int(-(-x // div) * div)

    return up(max(mins)), up(max_side)


def rasterize_polygons(segmentations, box, resolution: int) -> np.ndarray:
    """COCO polygon(s) -> binary mask in the box's own frame, float32
    [resolution, resolution] (the fixed-shape replacement for the
    reference's SegmentationMask cropping): cv2 ``fillPoly`` of the
    polygons mapped into the box and rounded. No polygon: zeros. Raises
    without cv2 (the JAX package returns zeros there)."""
    mask = np.zeros((resolution, resolution), np.uint8)
    if not segmentations:
        return mask.astype(np.float32)
    from .image_io import require_cv2

    cv2 = require_cv2("rasterize_polygons")
    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    polys = []
    for seg in segmentations:
        p = np.asarray(seg, np.float64).reshape(-1, 2)
        p[:, 0] = (p[:, 0] - x1) / w * resolution
        p[:, 1] = (p[:, 1] - y1) / h * resolution
        polys.append(np.round(p).astype(np.int32))
    cv2.fillPoly(mask, polys, 1)
    return mask.astype(np.float32)
