"""Test-time augmentation, multi-scale and horizontal flip (port of
``da_detect_tpu/engine/bbox_aug.py``; reference engine/bbox_aug.py:11-118).

Enabled by ``TEST.BBOX_AUG.ENABLED``. The passes: the test scale, its flip
(``H_FLIP``), then each of ``SCALES`` at ``MAX_SIZE`` and, with
``SCALE_H_FLIP``, its flip. Each pass runs the eval forward on a canvas
derived for its scale; flipped passes' boxes are mirrored back; each image's
detections of every pass are merged in original-image coordinates by a
per-class NMS.

The JAX package merges with a host C++ NMS (``native.nms_per_class``). The
port merges on the model's device through ``ops/nms.py::nms_mask``, one call
an image over a [classes, N] batch (each class's candidates in a row, in
index order, the row padded and masked): the same greedy NMS (legacy +1 IoU,
suppression at iou > threshold, ties in score by index), so the kept set is
the same; it is then ordered as the JAX package orders it: kept indices
ascending, a stable sort by score, descending, cut to
``TEST.DETECTIONS_PER_IMG``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.nms import nms_mask

log = logging.getLogger(__name__)


def tta_passes(cfg) -> list[tuple[int, int, bool]]:
    """(min size, max size, hflip) of each pass, in the JAX package's
    order."""
    aug = cfg.TEST.BBOX_AUG
    passes = [(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, False)]
    if aug.H_FLIP:
        passes.append((cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, True))
    for s in aug.SCALES:
        passes.append((s, aug.MAX_SIZE, False))
        if aug.SCALE_H_FLIP:
            passes.append((s, aug.MAX_SIZE, True))
    return passes


def class_rows(labels: np.ndarray):
    """Each candidate's (row, column) in a [classes, N] batch that holds
    each class's candidates in a row, in index order; and the shape."""
    classes, row, counts = np.unique(labels, return_inverse=True,
                                     return_counts=True)
    grouped = np.argsort(row, kind="stable")
    col = np.empty(len(labels), np.int64)
    col[grouped] = np.arange(len(labels)) - np.repeat(
        np.cumsum(counts) - counts, counts)
    return row, col, (len(classes), int(counts.max()))


def merge_per_class(boxes: np.ndarray, scores: np.ndarray,
                    labels: np.ndarray, thresh: float, max_dets: int, *,
                    device, impl: str) -> np.ndarray:
    """Indices of the merged detections: a per-class greedy NMS of the
    candidates (one ``nms_mask`` call), kept indices ascending, stable
    sorted by score descending, the first ``max_dets``."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    row, col, shape = class_rows(labels)
    b = np.zeros(shape + (4,), np.float32)
    s = np.zeros(shape, np.float32)
    v = np.zeros(shape, bool)
    b[row, col], s[row, col], v[row, col] = boxes, scores, True
    keep = nms_mask(torch.from_numpy(b).to(device),
                    torch.from_numpy(s).to(device),
                    torch.from_numpy(v).to(device), thresh, impl=impl)
    kept = np.flatnonzero(keep.cpu().numpy()[row, col])
    return kept[np.argsort(-scores[kept], kind="stable")][:max_dets]


def compute_on_dataset_aug(model, cfg, dataset_name: str, device=None):
    """Every pass over ``dataset_name`` and the merge; returns (predictions
    {image_id: dict(boxes, scores, labels)}, the dataset)."""
    from ..data import make_data_loader
    from .inference import compute_on_dataset

    merged: dict = {}
    dataset = None
    for min_size, max_size, hflip in tta_passes(cfg):
        c = cfg.clone()
        c.defrost()
        c.INPUT.MIN_SIZE_TEST = min_size
        c.INPUT.MAX_SIZE_TEST = max_size
        c.TPU.IMAGE_SHAPE = (0, 0)  # the canvas of this scale
        loader, dataset = make_data_loader(
            c, is_train=False, device=device, dataset_names=(dataset_name,),
            hflip=hflip, packed=bool(cfg.TPU.PACKED_TRANSPORT))
        log.info("TTA pass: min_size=%s max_size=%s hflip=%s", min_size,
                 max_size, hflip)
        preds = compute_on_dataset(model, loader, progress_every=0)
        widths = {im["id"]: im["width"] for im in dataset.images}
        for img_id, p in preds.items():
            boxes = np.asarray(p["boxes"], np.float32)
            if hflip and len(boxes):
                w0 = widths[img_id]
                boxes = np.stack([w0 - 1 - boxes[:, 2], boxes[:, 1],
                                  w0 - 1 - boxes[:, 0], boxes[:, 3]], 1)
            m = merged.setdefault(img_id, dict(boxes=[], scores=[],
                                               labels=[]))
            m["boxes"].append(boxes)
            m["scores"].append(np.asarray(p["scores"]))
            m["labels"].append(np.asarray(p["labels"]))

    model_device = next(model.parameters()).device
    out = {}
    for img_id, p in merged.items():
        boxes = np.concatenate(p["boxes"])
        scores = np.concatenate(p["scores"])
        labels = np.concatenate(p["labels"])
        keep = merge_per_class(
            boxes, scores, labels, cfg.MODEL.ROI_HEADS.NMS,
            cfg.TEST.DETECTIONS_PER_IMG, device=model_device,
            impl=model.default_impl())
        out[img_id] = dict(boxes=boxes[keep], scores=scores[keep],
                           labels=labels[keep])
    return out, dataset
