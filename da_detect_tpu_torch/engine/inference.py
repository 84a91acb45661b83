"""Evaluation engine (port of ``da_detect_tpu/engine/inference.py``;
reference engine/inference.py:18-129).

``compute_on_dataset`` runs the model's eval forward on each fixed-shape
batch of an eval loader, brings the detections to the host, drops the
padding, rescales the boxes to the original images and returns them by
image id (with each detection's mask probabilities in its box's frame
when the evaluation asks for ``segm``, its keypoints in the original image
when it asks for ``keypoints``); ``inference`` hands them to the dataset's
evaluator. The loop keeps one batch in flight: batch N + 1 is
dispatched before batch N's detections are read back.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

log = logging.getLogger(__name__)


def _host_predictions(dets, extra, kind, image_ids, sizes, orig,
                      predictions) -> int:
    """Batch detections -> ``predictions[image_id]`` in original-image
    coordinates, with the valid detections' ``extra`` under ``kind``:
    "mask_probs" [D, Hm, Wm] (the batch's mask probabilities) or
    "keypoints" [D, K, 3] (x and y rescaled to the original image); returns
    the images added (padding entries skipped)."""
    if extra is not None:
        extra = extra.cpu().numpy()
    valid = dets.valid.cpu().numpy()
    boxes = dets.boxes.cpu().numpy()
    scores = dets.scores.cpu().numpy()
    labels = dets.labels.cpu().numpy()
    added = 0
    for i, img_id in enumerate(image_ids):
        if img_id is None:  # padding entry of the last batch
            continue
        sy = orig[i, 0] / max(sizes[i, 0], 1)
        sx = orig[i, 1] / max(sizes[i, 1], 1)
        predictions[img_id] = dict(
            boxes=boxes[i][valid[i]] * np.array([sx, sy, sx, sy], np.float32),
            scores=scores[i][valid[i]], labels=labels[i][valid[i]])
        if kind == "mask_probs":
            predictions[img_id]["mask_probs"] = extra[i][valid[i]]
        elif kind == "keypoints":
            kp = extra[i][valid[i]].astype(np.float32)
            kp[..., 0] *= sx
            kp[..., 1] *= sy
            predictions[img_id]["keypoints"] = kp
        added += 1
    return added


@torch.no_grad()
def compute_on_dataset(model, data_loader, progress_every: int = 50,
                       with_masks: bool = False,
                       with_keypoints: bool = False) -> dict[Any, dict]:
    """{image_id: dict(boxes xyxy, scores, labels[, mask_probs |
    keypoints])} in original image coordinates, numpy, for every image of
    ``data_loader`` (an eval loader yielding (ImageBatch, image ids));
    ``with_masks``: the mask head's probabilities too (a ``MASK_ON``
    model); ``with_keypoints`` (and not ``with_masks``): the keypoint
    head's keypoints (a ``KEYPOINT_ON`` model)."""
    kind = ("mask_probs" if with_masks
            else "keypoints" if with_keypoints else None)
    predictions: dict[Any, dict] = {}
    t0 = time.perf_counter()
    n_images = 0
    pending = None
    for bi, (batch, image_ids) in enumerate(data_loader):
        # the sizes' read waits for the forward in flight; the next one is
        # queued before that forward's detections are post-processed
        sizes = batch.sizes.cpu().numpy()
        orig = batch.orig_sizes.cpu().numpy()
        out = model(batch, with_masks=with_masks,
                    with_keypoints=with_keypoints) if kind \
            else (model(batch), None)
        if pending is not None:
            n_images += _host_predictions(*pending, predictions)
        pending = (*out, kind, image_ids, sizes, orig)
        if progress_every and (bi + 1) % progress_every == 0:
            dt = time.perf_counter() - t0
            log.info("eval %d images (%.3f s/img)", n_images,
                     dt / max(n_images, 1))
    if pending is not None:
        n_images += _host_predictions(*pending, predictions)
    total = time.perf_counter() - t0
    log.info("total eval time: %.1fs (%.4f s/img, %d images)", total,
             total / max(n_images, 1), n_images)
    return predictions


def evaluate_merged(dataset, predictions: dict, **kwargs):
    """The dataset's evaluation of every rank's ``predictions`` (this rank's
    shard): in a process group the shards are merged on every rank
    (``comm.accumulate_predictions``, the JAX package's :156-157) and
    evaluated once, on the main process, which writes the outputs; every
    rank returns its results. Returns (results, merged predictions); no
    predictions are not evaluated (results None)."""
    from ..data.evaluation import evaluate
    from ..utils import comm

    world = comm.get_world_size()
    if world > 1:
        predictions = comm.accumulate_predictions(predictions)
    if not predictions:
        return None, predictions
    if world == 1:
        return evaluate(dataset, predictions, **kwargs), predictions
    results = (evaluate(dataset, predictions, **kwargs)
               if comm.is_main_process() else None)
    return comm.all_gather(results)[0], predictions


def inference(model, data_loader, dataset, *, iou_types=("bbox",),
              output_folder: str | None = None, expected_results=None,
              expected_results_sigma_tol: float = 4.0, style: str = "coco"):
    """Predictions and the dataset's evaluation (reference
    inference.py:76-129). In a process group each rank predicts its
    loader's shard and the merge is evaluated once (``evaluate_merged``).
    ``segm`` in ``iou_types`` runs the mask head too, ``keypoints`` the
    keypoint head. Returns (results, predictions: every rank's)."""
    predictions = compute_on_dataset(
        model, data_loader, with_masks="segm" in iou_types,
        with_keypoints="keypoints" in iou_types)
    results, predictions = evaluate_merged(
        dataset, predictions, output_folder=output_folder,
        iou_types=iou_types, style=style)
    if not predictions:
        # a consumed (one-pass) loader would evaluate nothing and report NaN
        raise RuntimeError(
            "evaluation produced no predictions: eval loaders are one-pass; "
            "build a fresh one for each inference() call")
    if expected_results:
        check_expected_results(results, expected_results,
                               expected_results_sigma_tol)
    return results, predictions


def check_expected_results(results, expected, sigma_tol):
    """Regression gate (reference coco_eval.py:396-414)."""
    for task, metric, mean, std in expected:
        actual = results[task][metric]
        lo, hi = mean - sigma_tol * std, mean + sigma_tol * std
        msg = (f"{task} > {metric}: {actual:.4f} expected in "
               f"[{lo:.4f}, {hi:.4f}]")
        if not (lo < actual < hi):
            log.error("FAIL: %s", msg)
            raise AssertionError(msg)
        log.info("PASS: %s", msg)
