"""Cityscapes-style instance-level AP, bbox and segm (port of
``da_detect_tpu/data/evaluation/cityscapes_eval.py``): the evaluator the
reference vendors for its Cityscapes tooling
(tools/cityscapes/maskrcnn_benchmark/data/datasets/evaluation/cityscapes/
eval_instances.py, from cityscapesScripts'
evalInstanceLevelSemanticLabeling). ``TEST.EVAL_STYLE cityscapes`` selects
it. Its semantics, each kept:

* overlaps 0.50:0.05:0.95, min region size 100 (the box's area; under
  segm the GT's mask pixels inside its box) — eval_instances.py:86-89
* integer (``.long()``) box coordinates; area and intersection WITHOUT the
  legacy +1 (unlike COCO-style eval) — :274-300, :192-199
* duplicate matches to one GT: the lower-scored prediction becomes a false
  positive carrying its own score — :496-505
* unmatched GTs are hard false negatives folded into recall — :510-511
* unmatched predictions are ignored (not FP) when the share of their area
  over too-small GT regions exceeds the overlap threshold — :530-545
* the PR curve over unique score thresholds with step-wise integration and
  an artificial (r=0, p=1) point — :555-607; AP / AP50 / AP75 averages with
  NaN for classes absent from both GT and predictions — :823-845

Host-side numpy on the prediction dicts (img_id -> boxes/scores/labels
[+ mask_probs] in original-image coordinates) and ``COCODataset``
annotations. The mask protocol (``segm``, ``use_masks``): GT polygons
rasterized at full resolution, each detection's mask pasted into its box
(``masker.paste_single_crop``), intersections counted in mask pixels inside
the pair's bounding rectangle, and a prediction's size its mask's pixel
count.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from ..image_io import require_cv2
from ..masker import paste_single_crop

log = logging.getLogger(__name__)

OVERLAPS = np.arange(0.5, 1.0, 0.05)
MIN_REGION_SIZE = 100


def _int_box(b):
    return int(b[0]), int(b[1]), int(b[2]), int(b[3])


def _box_area(b):
    return max(b[2] - b[0], 0) * max(b[3] - b[1], 0)


def _overlapping(a, b):
    return a[0] < b[2] and b[0] < a[2] and a[1] < b[3] and b[1] < a[3]


def _box_intersection(a, b):
    xmin, ymin = max(a[0], b[0]), max(a[1], b[1])
    xmax, ymax = min(a[2], b[2]), min(a[3], b[3])
    return (xmax - xmin) * (ymax - ymin)


def _mask_intersection(gt, pred):
    if gt.get("mask") is None or pred.get("mask") is None:
        return 0
    a, b = gt["box"], pred["box"]
    xmin, ymin = min(a[0], b[0]), min(a[1], b[1])
    xmax, ymax = max(a[2], b[2]), max(a[3], b[3])
    return int(np.count_nonzero(gt["mask"][ymin:ymax, xmin:xmax]
                                & pred["mask"][ymin:ymax, xmin:xmax]))


def _gt_masks_fullsize(anns, h, w):
    """Rasterize polygon segmentations at original resolution."""
    cv2 = require_cv2("cityscapes mask evaluation")
    out = []
    for a in anns:
        seg = a.get("segmentation")
        if not seg or not isinstance(seg, list):
            out.append(None)
            continue
        m = np.zeros((h, w), np.uint8)
        polys = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(
            np.int32) for p in seg if len(p) >= 6]
        if polys:
            cv2.fillPoly(m, polys, 1)
        out.append(m.astype(bool))
    return out


def match_gts_with_preds(dataset, predictions, use_masks: bool = False,
                         mask_thresh: float = 0.5):
    """Per image: list every (gt, pred) pair with nonzero intersection, in
    box pixels or, with ``use_masks``, mask pixels (eval_instances.py
    matchGtWithPred)."""
    missing = [i for i in dataset.ids if i not in predictions]
    if missing:
        raise ValueError(
            f"predictions missing for {len(missing)} images (e.g. "
            f"{missing[:3]}); the protocol scores every dataset image "
            "(eval_instances.py:150 asserts equal lengths)")
    matches = []
    for idx, img_id in enumerate(dataset.ids):
        info = dataset.get_img_info(idx)
        h, w = info["height"], info["width"]
        anns = dataset.anns[img_id]

        gt_masks = (_gt_masks_fullsize(anns, h, w) if use_masks
                    else [None] * len(anns))
        gts = []
        for a, m in zip(anns, gt_masks):
            x, y, bw, bh = a["bbox"]
            # legacy inclusive xyxy (x2 = x + w - 1), the BoxList convention
            # the reference evaluator receives (eval_instances.py:286 .long())
            box = _int_box((x, y, x + bw - 1, y + bh - 1))
            gts.append({
                "label": dataset.json_category_id_to_contiguous_id[
                    a["category_id"]],
                "box": box,
                "boxArea": _box_area(box),
                "pixelCount": (int(np.count_nonzero(
                    m[box[1]:box[3], box[0]:box[2]])) if m is not None else 0),
                "mask": m,
                "matchedPred": [],
            })

        p = predictions[img_id]
        boxes = np.asarray(p["boxes"], np.float64).reshape(-1, 4)
        preds = []
        for di, (b, s, l) in enumerate(zip(boxes, p["scores"], p["labels"])):
            box = _int_box(b)
            mask = None
            if use_masks and p.get("mask_probs") is not None:
                crop, (oy, ox) = paste_single_crop(
                    np.asarray(p["mask_probs"][di]), b, (h, w),
                    threshold=mask_thresh)
                mask = np.zeros((h, w), bool)
                ch, cw = crop.shape
                mask[oy:oy + ch, ox:ox + cw] = crop
            preds.append({
                "label": int(l),
                "box": box,
                "boxArea": (_box_area(box) if mask is None
                            else int(np.count_nonzero(mask))),
                "confidence": float(s),
                "mask": mask,
                "matchedGt": [],
            })

        # every overlapping pair registers, regardless of class — the
        # reference groups by class only AFTER matching, so cross-class
        # pairs participate in TPs and ignore absorption
        # (eval_instances.py:230-255)
        for gt in gts:
            for pred in preds:
                if not _overlapping(gt["box"], pred["box"]):
                    continue
                inter = (_mask_intersection(gt, pred) if use_masks
                         else _box_intersection(gt["box"], pred["box"]))
                if inter <= 0:
                    continue
                gt["matchedPred"].append({"pred": pred, "intersection": inter})
                pred["matchedGt"].append({"gt": gt, "intersection": inter})
        for inst in gts + preds:
            inst["mask"] = None  # intersections made: free the full masks
        matches.append({"gts": gts, "preds": preds})
    return matches


def _instance_size(inst, use_masks):
    return inst["pixelCount"] if use_masks else inst["boxArea"]


def evaluate_matches(matches, labels, use_masks: bool = False,
                     overlaps=OVERLAPS,
                     min_region_size: int = MIN_REGION_SIZE) -> np.ndarray:
    """AP per (class, overlap); NaN when a class has neither GT nor
    predictions (eval_instances.py evaluateBoxMatches/evaluateMaskMatches)."""
    ap = np.zeros((len(labels), len(overlaps)), np.float64)
    for li, label in enumerate(labels):
        for oi, overlap_th in enumerate(overlaps):
            y_true, y_score = [], []
            hard_fns = 0
            have_gt = have_pred = False
            for img in matches:
                gts = [g for g in img["gts"] if g["label"] == label
                       and _instance_size(g, use_masks) >= min_region_size]
                preds = [p for p in img["preds"] if p["label"] == label]
                have_gt |= bool(gts)
                have_pred |= bool(preds)

                cur_true, cur_score, cur_match = [], [], []
                for gt in gts:
                    found = False
                    score = None
                    for m in gt["matchedPred"]:
                        denom = (_instance_size(gt, use_masks)
                                 + m["pred"]["boxArea"] - m["intersection"])
                        if denom <= 0 or m["intersection"] / denom <= overlap_th:
                            continue
                        conf = m["pred"]["confidence"]
                        if found:
                            # second match on the same GT: lower score is FP
                            lo, hi = min(score, conf), max(score, conf)
                            score = hi
                            cur_true.append(0)
                            cur_score.append(lo)
                            cur_match.append(True)
                        else:
                            found = True
                            score = conf
                    if found:
                        cur_true.append(1)
                        cur_score.append(score)
                        cur_match.append(True)
                    else:
                        hard_fns += 1
                for pred in preds:
                    found_gt = False
                    for m in pred["matchedGt"]:
                        denom = (_instance_size(m["gt"], use_masks)
                                 + pred["boxArea"] - m["intersection"])
                        if denom > 0 and m["intersection"] / denom > overlap_th:
                            found_gt = True
                            break
                    if not found_gt:
                        ignore = sum(
                            m["intersection"] for m in pred["matchedGt"]
                            if _instance_size(m["gt"], use_masks)
                            < min_region_size)
                        prop = (ignore / pred["boxArea"]
                                if pred["boxArea"] > 0 else 0.0)
                        if prop <= overlap_th:
                            cur_true.append(0)
                            cur_score.append(pred["confidence"])
                y_true.extend(cur_true)
                y_score.extend(cur_score)

            if have_gt and have_pred:
                ap[li, oi] = _average_precision(
                    np.asarray(y_true, np.float64),
                    np.asarray(y_score, np.float64), hard_fns)
            elif have_gt:
                ap[li, oi] = 0.0
            else:
                ap[li, oi] = np.nan
    return ap


def _average_precision(y_true, y_score, hard_fns: int) -> float:
    """Step-wise PR integration over unique thresholds
    (eval_instances.py:553-607)."""
    order = np.argsort(y_score)
    y_score, y_true = y_score[order], y_true[order]
    cumsum = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    n = len(y_score)
    n_true = cumsum[-1] if n else 0
    precision = np.zeros(len(unique_idx) + 1)
    recall = np.zeros(len(unique_idx) + 1)
    cumsum = np.append(cumsum, 0)  # index -1 -> 0
    for res_i, score_i in enumerate(unique_idx):
        below = cumsum[score_i - 1]
        tp = n_true - below
        fp = n - score_i - tp
        fn = below + hard_fns
        precision[res_i] = tp / (tp + fp)
        recall[res_i] = tp / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0
    r = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(r, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def compute_averages(ap: np.ndarray, class_names, overlaps=OVERLAPS) -> dict:
    o50 = np.isclose(overlaps, 0.5)
    o75 = np.isclose(overlaps, 0.75)
    out = {
        "allAp": float(np.nanmean(ap)),
        "allAp50%": float(np.nanmean(ap[:, o50])),
        "allAp75%": float(np.nanmean(ap[:, o75])),
        "classes": {},
    }
    for li, name in enumerate(class_names):
        out["classes"][name] = {
            "ap": float(np.average(ap[li])),
            "ap50%": float(np.average(ap[li, o50])),
            "ap75%": float(np.average(ap[li, o75])),
        }
    return out


def do_cityscapes_evaluation(dataset, predictions, output_folder=None,
                             iou_types=("bbox",)) -> dict:
    """Returns {iou_type: averages-dict}. ``dataset`` is a COCODataset over
    a cityscapes-cocostyle json; predictions are the standard per-image
    dicts (boxes in original-image coordinates)."""
    labels = sorted(dataset.contiguous_category_id_to_json_id)
    names = [dataset.cats[dataset.contiguous_category_id_to_json_id[l]]
             ["name"] for l in labels]
    results = {}
    for iou_type in iou_types:
        use_masks = iou_type == "segm"
        matches = match_gts_with_preds(dataset, predictions,
                                       use_masks=use_masks)
        ap = evaluate_matches(matches, labels, use_masks=use_masks)
        avg = compute_averages(ap, names)
        log.info("cityscapes %s: AP=%.4f AP50=%.4f AP75=%.4f", iou_type,
                 avg["allAp"], avg["allAp50%"], avg["allAp75%"])
        for name, r in avg["classes"].items():
            log.info("  %-16s ap=%.4f ap50=%.4f", name, r["ap"], r["ap50%"])
        results[iou_type] = avg
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder,
                               "cityscapes_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results
