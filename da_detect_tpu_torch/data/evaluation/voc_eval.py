"""Pascal VOC detection mAP (port of
``da_detect_tpu/data/evaluation/voc_eval.py``; reference
data/datasets/evaluation/voc/voc_eval.py:216): the VOC07 11-point or the
VOC10 area AP at an IoU threshold, legacy +1 box widths, difficult GT
neither a hit nor a miss."""

from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np

log = logging.getLogger(__name__)


def voc_ap(rec, prec, use_07_metric=False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.flatnonzero(mrec[1:] != mrec[:-1])
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def do_voc_evaluation(dataset, predictions, output_folder=None,
                      iou_thresh=0.5, use_07_metric=True):
    n_classes = len(dataset.CLASSES)
    aps = OrderedDict()
    for cls in range(1, n_classes):
        # gather gt and dets for this class
        gts = {}
        npos = 0
        for index in range(len(dataset)):
            s = dataset.sample(index)
            sel = s["labels"] == cls
            boxes = s["boxes"][sel]
            difficult = s.get("difficult", np.zeros(len(s["labels"]), bool))[sel]
            gts[s["image_id"]] = dict(boxes=boxes, difficult=difficult,
                                      matched=np.zeros(len(boxes), bool))
            npos += int((~difficult).sum())
        dets = []
        for img_id, p in predictions.items():
            sel = np.asarray(p["labels"]) == cls
            for b, sc in zip(np.asarray(p["boxes"])[sel],
                             np.asarray(p["scores"])[sel]):
                dets.append((img_id, float(sc), b))
        dets.sort(key=lambda d: -d[1])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for di, (img_id, _, bb) in enumerate(dets):
            gt = gts.get(img_id)
            if gt is None or len(gt["boxes"]) == 0:
                fp[di] = 1
                continue
            g = gt["boxes"]
            ixmin = np.maximum(g[:, 0], bb[0])
            iymin = np.maximum(g[:, 1], bb[1])
            ixmax = np.minimum(g[:, 2], bb[2])
            iymax = np.minimum(g[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inter = iw * ih
            uni = ((bb[2] - bb[0] + 1) * (bb[3] - bb[1] + 1)
                   + (g[:, 2] - g[:, 0] + 1) * (g[:, 3] - g[:, 1] + 1) - inter)
            ious = inter / np.maximum(uni, 1e-10)
            jmax = int(np.argmax(ious))
            if ious[jmax] > iou_thresh:
                if gt["difficult"][jmax]:
                    continue  # neither tp nor fp
                if not gt["matched"][jmax]:
                    tp[di] = 1
                    gt["matched"][jmax] = True
                else:
                    fp[di] = 1
            else:
                fp[di] = 1
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / max(npos, 1)
        prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        aps[dataset.CLASSES[cls]] = voc_ap(rec, prec, use_07_metric)
    m_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    log.info("VOC mAP@%.2f = %.4f", iou_thresh, m_ap)
    for k, v in aps.items():
        log.info("  %-16s %.4f", k, v)
    return {"voc": dict(map=m_ap, per_class=dict(aps))}
