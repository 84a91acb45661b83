"""COCO-style detection evaluation from scratch, bbox, segm and keypoints
(port of ``da_detect_tpu/data/evaluation/coco_eval.py``; no pycocotools).

The COCOeval bbox and segm protocols: IoU thresholds .50:.05:.95, 101-point
interpolated precision, area ranges all/small/medium/large, maxDets (1, 10,
100), crowd GT as ignore regions with the inter/area_dt IoU rule, greedy
score-ordered matching with the ignore-preference tie rules. On top, the
reference DA fork's per-category AP table (reference coco_eval.py:62-66,
378-383) and the COCOResults metric names (coco_eval.py:340-366).

Detections arrive in original-image xyxy; they are converted to the legacy
xywh (+1) form the reference feeds pycocotools (prepare_for_coco_detection,
coco_eval.py:81-112), so numbers are comparable. ``segm``: the mask IoU of
each pair on the rectangle that holds both masks (the detection's pasted
into its box, ``masker.paste_single_crop``; the GT's polygons rasterized,
``masker.rasterize_polygons_crop``), crowd GT as ignore regions on mask
pixels (inter / detection pixels), and a detection's area its mask pixel
count. ``keypoints``: pycocotools' OKS protocol (``setKpParams``): the
object keypoint similarity in place of the IoU (the COCO person-17 sigmas,
0.1 for another keypoint count; a GT with no labelled keypoint scores by
its distance to a box three times its own and is ignore-only), areas
all / medium / large, maxDets 20, a detection's box and area from its
keypoints' extents; the summary ``AP, AP50, AP75, APm, APl, AR20, ARm,
ARl``.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict

import numpy as np

from ..masker import paste_single_crop, rasterize_polygons_crop

log = logging.getLogger(__name__)

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNGS = OrderedDict([
    ("all", (0.0, 1e10)),
    ("small", (0.0, 32.0 ** 2)),
    ("medium", (32.0 ** 2, 96.0 ** 2)),
    ("large", (96.0 ** 2, 1e10)),
])
MAX_DETS = (1, 10, 100)
# the keypoint (OKS) protocol's parameters, pycocotools COCOeval
# setKpParams: maxDets (20,), areas all/medium/large, the COCO person-17
# sigmas
KP_AREA_RNGS = OrderedDict([
    ("all", (0.0, 1e10)),
    ("medium", (32.0 ** 2, 96.0 ** 2)),
    ("large", (96.0 ** 2, 1e10)),
])
KP_MAX_DETS = (20,)
COCO_KP_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
    .87, .87, .89, .89]) / 10.0
IOU_TYPES = ("bbox", "segm", "keypoints")


def _kp_oks(dts, gts):
    """Object keypoint similarity matrix (pycocotools cocoeval computeOks):
    each keypoint's gaussian falloff scaled by sigma^2 and the GT's area;
    a GT with no labelled keypoint uses the distance to a box three times
    its own."""
    ious = np.zeros((len(dts), len(gts)))
    for j, g in enumerate(gts):
        kg = np.asarray(g["_kps"], np.float64).reshape(-1, 3)
        k = kg.shape[0]
        sigmas = COCO_KP_SIGMAS if k == len(COCO_KP_SIGMAS) \
            else np.full(k, 0.1)
        variances = (sigmas * 2.0) ** 2
        xg, yg, vg = kg[:, 0], kg[:, 1], kg[:, 2]
        k1 = int((vg > 0).sum())
        bx, by, bw, bh = g["bbox"]
        x0, x1 = bx - bw, bx + 2 * bw
        y0, y1 = by - bh, by + 2 * bh
        for i, d in enumerate(dts):
            kd = np.asarray(d["_kps"], np.float64).reshape(-1, 3)
            xd, yd = kd[:, 0], kd[:, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx ** 2 + dy ** 2) / variances / (g["area"]
                                                   + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] \
                else 0.0
    return ious


def _bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray):
    """pycocotools iou semantics on xywh boxes; crowd gt -> inter/area_dt."""
    ious = np.zeros((len(dt), len(gt)))
    for j, g in enumerate(gt):
        gx1, gy1, gw, gh = g
        gx2, gy2 = gx1 + gw, gy1 + gh
        ga = gw * gh
        for i, d in enumerate(dt):
            dx1, dy1, dw, dh = d
            dx2, dy2 = dx1 + dw, dy1 + dh
            da = dw * dh
            iw = min(dx2, gx2) - max(dx1, gx1)
            ih = min(dy2, gy2) - max(dy1, gy1)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = da if iscrowd[j] else da + ga - inter
            ious[i, j] = inter / union
    return ious


def _segm_iou(dts, gts, iscrowd):
    """Mask IoU, exact on the union rectangle of each pair (the masks are
    zero outside their crops, so the rectangle's IoU is the image's)."""
    ious = np.zeros((len(dts), len(gts)))
    for j, g in enumerate(gts):
        gm = g.get("_mask")
        if gm is None:
            continue
        gy, gx = g["_mask_offset"]
        for i, d in enumerate(dts):
            dm = d.get("_mask")
            if dm is None:
                continue
            dy, dx = d["_mask_offset"]
            y1 = min(gy, dy)
            x1 = min(gx, dx)
            y2 = max(gy + gm.shape[0], dy + dm.shape[0])
            x2 = max(gx + gm.shape[1], dx + dm.shape[1])
            canvas_g = np.zeros((y2 - y1, x2 - x1), bool)
            canvas_d = np.zeros_like(canvas_g)
            canvas_g[gy - y1: gy - y1 + gm.shape[0],
                     gx - x1: gx - x1 + gm.shape[1]] = gm
            canvas_d[dy - y1: dy - y1 + dm.shape[0],
                     dx - x1: dx - x1 + dm.shape[1]] = dm
            inter = np.logical_and(canvas_g, canvas_d).sum()
            if iscrowd[j]:
                denom = canvas_d.sum()
            else:
                denom = np.logical_or(canvas_g, canvas_d).sum()
            ious[i, j] = inter / max(denom, 1)
    return ious


def _evaluate_img(dts, gts, area_rng, max_det, iou_type="bbox"):
    """Match one (image, category): returns per-threshold dt matches/ignores
    + gt ignore mask, or None when empty."""
    if len(dts) == 0 and len(gts) == 0:
        return None
    gt_ignore = np.asarray(
        [g["_ignore"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]
         for g in gts], dtype=bool)
    # sort gts: non-ignored first (stable)
    g_order = np.argsort(gt_ignore, kind="stable")
    gts = [gts[i] for i in g_order]
    gt_ignore = gt_ignore[g_order]
    iscrowd = np.asarray([g["iscrowd"] for g in gts], dtype=bool)

    d_order = np.argsort([-d["score"] for d in dts], kind="stable")[:max_det]
    dts = [dts[i] for i in d_order]

    if iou_type == "segm":
        ious = _segm_iou(dts, gts, iscrowd)
    elif iou_type == "keypoints":
        ious = _kp_oks(dts, gts)
    else:
        ious = _bbox_iou_xywh(
            np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4),
            np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
            iscrowd)

    nt, nd, ng = len(IOU_THRS), len(dts), len(gts)
    dtm = -np.ones((nt, nd), np.int64)
    gtm = -np.ones((nt, ng), np.int64)
    dt_ignore = np.zeros((nt, nd), bool)
    for ti, t in enumerate(IOU_THRS):
        for di in range(nd):
            best = min(t, 1 - 1e-10)
            m = -1
            for gi in range(ng):
                if gtm[ti, gi] >= 0 and not iscrowd[gi]:
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m
            gtm[ti, m] = di
            dt_ignore[ti, di] = gt_ignore[m]
    # unmatched dts outside the area range are ignored; a det's area is its
    # mask's pixel count under segm (pycocotools loadRes sets ann['area'] =
    # maskUtils.area(segmentation)), its box's w*h under bbox and keypoints
    # (there the box of its keypoints' extents)
    d_area = np.asarray([d.get("area", d["bbox"][2] * d["bbox"][3])
                         for d in dts])
    out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
    dt_ignore |= (dtm < 0) & out_of_rng[None, :]
    return dict(
        scores=np.asarray([d["score"] for d in dts]),
        dt_matched=dtm >= 0,
        dt_ignore=dt_ignore,
        n_gt=int((~gt_ignore).sum()),
    )


def _accumulate(per_img_results):
    """per_img_results: list over images for ONE (category, area, maxdet).
    Returns (precision [T, R], recall [T])."""
    results = [r for r in per_img_results if r is not None]
    nt = len(IOU_THRS)
    precision = -np.ones((nt, len(REC_THRS)))
    recall = -np.ones(nt)
    if not results:
        return precision, recall
    scores = np.concatenate([r["scores"] for r in results])
    order = np.argsort(-scores, kind="mergesort")
    matched = np.concatenate([r["dt_matched"] for r in results], axis=1)[:, order]
    ignored = np.concatenate([r["dt_ignore"] for r in results], axis=1)[:, order]
    n_gt = sum(r["n_gt"] for r in results)
    if n_gt == 0:
        return precision, recall
    sorted_scores = scores[order]
    for ti in range(nt):
        tp = np.cumsum(matched[ti] & ~ignored[ti]).astype(np.float64)
        fp = np.cumsum(~matched[ti] & ~ignored[ti]).astype(np.float64)
        rc = tp / n_gt
        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        recall[ti] = rc[-1] if len(rc) else 0.0
        # monotone-decreasing envelope from the right
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        inds = np.searchsorted(rc, REC_THRS, side="left")
        q = np.zeros(len(REC_THRS))
        for ri, pi in enumerate(inds):
            if pi < len(pr):
                q[ri] = pr[pi]
        precision[ti] = q
    return precision, recall


class CocoEvaluator:
    """Evaluate predictions {image_id: dict(boxes xyxy, scores, labels
    [, mask_probs] [, keypoints])} against a COCODataset; ``iou_type``
    "bbox", "segm" or "keypoints"."""

    def __init__(self, dataset, iou_type: str = "bbox"):
        if iou_type not in IOU_TYPES:
            raise ValueError(f"unknown COCO iou type {iou_type!r}")
        self.dataset = dataset
        self.iou_type = iou_type
        kp = iou_type == "keypoints"
        self.area_rngs = KP_AREA_RNGS if kp else AREA_RNGS
        self.max_dets = KP_MAX_DETS if kp else MAX_DETS
        self.cat_ids = sorted(dataset.contiguous_category_id_to_json_id.values())
        self._img_hw = ({im["id"]: (im["height"], im["width"])
                         for im in dataset.images}
                        if iou_type == "segm" else {})

    def _gts_for(self, img_id, cat_id):
        out = []
        for a in self.dataset.eval_anns.get(img_id, []):
            if a["category_id"] != cat_id:
                continue
            area = a.get("area", a["bbox"][2] * a["bbox"][3])
            g = dict(bbox=a["bbox"], area=area,
                     iscrowd=bool(a.get("iscrowd", 0)),
                     _ignore=bool(a.get("iscrowd", 0))
                     or bool(a.get("ignore", 0)))
            seg = a.get("segmentation")
            if self.iou_type == "segm" and isinstance(seg, list):
                g["_mask"], g["_mask_offset"] = rasterize_polygons_crop(
                    seg, self._img_hw[img_id])
            elif self.iou_type == "keypoints":
                kps = np.asarray(a.get("keypoints", []),
                                 np.float64).reshape(-1, 3)
                g["_kps"] = kps
                # pycocotools: a GT with no labelled keypoint is
                # ignore-only
                nk = a.get("num_keypoints",
                           int((kps[:, 2] > 0).sum()) if len(kps) else 0)
                g["_ignore"] = g["_ignore"] or nk == 0
            out.append(g)
        return out

    def evaluate(self, predictions: dict):
        img_ids = [i for i in self.dataset.ids if i in predictions]
        # detections per (img, cat) in legacy xywh (+1) like the reference
        dts = {(i, c): [] for i in img_ids for c in self.cat_ids}
        for img_id in img_ids:
            p = predictions[img_id]
            boxes = np.asarray(p["boxes"], np.float64).reshape(-1, 4)
            mask_probs = p.get("mask_probs")
            for di, (b, s, l) in enumerate(zip(boxes, p["scores"],
                                               p["labels"])):
                json_cat = self.dataset.contiguous_category_id_to_json_id.get(
                    int(l))
                if json_cat is None:
                    continue
                xywh = [b[0], b[1], b[2] - b[0] + 1.0, b[3] - b[1] + 1.0]
                d = dict(bbox=xywh, score=float(s))
                if self.iou_type == "segm" and mask_probs is not None:
                    d["_mask"], d["_mask_offset"] = paste_single_crop(
                        np.asarray(mask_probs[di]), b, self._img_hw[img_id])
                    # a segm detection's area is its mask's pixel count
                    d["area"] = float(d["_mask"].sum())
                elif self.iou_type == "keypoints":
                    kp = np.asarray(p["keypoints"][di], np.float64)
                    d["_kps"] = kp
                    # pycocotools loadRes: the box of the keypoints' extents
                    x0, x1 = kp[:, 0].min(), kp[:, 0].max()
                    y0, y1 = kp[:, 1].min(), kp[:, 1].max()
                    d["bbox"] = [x0, y0, x1 - x0, y1 - y0]
                dts[(img_id, json_cat)].append(d)

        # stats[cat][area][maxdet] = (precision, recall)
        per_cat = {}
        for c in self.cat_ids:
            per_area = {}
            for aname, arng in self.area_rngs.items():
                for md in self.max_dets:
                    imgs = [_evaluate_img(dts[(i, c)], self._gts_for(i, c),
                                          arng, md, self.iou_type)
                            for i in img_ids]
                    per_area[(aname, md)] = _accumulate(imgs)
            per_cat[c] = per_area
        self._per_cat = per_cat
        return self.summarize()

    def _mean_ap(self, cats, area="all", max_det=None, thr=None):
        max_det = self.max_dets[-1] if max_det is None else max_det
        ps = []
        for c in cats:
            precision, _ = self._per_cat[c][(area, max_det)]
            p = precision if thr is None else precision[
                np.flatnonzero(np.isclose(IOU_THRS, thr))]
            valid = p[p > -1]
            if valid.size:
                ps.append(valid.mean())
        return float(np.mean(ps)) if ps else -1.0

    def _mean_ar(self, cats, area="all", max_det=None):
        max_det = self.max_dets[-1] if max_det is None else max_det
        rs = []
        for c in cats:
            _, recall = self._per_cat[c][(area, max_det)]
            valid = recall[recall > -1]
            if valid.size:
                rs.append(valid.mean())
        return float(np.mean(rs)) if rs else -1.0

    def summarize(self):
        cats = self.cat_ids
        res = OrderedDict()
        res["AP"] = self._mean_ap(cats)
        res["AP50"] = self._mean_ap(cats, thr=0.5)
        res["AP75"] = self._mean_ap(cats, thr=0.75)
        if self.iou_type == "keypoints":
            # the OKS protocol's metrics (pycocotools' keypoint summarize)
            res["APm"] = self._mean_ap(cats, area="medium")
            res["APl"] = self._mean_ap(cats, area="large")
            res["AR20"] = self._mean_ar(cats)
            res["ARm"] = self._mean_ar(cats, area="medium")
            res["ARl"] = self._mean_ar(cats, area="large")
        else:
            res["APs"] = self._mean_ap(cats, area="small")
            res["APm"] = self._mean_ap(cats, area="medium")
            res["APl"] = self._mean_ap(cats, area="large")
            res["AR1"] = self._mean_ar(cats, max_det=1)
            res["AR10"] = self._mean_ar(cats, max_det=10)
            res["AR100"] = self._mean_ar(cats, max_det=100)
        # per-category AP / AP50 (the DA fork's addition, coco_eval.py:62-66)
        per_cat = OrderedDict()
        for c in cats:
            name = self.dataset.cats[c]["name"] if c in self.dataset.cats else str(c)
            per_cat[name] = dict(AP=self._mean_ap([c]),
                                 AP50=self._mean_ap([c], thr=0.5))
        return res, per_cat


def do_coco_evaluation(dataset, predictions, output_folder=None,
                       iou_types=("bbox",)):
    unknown = set(iou_types) - set(IOU_TYPES)
    if unknown:
        raise ValueError(f"unknown COCO iou types {sorted(unknown)}")
    results = {}
    for iou_type in iou_types:
        evaluator = CocoEvaluator(dataset, iou_type)
        res, per_cat = evaluator.evaluate(predictions)
        log.info("COCO %s results: %s", iou_type,
                 "  ".join(f"{k}={v:.4f}" for k, v in res.items()))
        for name, r in per_cat.items():
            log.info("  %-16s AP=%.4f AP50=%.4f", name, r["AP"], r["AP50"])
        results[iou_type] = dict(res, per_category=per_cat)
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "coco_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results
