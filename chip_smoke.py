#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``da_detect_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. env       torch, CUDA and nvcc versions, the card's name and power limit
  2. build     both CUDA kernels, compiled from csrc/ for sm_90a
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the slice's shapes and on the CPU tests' edge cases
  4. slice     the flagship R-50-C4 config (its YAML) at the 608x1216 canvas
               in float32, random weights from a seed, answers 4 eval requests
               of batch 1 through ``entry()``; launch counts show the kernels
               ran; one request again with impl="plain" must agree
  5. times     kernel and plain times on the inputs the main path gave the
               kernels, the forward's latency and stages, peak memory
Then a line with every kernel's numbers, the nvidia-smi line of the card, and
last ``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. With no CUDA device it exits 1 at once.

Tolerances: NMS keep masks exactly; ROIAlign rtol = atol = 1e-5 (float32 sums
in another order); kernel-run against plain-run detections: the same valid
count, and each detection has a twin with the same label, boxes within
1e-2 pixels and scores within 1e-4 (the pooled features differ by float32
rounding, which the res5 head carries into the scores).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_YAML = os.path.join(
    REPO, "configs", "da_faster_rcnn",
    "e2e_triplet_da_faster_rcnn_R_50_C4_cityscapes_to_foggy_cityscapes.yaml")
# MIN/MAX_SIZE_TEST 600/1200, rounded up to DATALOADER.SIZE_DIVISIBILITY 32
CANVAS = (608, 1216)
REQUESTS = 4
# the slice's kernel shapes: RPN NMS 6000 -> 1000 at IoU 0.7, box-head NMS
# over 2048 candidates at IoU 0.3, ROIAlign of 1000 ROIs from the C4 map
RPN_NMS_BOXES, BOX_HEAD_NMS_BOXES = 6000, 2048
SLICE_ROIS, C4_CHANNELS = 1000, 1024
SCORE_SCALE = 30.0  # spreads random-init class scores, as the CPU tests do
ROI_TOL = dict(rtol=1e-5, atol=1e-5)
DET_BOX_ATOL, DET_SCORE_ATOL = 1e-2, 1e-4

# H100 SXM, published dense peaks (NVIDIA data sheet): HBM3 bytes a second,
# float32 operations a second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# operations a box pair costs in the IoU test, and a box its area
IOU_OPS, AREA_OPS = 16, 5
# ROIAlign: a multiply and an add for each of 4 corners, per channel sample
ROI_SAMPLE_OPS = 8

# launches a forward makes: NMS in the RPN and in the box head; ROIAlign in
# the box head
PER_FORWARD = {"nms": 2, "roi_align_fwd": 1}

SOURCES = {
    "nms": ("da_detect_tpu_torch/kernels/csrc/nms.cu",
            "da_detect_tpu/ops/nms_pallas.py:117"),
    "roi_align_fwd": ("da_detect_tpu_torch/kernels/csrc/roi_align_fwd.cu",
                      "da_detect_tpu/ops/roi_align_pallas.py:108"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls, CUDA events around
    each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, runs: int = 20, warmup: int = 2) -> float:
    """Median host time of ``fn`` ending in a synchronize (a request)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- inputs

def cluster_boxes(rng, b: int, n: int, hw) -> tuple[np.ndarray, np.ndarray]:
    """Heavily overlapping clusters over an h x w canvas (the RPN regime),
    in descending score order, with ~20% invalid rows interspersed."""
    h, w = hw
    out_boxes, out_valid = [], []
    for _ in range(b):
        centers = rng.uniform((20, 20), (w - 20, h - 20), (max(n // 16, 1), 2))
        c = centers[np.arange(n) % len(centers)] + rng.uniform(-20, 20, (n, 2))
        half = rng.uniform(10, 60, (n, 2))
        boxes = np.concatenate([c - half, c + half], 1).astype(np.float32)
        order = np.argsort(-rng.uniform(0, 1, n), kind="stable")
        out_boxes.append(boxes[order])
        out_valid.append(rng.rand(n) > 0.2)
    return np.stack(out_boxes), np.stack(out_valid)


def random_rois(rng, b: int, r: int, hw, max_side: float) -> np.ndarray:
    h, w = hw
    x1 = rng.uniform(-60, w, (b, r))
    y1 = rng.uniform(-60, h, (b, r))
    return np.stack([x1, y1, x1 + rng.uniform(2, max_side, (b, r)),
                     y1 + rng.uniform(2, max_side / 2, (b, r))],
                    -1).astype(np.float32)


# ---------------------------------------------------------------- bounds

def nms_work(valid: torch.Tensor, keep: torch.Tensor) -> tuple[float, float]:
    """(bytes, operations) greedy NMS needs on these inputs: boxes and valid
    read once, keep written once; an IoU test of every kept box against each
    valid box after it, and one area a valid box."""
    b, n = valid.shape
    v = valid.cpu().numpy().astype(np.int64)
    k = keep.cpu().numpy().astype(np.int64)
    after = np.cumsum(v[:, ::-1], axis=1)[:, ::-1] - v
    pairs = int((after * k).sum())
    return b * n * (16 + 1 + 1), IOU_OPS * pairs + AREA_OPS * int(v.sum())


def roi_align_work(features, rois, *, spatial_scale, output_size,
                   sampling_ratio, max_samples) -> tuple[float, float]:
    """(bytes, operations) ROIAlign needs on these inputs: the map and ROIs
    read once, the output written once; 8 flops a channel for each sample
    that lies in bounds, and the average."""
    from da_detect_tpu_torch.ops.roi_align import _roi_grid

    b, c, h, w = features.shape
    r, p = rois.shape[1], output_size
    s = sampling_ratio if sampling_ratio > 0 else max_samples
    start_h, start_w, bin_h, bin_w, grid_h, grid_w = _roi_grid(
        rois.float(), spatial_scale, p, sampling_ratio, max_samples)
    pos = torch.arange(p, dtype=torch.float32, device=rois.device)[:, None]
    idx = torch.arange(s, dtype=torch.float32, device=rois.device)

    def in_bounds(start, bin_size, grid, size):  # [B, R, P] samples a bin
        start, bin_size, grid = (t[..., None, None]
                                 for t in (start, bin_size, grid))
        coords = start + pos * bin_size + (idx + 0.5) * bin_size / grid
        ok = (idx < grid) & (coords >= -1.0) & (coords <= size)
        return ok.sum(-1).double()

    ny = in_bounds(start_h, bin_h, grid_h, h)
    nx = in_bounds(start_w, bin_w, grid_w, w)
    samples = float((ny[..., :, None] * nx[..., None, :]).sum())
    nbytes = 4 * (features.numel() + rois.numel() + b * r * p * p * c)
    return nbytes, ROI_SAMPLE_OPS * c * samples + b * r * p * p * c


# ---------------------------------------------------------------- checks

def check_nms(boxes, valid, thresh) -> tuple[int, torch.Tensor]:
    from da_detect_tpu_torch.ops import nms, nms_cuda

    got = nms_cuda.nms_mask_sorted(boxes, valid, thresh)
    want = nms.nms_mask_sorted(boxes, valid, thresh)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"NMS kernel keep mask differs from the plain "
                             f"version in {mismatches} of {got.numel()} rows "
                             f"(shape {tuple(boxes.shape)}, IoU {thresh})")
    return mismatches, got


def check_roi_align(features, rois, **kw) -> float:
    from da_detect_tpu_torch.ops import roi_align, roi_align_cuda

    got = roi_align_cuda.roi_align(features, rois, **kw)
    want = roi_align.roi_align(features, rois, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ROI_TOL)
    return float((got - want).abs().max()) if got.numel() else 0.0


def match_detections(a, b) -> dict:
    """Every valid detection of ``a`` has its own twin in ``b`` (same label,
    boxes and scores within tolerance) and the valid counts agree; raises
    otherwise. Near-tied scores may swap places, so order is not compared."""
    av, bv = a.valid[0].cpu(), b.valid[0].cpu()
    if int(av.sum()) != int(bv.sum()):
        raise AssertionError(f"kernel run kept {int(av.sum())} detections, "
                             f"plain run {int(bv.sum())}")
    boxes_a, boxes_b = a.boxes[0].cpu()[av], b.boxes[0].cpu()[bv]
    scores_a, scores_b = a.scores[0].cpu()[av], b.scores[0].cpu()[bv]
    labels_a, labels_b = a.labels[0].cpu()[av], b.labels[0].cpu()[bv]
    used = torch.zeros(len(labels_b), dtype=torch.bool)
    box_err = score_err = 0.0
    for i in range(len(labels_a)):
        d_box = (boxes_b - boxes_a[i]).abs().amax(dim=1)
        d_score = (scores_b - scores_a[i]).abs()
        ok = ((labels_b == labels_a[i]) & (d_box <= DET_BOX_ATOL)
              & (d_score <= DET_SCORE_ATOL) & ~used)
        if not bool(ok.any()):
            raise AssertionError(
                f"kernel-run detection {i} (label {int(labels_a[i])}, score "
                f"{float(scores_a[i]):.6f}) has no twin in the plain run")
        j = int(torch.nonzero(ok)[0])
        used[j] = True
        box_err = max(box_err, float(d_box[j]))
        score_err = max(score_err, float(d_score[j]))
    return dict(matched=int(used.sum()), max_box_err=box_err,
                max_score_err=score_err,
                same_order=bool(torch.equal(labels_a, labels_b)
                                and torch.equal(boxes_a, boxes_b)))


# ---------------------------------------------------------------- phases

def phase_env() -> str:
    from da_detect_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True
                         ).stdout.strip()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=[l for l in nvcc.splitlines() if "release" in l][0].strip(),
         nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from da_detect_tpu_torch import kernels

    t0 = time.perf_counter()
    reports = kernels.build()
    seconds = time.perf_counter() - t0
    for name in kernels.SOURCES:
        kernels.load(name)
    ptxas = {name: [l.strip() for l in log.splitlines()
                    if "registers" in l or "spill" in l]
             for name, log in reports.items()}
    emit("build", seconds=seconds, built=sorted(reports), ptxas=ptxas)


def phase_kernels(dev) -> dict:
    """Kernel against plain on the card: synthetic inputs at the slice's
    shapes, then the CPU tests' edge cases. Returns the largest errors."""
    rng = np.random.RandomState(0)
    results = {}

    def nms_case(name, boxes, valid, thresh):
        boxes = torch.from_numpy(boxes).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        mism, keep = check_nms(boxes, valid, thresh)
        results[name] = dict(mismatches=mism, kept=int(keep.sum()),
                             shape=list(boxes.shape), iou=thresh)

    # RPN: 6000 -> NMS at 0.7, two images
    nms_case("nms_rpn", *cluster_boxes(rng, 2, RPN_NMS_BOXES, CANVAS), 0.7)
    # box head: 2048 candidates, 8 classes by coordinate offset, NMS at 0.3
    boxes, valid = cluster_boxes(rng, 1, BOX_HEAD_NMS_BOXES, CANVAS)
    cls = rng.randint(1, 9, (1, BOX_HEAD_NMS_BOXES)).astype(np.float32)
    unit = boxes.max() + 1.0
    nms_case("nms_box_head", (boxes + cls[..., None] * unit).astype(
        np.float32), valid, 0.3)
    # edges: one box, a ragged 64-block, all invalid, three images
    nms_case("nms_n1", *cluster_boxes(rng, 1, 1, CANVAS), 0.5)
    nms_case("nms_n65_b3", *cluster_boxes(rng, 3, 65, (120, 160)), 0.5)
    b, _ = cluster_boxes(rng, 1, 300, (120, 160))
    nms_case("nms_all_invalid", b, np.zeros((1, 300), bool), 0.5)

    def roi_case(name, feats_nhwc, rois, **kw):
        feats = torch.from_numpy(feats_nhwc).to(dev).permute(0, 3, 1, 2)
        err = check_roi_align(feats, torch.from_numpy(rois).to(dev), **kw)
        results[name] = dict(max_abs_err=err, features=list(feats.shape),
                             rois=list(rois.shape), **kw)

    c4 = (CANVAS[0] // 16, CANVAS[1] // 16)
    kw14 = dict(spatial_scale=1.0 / 16, output_size=14, sampling_ratio=0)
    roi_case("roi_slice", rng.randn(1, *c4, C4_CHANNELS).astype(np.float32),
             random_rois(rng, 1, SLICE_ROIS, CANVAS, 900.0), max_samples=8,
             **kw14)
    roi_case("roi_p7_s2_r11",
             rng.randn(2, 10, 16, 128).astype(np.float32),
             random_rois(rng, 2, 11, (160, 256), 80.0), spatial_scale=1 / 16,
             output_size=7, sampling_ratio=2, max_samples=8)
    oob = np.asarray([[[-40.0, -30.0, 60.0, 50.0], [200.0, 120.0, 300.0, 200.0],
                       [-100.0, -100.0, -50.0, -50.0], [1e4, 1e4, 2e4, 2e4],
                       [30.0, 40.0, 30.0, 40.0], [80.0, 90.0, 20.0, 10.0],
                       [-16.0, 0.0, 256.0, 160.0]]], np.float32)
    for sr in (2, 0):
        roi_case(f"roi_out_of_bounds_s{sr}",
                 rng.randn(1, 10, 16, 16).astype(np.float32), oob,
                 spatial_scale=1 / 16, output_size=7, sampling_ratio=sr,
                 max_samples=8)
    wide = np.asarray([[[2.0, 2.0, 1210.0, 600.0], [0.0, 100.0, 1216.0, 180.0],
                        [30.0, 40.0, 200.0, 300.0],
                        [-400.0, 0.0, 2400.0, 600.0]]], np.float32)
    for cap in (8, 4):
        roi_case(f"roi_wide_cap{cap}", rng.randn(1, *c4, 8).astype(np.float32),
                 wide, max_samples=cap, **kw14)
    emit("kernels", **results)
    return dict(
        nms=max(r["mismatches"] for k, r in results.items()
                if k.startswith("nms")),
        roi_align_fwd=max(r["max_abs_err"] for k, r in results.items()
                          if k.startswith("roi")))


def flagship_model(dev):
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP_YAML)
    cfg.TPU.IMAGE_SHAPE = CANVAS
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg)
    with torch.no_grad():
        model.rpn["head"].cls_logits.weight.mul_(SCORE_SCALE)
        model.roi_heads["box"]["predictor"].cls_score.weight.mul_(SCORE_SCALE)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    return cfg, fn, model, batches


def capture_kernel_inputs(fn, model, batch):
    """One request with each kernel wrapper's inputs recorded on the way:
    the kernels' inputs as the main path gives them."""
    from da_detect_tpu_torch.ops import nms_cuda, roi_align_cuda

    captured = {"nms": [], "roi_align_fwd": []}
    nms_kernel, roi_kernel = nms_cuda.nms_mask_sorted, roi_align_cuda.roi_align

    def nms_rec(boxes, valid, thresh):
        captured["nms"].append((boxes.clone(), valid.clone(), thresh))
        return nms_kernel(boxes, valid, thresh)

    def roi_rec(features, rois, **kw):
        captured["roi_align_fwd"].append((features.clone(), rois.clone(), kw))
        return roi_kernel(features, rois, **kw)

    nms_cuda.nms_mask_sorted, roi_align_cuda.roi_align = nms_rec, roi_rec
    try:
        dets = fn(model, batch)
    finally:
        nms_cuda.nms_mask_sorted, roi_align_cuda.roi_align = (nms_kernel,
                                                              roi_kernel)
    return dets, captured


def phase_slice(dev):
    from da_detect_tpu_torch import kernels

    cfg, fn, model, batches = flagship_model(dev)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    answers = [fn(model, b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in kernels.SOURCES}
    for name, n in PER_FORWARD.items():
        if launches[name] != n * REQUESTS:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times in {REQUESTS} requests, expected "
                                 f"{n * REQUESTS}")
    summary = []
    for dets in answers:
        if tuple(dets.boxes.shape) != (1, cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                                       4):
            raise AssertionError(f"detections {tuple(dets.boxes.shape)}")
        if not (torch.isfinite(dets.boxes).all()
                and torch.isfinite(dets.scores).all()):
            raise AssertionError("non-finite detections")
        n_valid = int(dets.valid.sum())
        if n_valid == 0:
            raise AssertionError("a request returned no detection")
        summary.append(dict(valid=n_valid,
                            top_score=float(dets.scores.max()),
                            labels=sorted(set(dets.labels[dets.valid]
                                              .tolist()))))

    dets_k, captured = capture_kernel_inputs(fn, model, batches[0])
    rerun_identical = all(torch.equal(x, y)
                          for x, y in zip(dets_k, answers[0]))
    dets_p = model(batches[0], impl="plain")
    agreement = match_detections(dets_k, dets_p)
    # the main path's own kernel inputs, kernel against plain
    errs = {"nms": 0, "roi_align_fwd": 0.0}
    for boxes, valid, thresh in captured["nms"]:
        errs["nms"] = max(errs["nms"], check_nms(boxes, valid, thresh)[0])
    for feats, rois, kw in captured["roi_align_fwd"]:
        errs["roi_align_fwd"] = max(errs["roi_align_fwd"],
                                    check_roi_align(feats, rois, **kw))
    emit("slice", config=os.path.relpath(FLAGSHIP_YAML, REPO),
         canvas=list(CANVAS), requests=REQUESTS, seconds=seconds,
         launches=launches, detections=summary,
         rerun_identical=rerun_identical, plain_agreement=agreement,
         main_path_inputs={
             "nms": [dict(shape=list(b.shape), iou=t, valid=int(v.sum()))
                     for b, v, t in captured["nms"]],
             "roi_align_fwd": [dict(features=list(f.shape),
                                    rois=list(r.shape), **kw)
                               for f, r, kw in captured["roi_align_fwd"]]},
         max_abs_err=errs)
    return model, fn, batches, captured, launches, errs


def stage_times(model, batch, runs: int = 10) -> dict:
    """Median device time of each stage of the forward, from CUDA events
    recorded by module hooks."""
    box = model.roi_heads["box"]
    marks = [("backbone", model.backbone), ("rpn_head", model.rpn["head"]),
             ("extractor", box["feature_extractor"]),
             ("res5_head", box["feature_extractor"].head),
             ("predictor", box["predictor"])]
    events: dict[str, torch.cuda.Event] = {}

    def rec(key):
        def hook(*_):
            events[key] = torch.cuda.Event(enable_timing=True)
            events[key].record()
        return hook

    handles = []
    for name, mod in marks:
        handles.append(mod.register_forward_pre_hook(rec(name + ".in")))
        handles.append(mod.register_forward_hook(rec(name + ".out")))
    spans = {"normalize": ("start", "backbone.in"),
             "backbone": ("backbone.in", "backbone.out"),
             "rpn_head": ("rpn_head.in", "rpn_head.out"),
             "proposals_with_nms": ("rpn_head.out", "extractor.in"),
             "roi_align": ("extractor.in", "res5_head.in"),
             "res5_head": ("res5_head.in", "res5_head.out"),
             "predictor": ("predictor.in", "predictor.out"),
             "postprocess_with_nms": ("predictor.out", "end")}
    samples = {k: [] for k in spans}
    try:
        for i in range(runs + 2):
            rec("start")()
            model(batch)
            rec("end")()
            torch.cuda.synchronize()
            if i >= 2:
                for k, (a, b) in spans.items():
                    samples[k].append(events[a].elapsed_time(events[b]))
    finally:
        for h in handles:
            h.remove()
    return {k: statistics.median(v) for k, v in samples.items()}


def phase_times(model, fn, batches, captured) -> list:
    from da_detect_tpu_torch.ops import nms, nms_cuda, roi_align, roi_align_cuda

    sites = []
    for (boxes, valid, thresh), site in zip(captured["nms"],
                                            ("rpn", "box_head")):
        keep = nms_cuda.nms_mask_sorted(boxes, valid, thresh)
        nbytes, ops = nms_work(valid, keep)
        bound_ms, by = bound(nbytes, ops)
        sites.append(dict(
            kernel="nms", site=site, shape=list(boxes.shape), iou=thresh,
            kept=int(keep.sum()), bytes=nbytes, operations=ops,
            ms=time_ms(lambda: nms_cuda.nms_mask_sorted(boxes, valid, thresh)),
            plain_ms=time_ms(lambda: nms.nms_mask_sorted(boxes, valid, thresh),
                             runs=20),
            bound_ms=bound_ms, bound_by=by))
    for feats, rois, kw in captured["roi_align_fwd"]:
        nbytes, ops = roi_align_work(feats, rois, **kw)
        bound_ms, by = bound(nbytes, ops)
        sites.append(dict(
            kernel="roi_align_fwd", site="box_head", features=list(feats.shape),
            rois=list(rois.shape), bytes=nbytes, operations=ops,
            ms=time_ms(lambda: roi_align_cuda.roi_align(feats, rois, **kw)),
            plain_ms=time_ms(lambda: roi_align.roi_align(feats, rois, **kw),
                             runs=20),
            bound_ms=bound_ms, bound_by=by))
    batch = batches[0]
    forward_ms = host_ms(lambda: fn(model, batch))
    forward_plain_ms = host_ms(lambda: model(batch, impl="plain"))
    stages = stage_times(model, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(model, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("times", sites=sites, forward_ms=forward_ms,
         forward_plain_ms=forward_plain_ms, stages_ms=stages,
         max_memory_allocated=peak)
    return sites


def kernel_line(sites, launches, errs) -> dict:
    rows = []
    for name, (source, replaces) in SOURCES.items():
        mine = [s for s in sites if s["kernel"] == name]
        nbytes = sum(s["bytes"] for s in mine)
        ops = sum(s["operations"] for s in mine)
        bound_ms, by = bound(nbytes, ops)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], launches_per_forward=PER_FORWARD[name],
            max_abs_err=errs[name],
            # one forward's launches of the kernel, summed over call sites
            ms=sum(s["ms"] for s in mine),
            plain_ms=sum(s["plain_ms"] for s in mine),
            bound_ms=bound_ms, bound_by=by, library_ms=None,
            sites=[{k: s[k] for k in ("site", "ms", "plain_ms", "bound_ms",
                                      "bound_by")} for s in mine]))
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_env()
    phase_build()
    synthetic_errs = phase_kernels(dev)
    model, fn, batches, captured, launches, errs = phase_slice(dev)
    errs = {k: max(v, synthetic_errs[k]) for k, v in errs.items()}
    sites = phase_times(model, fn, batches, captured)
    print(json.dumps(kernel_line(sites, launches, errs)))
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
