#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``da_detect_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. env       torch, CUDA and nvcc versions, the card's name and power limit
  2. build     the five CUDA kernels, compiled from csrc/ for sm_90a
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main paths' shapes and on edge cases (NMS: 1 to 12000
               boxes, invalid rows, a ragged batch, max_keep truncation;
               ROIAlign forward: ROIs off the map, wide ones, the whole C4
               map at cap 8, and one level-aware launch over the DCN
               pooler's 4 maps, with a level that gets no ROI, two images
               and no ROI; ROIAlign backward: whole C4 and P2 maps, map
               edges, C = 4 and 12, a map that needs more than 48 KB a
               block, a strided gradient)
  4. slice     the flagship R-50-C4 config (its YAML) at the 608x1216 canvas
               in float32, random weights from a seed, answers 4 eval requests
               of batch 1 through ``entry()``; launch counts show the kernels
               ran; one request again with impl="plain" must agree
  5. times     kernel and plain times on the inputs the eval path gave the
               kernels (NMS also split into its mask launch and its walk by
               torch.profiler), the forward's latency and stages, peak memory
  6. train     the flagship triplet-DA train step through ``train_entry()``:
               kernel-run against plain-run step 1, timed steps with launch
               counts, the step's split and profile, 2 aligned steps
  7. train_times  kernel and plain times on the train path's kernel inputs,
               with the NMS split
  8. dcn       the X-101-32x8d-FPN-DCN YAML at 608x1216 in float32 through
               ``entry(cfg=dcn_cfg())``: 4 requests with exact launch counts
               (row_gather 270 a forward, NMS 6, ROIAlign 1: each ROI from
               its own level of P2-P5), one request with
               impl="plain" and one with TPU.DCN_GATHER "quad" (row_gather_bulk
               270) that must agree with it
  9. dcn_times  each gather's kernel, plain and ``torch.index_select`` device
               times on the path's inputs, summed a forward, from 3
               profiles taken in turns (median and spread), with the byte
               bound; forward latency, stage split, profile, the pooler's
               device time and peak memory
Each ROIAlign-forward site of phases 5, 7 and 9 also gives its kernel's
device time (profiler), the corner bytes that the per-thread gather it
replaced read through L2, and the ROIs' footprint bytes the kernel stages.
Then a line with every kernel's numbers, the nvidia-smi line of the card, and
last ``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. With no CUDA device it exits 1 at once.

Tolerances: NMS keep masks exactly, truncated ones (``max_keep``) too;
ROIAlign rtol = atol = 1e-5 (float32 sums in another order), its backward
1e-5 of max |dF|; the row gathers bit for bit (copies); kernel-run against
plain-run detections, and "quad" against "four": the same valid count, and
each detection has a twin with the same label, boxes within 1e-2 pixels and
scores within 1e-4 (the pooled features differ by float32 rounding, which
the box head carries into the scores).
"""

from __future__ import annotations

import contextlib
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
# launches a train step makes: NMS in the source's and the positive target's
# RPN; ROIAlign forward and backward in their box-head passes; the aligned
# variant (instance triplet on) re-pools the source and negative members too
PER_TRAIN_STEP = {"nms": 2, "roi_align_fwd": 2, "roi_align_bwd": 2}
PER_ALIGNED_STEP = {"nms": 2, "roi_align_fwd": 4, "roi_align_bwd": 4}
TRAIN_STEPS, ALIGNED_STEPS, SPLIT_STEPS, PROFILE_STEPS = 6, 2, 5, 3
# the train step's kernel shapes: RPN NMS 12000 -> 2000 at IoU 0.7, ROIAlign
# of the 256 sampled ROIs an image
TRAIN_NMS_BOXES, TRAIN_ROIS = 12000, 256
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-6
ROI_BWD_REL = 1e-5

# the DCN model: launches a forward makes. A row gather a tap of each of the
# 30 deformable convs (res3 4, res4 23, res5 3 blocks; 9 taps); NMS in the
# RPN's 5 levels (P2-P6) and the box head; ROIAlign from P2-P5, each ROI
# from its own level, in one launch
PER_DCN_FORWARD = {"row_gather": 270, "nms": 6, "roi_align_fwd": 1}
PER_QUAD_FORWARD = {"row_gather_bulk": 270, "nms": 6, "roi_align_fwd": 1}
# conv_offset kernels drawn from this seed, each scaled so that its offsets
# have this standard deviation (pixels): samples spread over about +-2 px
DCN_SEED, DCN_OFFSET_STD = 0, 1.0
DCN_PROFILE_RUNS, GATHER_TIMING_RUNS, GATHER_PROFILES = 3, 10, 3
# calls of each NMS and ROIAlign site under torch.profiler for the device
# time of its kernels (NMS: the mask launch and the walk apart), and of the
# DCN model's whole pooler
KERNEL_PROFILE_RUNS = 10
# the DCN pooler's maps at 608x1216 (P2-P5) and scales
FPN_SHAPES = ((152, 304), (76, 152), (38, 76), (19, 38))
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
# row gathers against the plain version at the DCN path's shapes, 608x1216:
# name -> (S table rows, C, P indices, row stride or None)
GATHER_CASES = {
    "probe": (76 * 152, 512, 4 * 76 * 152, None),  # the TPU probe's own shape
    "res3_block0": (152 * 304, 512, 4 * 76 * 152, None),  # stride-2 conv2
    "res4_block0": (76 * 152, 1024, 4 * 38 * 76, None),
    "res4": (38 * 76, 1024, 4 * 38 * 76, None),
    "res5_block0": (38 * 76, 2048, 4 * 19 * 38, None),
    "res5": (19 * 38, 2048, 4 * 19 * 38, None),
    "quad_res3": (76 * 152 - 1 - 152, 4 * 512, 76 * 152, None),
    "quad_res3_block0": (152 * 304 - 1 - 304, 4 * 512, 76 * 152, None),
    "c6_scalar": (50, 6, 333, None),        # rows of 24 B: no 16-byte vectors
    "column_slice": (40, 16, 257, 48),      # one deformable group's columns
    "empty": (10, 8, 0, None),
}
GATHER_BF16_CASES = ("probe", "quad_res3", "column_slice")

SOURCES = {
    "nms": ("da_detect_tpu_torch/kernels/csrc/nms.cu",
            "da_detect_tpu/ops/nms_pallas.py:117"),
    "roi_align_fwd": ("da_detect_tpu_torch/kernels/csrc/roi_align_fwd.cu",
                      "da_detect_tpu/ops/roi_align_pallas.py:108"),
    "roi_align_bwd": ("da_detect_tpu_torch/kernels/csrc/roi_align_bwd.cu",
                      "da_detect_tpu/ops/roi_align_pallas.py:138"),
    "row_gather": ("da_detect_tpu_torch/kernels/csrc/row_gather.cu",
                   "scripts/bench_gather_pallas.py:35"),
    "row_gather_bulk": ("da_detect_tpu_torch/kernels/csrc/row_gather_bulk.cu",
                        "scripts/bench_gather_pallas.py:75"),
}
# the path whose run gives each kernel's launches and times in the last line
MAIN_PATH = {"nms": "train", "roi_align_fwd": "train",
             "roi_align_bwd": "train", "row_gather": "dcn",
             "row_gather_bulk": "dcn_quad"}


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


def fpn_inputs(rng, b: int, r: int, c: int, dev, empty_level=None):
    """The DCN pooler's 4 maps (random, channels-last), ROIs of 4 to 700
    pixels a side over the canvas and their levels by FPN's rule; with
    ``empty_level``, the ROIs of that level are dropped."""
    from da_detect_tpu_torch.models import poolers

    maps = [torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(
        dev).permute(0, 3, 1, 2) for h, w in FPN_SHAPES]
    side = np.exp(rng.uniform(np.log(4), np.log(700), (b, 3 * r, 2)))
    xy = rng.uniform(-50, (CANVAS[1], CANVAS[0]), (b, 3 * r, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).astype(
        np.float32))
    levels = poolers.assign_levels(rois, 2, 5)
    if empty_level is not None:
        keep = (levels != empty_level).all(0)
        rois, levels = rois[:, keep], levels[:, keep]
    return maps, rois[:, :r].to(dev), levels[:, :r].to(dev)


# ---------------------------------------------------------------- bounds

def nms_stops(keep: torch.Tensor, max_keep) -> np.ndarray:
    """Where greedy NMS ends in each image: after the max_keep-th kept box
    where the image has that many, else after its last box."""
    k = keep.cpu().numpy()
    stops = np.full(k.shape[0], k.shape[1])
    if max_keep:
        for i, row in enumerate(k):
            if row.sum() == max_keep:
                stops[i] = np.flatnonzero(row)[-1] + 1
    return stops


def nms_work(valid: torch.Tensor, keep: torch.Tensor,
             max_keep) -> tuple[float, float]:
    """(bytes, operations) greedy NMS needs on these inputs, each image up
    to its stop (``nms_stops``): the boxes and valid rows up to there read
    once, keep written once; an IoU test of every kept box against each
    valid box after it up to the stop, and one area a valid box there."""
    b, n = valid.shape
    stops = nms_stops(keep, max_keep)
    v = valid.cpu().numpy().astype(np.int64) * (np.arange(n) < stops[:, None])
    k = keep.cpu().numpy().astype(np.int64)
    after = np.cumsum(v[:, ::-1], axis=1)[:, ::-1] - v
    pairs = int((after * k).sum())
    return (int(stops.sum()) * (16 + 1) + b * n,
            IOU_OPS * pairs + AREA_OPS * int(v.sum()))


def roi_align_geometry(height, width, rois, *, spatial_scale, output_size,
                       sampling_ratio, max_samples):
    """Per ROI [B, R] (float64): the samples that lie in bounds on this map,
    and its footprint, the pixels of the rectangle of rows and columns its
    in-bounds samples' corners reach."""
    from da_detect_tpu_torch.ops.roi_align import _roi_grid

    p = output_size
    s = sampling_ratio if sampling_ratio > 0 else max_samples
    start_h, start_w, bin_h, bin_w, grid_h, grid_w = _roi_grid(
        rois.float(), spatial_scale, p, sampling_ratio, max_samples)
    pos = torch.arange(p, dtype=torch.float32, device=rois.device)[:, None]
    idx = torch.arange(s, dtype=torch.float32, device=rois.device)

    def axis(start, bin_size, grid, size):
        start, bin_size, grid = (t[..., None, None]
                                 for t in (start, bin_size, grid))
        coords = start + pos * bin_size + (idx + 0.5) * bin_size / grid
        ok = (idx < grid) & (coords >= -1.0) & (coords <= size)
        lo = torch.floor(coords.clamp(0.0, size - 1.0)).double()
        hi = (lo + 1).clamp(max=size - 1)
        first = torch.where(ok, lo, np.inf).amin((-1, -2))
        last = torch.where(ok, hi, -np.inf).amax((-1, -2))
        return ok.sum(-1).double(), (last - first + 1).clamp(min=0)

    ny, span_y = axis(start_h, bin_h, grid_h, height)
    nx, span_x = axis(start_w, bin_w, grid_w, width)
    return (ny[..., :, None] * nx[..., None, :]).sum((-1, -2)), span_y * span_x


def roi_align_work(maps, rois, levels, kw) -> dict:
    """What ROIAlign needs on these inputs: ``bytes`` (the maps, ROIs and
    levels read once, the output written once) and ``operations`` (8 a
    channel for each in-bounds sample of each ROI on its own level, and the
    average); ``old_l2_bytes``, the corner reads the per-thread gather that
    the forward kernel replaced made through L2 (4 corners of C floats an
    in-bounds sample; with several maps it pooled every ROI from every one
    of them); ``footprint_bytes``, the ROIs' footprints on their own maps
    (C floats a pixel), which the forward kernel stages in shared memory.
    ``maps``: (B, C, H, W) of each map; ``levels`` None for one map; ``kw``:
    the wrapper's keywords (``spatial_scale`` or ``scales``). The backward
    moves the same bytes (the gradient read once, dF written once) and does
    the same operations (a multiply and an add into each of 4 corners)."""
    b, c = maps[0][:2]
    r, p = rois.shape[1], kw["output_size"]
    scales = kw["scales"] if levels is not None else (kw["spatial_scale"],)
    geo = dict(output_size=p, sampling_ratio=kw["sampling_ratio"],
               max_samples=kw["max_samples"])
    own_samples = own_footprint = 0.0
    all_samples = 0.0
    for i, (shape, scale) in enumerate(zip(maps, scales)):
        samples, footprint = roi_align_geometry(
            shape[2], shape[3], rois, spatial_scale=scale, **geo)
        own = torch.ones_like(samples) if levels is None \
            else (levels == i).double()
        own_samples += float((samples * own).sum())
        own_footprint += float((footprint * own).sum())
        all_samples += float(samples.sum())
    nbytes = 4 * (sum(m[0] * m[1] * m[2] * m[3] for m in maps) + rois.numel()
                  + b * r * p * p * c)
    if levels is not None:
        nbytes += 8 * levels.numel()
    return dict(bytes=nbytes,
                operations=ROI_SAMPLE_OPS * c * own_samples + b * r * p * p * c,
                old_l2_bytes=4 * 4 * c * all_samples,
                footprint_bytes=4 * c * own_footprint)


# ---------------------------------------------------------------- checks

def check_nms(boxes, valid, thresh,
              max_keep=None) -> tuple[int, torch.Tensor]:
    from da_detect_tpu_torch.ops import nms, nms_cuda

    got = nms_cuda.nms_mask_sorted(boxes, valid, thresh, max_keep)
    want = nms.nms_mask_sorted(boxes, valid, thresh, max_keep)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"NMS kernel keep mask differs from the plain "
                             f"version in {mismatches} of {got.numel()} rows "
                             f"(shape {tuple(boxes.shape)}, IoU {thresh}, "
                             f"max_keep {max_keep})")
    return mismatches, got


def fwd_call(maps, rois, levels, kw, plain: bool = False):
    """The forward kernel's wrapper (or with ``plain`` its plain version) on
    one captured input: one map, or several with each ROI's level."""
    from da_detect_tpu_torch.ops import roi_align, roi_align_cuda

    if levels is None:
        fn = roi_align.roi_align if plain else roi_align_cuda.roi_align_forward
        return fn(maps[0], rois, **kw)
    fn = roi_align.roi_align_levels if plain \
        else roi_align_cuda.roi_align_levels_forward
    return fn(maps, rois, levels, **kw)


def check_roi_align_fwd(maps, rois, levels, kw) -> float:
    """The forward kernel against its plain version, one map or several."""
    got = fwd_call(maps, rois, levels, kw)
    want = fwd_call(maps, rois, levels, kw, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ROI_TOL)
    return float((got - want).abs().max()) if got.numel() else 0.0


def fwd_inputs(captured) -> list:
    """A summary of each captured forward input, for the phase lines."""
    out = []
    for maps, rois, levels, kw in captured["roi_align_fwd"]:
        row = dict(features=[list(m.shape) for m in maps],
                   rois=list(rois.shape), **kw)
        if levels is not None:
            row["rois_a_level"] = [int((levels == i).sum())
                                   for i in range(len(maps))]
        out.append(row)
    return out


def check_roi_align_backward(rois, grad, height, width,
                             **kw) -> tuple[float, float]:
    """Backward kernel against autograd of the plain version
    (``roi_align_grad``); raises past ROI_BWD_REL of the largest |dF|.
    Returns (max abs error, max |dF|)."""
    from da_detect_tpu_torch.ops import roi_align, roi_align_cuda

    got = roi_align_cuda.roi_align_backward(grad, rois, height=height,
                                            width=width, **kw)
    want = roi_align.roi_align_grad(grad, rois, height=height, width=width,
                                    **kw)
    torch.cuda.synchronize()
    if not want.numel():
        return 0.0, 0.0
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= ROI_BWD_REL * scale:
        raise AssertionError(f"ROIAlign backward kernel differs from the "
                             f"plain version by {err:.3e} (max |dF| "
                             f"{scale:.3e}, grad {tuple(grad.shape)})")
    return err, scale


def check_gather(name: str, table, idx) -> float:
    """The named gather kernel against the plain version: bit for bit."""
    from da_detect_tpu_torch.ops import gather, gather_cuda

    got = getattr(gather_cuda, name)(table, idx)
    want = gather.row_gather(table, idx)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).any(-1).sum()) if got.shape == want.shape \
            else "all"
        raise AssertionError(f"gather kernel {name} differs from the plain "
                             f"version in {bad} of {idx.numel()} rows (table "
                             f"{tuple(table.shape)} {table.dtype})")
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


@contextlib.contextmanager
def record_kernel_inputs():
    """While open, each kernel wrapper's inputs are recorded on the way (the
    kernels' inputs as a main path gives them): yields a dict kernel name ->
    list of inputs (ROIAlign forward: the maps, ROIs, levels or None, and
    the keywords of the one-level or the level-aware wrapper). A gather's table is kept by reference (no copy): the
    forward writes no tensor in place."""
    from da_detect_tpu_torch.ops import gather_cuda, nms_cuda, roi_align_cuda

    captured = {name: [] for name in SOURCES}
    nms_kernel = nms_cuda.nms_mask_sorted
    fwd_kernel = roi_align_cuda.roi_align_forward
    levels_kernel = roi_align_cuda.roi_align_levels_forward
    bwd_kernel = roi_align_cuda.roi_align_backward
    gathers = {name: getattr(gather_cuda, name)
               for name in ("row_gather", "row_gather_bulk")}

    def gather_rec(name):
        def rec(table, idx):
            captured[name].append((table, idx.clone()))
            return gathers[name](table, idx)
        return rec

    def nms_rec(boxes, valid, thresh, max_keep=None):
        captured["nms"].append((boxes.clone(), valid.clone(), thresh,
                                max_keep))
        return nms_kernel(boxes, valid, thresh, max_keep)

    def fwd_rec(features, rois, **kw):
        captured["roi_align_fwd"].append(([features.detach().clone()],
                                          rois.clone(), None, kw))
        return fwd_kernel(features, rois, **kw)

    def levels_rec(features, rois, levels, **kw):
        captured["roi_align_fwd"].append((
            [f.detach().clone() for f in features], rois.clone(),
            levels.clone(), kw))
        return levels_kernel(features, rois, levels, **kw)

    def bwd_rec(grad, rois, *, height, width, **kw):
        # the clone keeps the gradient's strides; and whether the kernel
        # wrapper reads it in place or copies it
        captured["roi_align_bwd"].append((
            grad.clone(), rois.clone(), height, width, kw,
            roi_align_cuda.grad_view(grad)[1]))
        return bwd_kernel(grad, rois, height=height, width=width, **kw)

    nms_cuda.nms_mask_sorted = nms_rec
    roi_align_cuda.roi_align_forward = fwd_rec
    roi_align_cuda.roi_align_levels_forward = levels_rec
    roi_align_cuda.roi_align_backward = bwd_rec
    for name in gathers:
        setattr(gather_cuda, name, gather_rec(name))
    try:
        yield captured
    finally:
        nms_cuda.nms_mask_sorted = nms_kernel
        roi_align_cuda.roi_align_forward = fwd_kernel
        roi_align_cuda.roi_align_levels_forward = levels_kernel
        roi_align_cuda.roi_align_backward = bwd_kernel
        for name, fn in gathers.items():
            setattr(gather_cuda, name, fn)


def check_captured(captured) -> dict:
    """Each kernel against its plain version on a main path's own inputs
    (``captured`` from ``record_kernel_inputs``): the largest error a
    kernel."""
    errs = {}
    for boxes, valid, thresh, max_keep in captured["nms"]:
        errs["nms"] = max(errs.get("nms", 0),
                          check_nms(boxes, valid, thresh, max_keep)[0])
    for maps, rois, levels, kw in captured["roi_align_fwd"]:
        errs["roi_align_fwd"] = max(errs.get("roi_align_fwd", 0.0),
                                    check_roi_align_fwd(maps, rois, levels,
                                                        kw))
    for grad, rois, h, w, kw, _ in captured["roi_align_bwd"]:
        errs["roi_align_bwd"] = max(
            errs.get("roi_align_bwd", 0.0),
            check_roi_align_backward(rois, grad, h, w, **kw)[0])
    for name in ("row_gather", "row_gather_bulk"):
        for table, idx in captured[name]:
            errs[name] = max(errs.get(name, 0.0),
                             check_gather(name, table, idx))
    return errs


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

    def nms_case(name, boxes, valid, thresh, max_keep=None):
        boxes = torch.from_numpy(boxes).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        mism, keep = check_nms(boxes, valid, thresh, max_keep)
        results[name] = dict(mismatches=mism, kept=int(keep.sum()),
                             shape=list(boxes.shape), iou=thresh,
                             max_keep=max_keep)

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
    nms_case("nms_n63_b2", *cluster_boxes(rng, 2, 63, (120, 160)), 0.7)
    nms_case("nms_n64_b2", *cluster_boxes(rng, 2, 64, (120, 160)), 0.3)
    # a ragged batch: all, about half and none of the boxes valid
    boxes, valid = cluster_boxes(rng, 3, 1000, CANVAS)
    valid[0], valid[1], valid[2] = True, rng.rand(1000) > 0.5, False
    nms_case("nms_ragged_b3", boxes, valid, 0.5)
    # the train RPN's shape, whole and stopped after k kept (nms_topk's
    # max_keep; k past the survivors gives the whole mask)
    boxes, valid = cluster_boxes(rng, 1, TRAIN_NMS_BOXES, CANVAS)
    nms_case("nms_train", boxes, valid, 0.7)
    for k in (1, 100, 2000, TRAIN_NMS_BOXES + 1):
        nms_case(f"nms_train_max_keep_{k}", boxes, valid, 0.7, max_keep=k)
    # nms_topk through the kernel's early stop against the top k of the
    # plain version's whole mask
    from da_detect_tpu_torch.ops import nms

    boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(
        valid).to(dev)
    scores = torch.linspace(1.0, 0.0, TRAIN_NMS_BOXES, device=dev)[None]
    whole = nms.nms_mask_sorted(boxes, valid, 0.7)
    for k in (100, 2000):
        got = nms.nms_topk(boxes, scores, valid, 0.7, k, impl="cuda",
                           presorted=True)
        want = nms.topk_survivors(whole, scores, k)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"nms_topk(k={k}) through the kernel's "
                                 "max_keep differs from the top k of the "
                                 "whole mask")
        results[f"nms_topk_{k}"] = dict(mismatches=0,
                                        valid=int(got[1].sum()))

    def roi_case(name, feats_nhwc, rois, **kw):
        feats = torch.from_numpy(feats_nhwc).to(dev).permute(0, 3, 1, 2)
        err = check_roi_align_fwd([feats], torch.from_numpy(rois).to(dev),
                                  None, kw)
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
    # one C4 launch whose ROIs cover the whole map at cap 8: the widest bin
    # rows, walked in several steps of the forward kernel's tile
    roi_case("roi_whole_c4_cap8",
             rng.randn(1, *c4, C4_CHANNELS).astype(np.float32),
             np.asarray([[[0.0, 0.0, 1216.0, 608.0],
                          [-30.0, -20.0, 1250.0, 640.0],
                          [-400.0, 0.0, 2400.0, 600.0]]], np.float32),
             max_samples=8, **kw14)

    def levels_case(name, b, r, c, empty_level=None):
        """The level-aware launch at the DCN pooler's maps (P 7, sampling
        ratio 2) against every level, then the mask."""
        maps, rois, levels = fpn_inputs(rng, b, r, c, dev, empty_level)
        kw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=2,
                  max_samples=8)
        err = check_roi_align_fwd(maps, rois, levels, kw)
        results[name] = dict(
            max_abs_err=err, features=[list(m.shape) for m in maps],
            rois=list(rois.shape),
            rois_a_level=[int((levels == i).sum()) for i in range(4)], **kw)

    levels_case("roi_levels_dcn", 1, SLICE_ROIS, 256)
    levels_case("roi_levels_empty_p3_b2", 2, 300, 256, empty_level=1)
    levels_case("roi_levels_no_roi_b2", 2, 0, 256)

    def bwd_case(name, map_shape, rois, strided=False, **kw):
        """map_shape (B, C, H, W); a random upstream gradient, [B, R, C, P,
        P] contiguous, or with ``strided`` an R slice of a channels-last one
        (as autograd hands it over: read in place)."""
        from da_detect_tpu_torch.ops import roi_align_cuda

        b, c, h, w = map_shape
        p, r = kw["output_size"], rois.shape[1]
        if strided:
            grad = torch.from_numpy(rng.randn(b, r + 3, p, p, c).astype(
                np.float32)).to(dev).permute(0, 1, 4, 2, 3)[:, 1:r + 1]
        else:
            grad = torch.from_numpy(rng.randn(b, r, c, p, p).astype(
                np.float32)).to(dev)
        err, scale = check_roi_align_backward(torch.from_numpy(rois).to(dev),
                                              grad, h, w, **kw)
        results[name] = dict(max_abs_err=err, max_abs_dF=scale,
                             features=list(map_shape), rois=list(rois.shape),
                             grad_copied=roi_align_cuda.grad_view(grad)[1],
                             **kw)

    # the train step's shape: 256 ROIs on the C4 map, P = 14
    bwd_case("bwd_train", (1, C4_CHANNELS, *c4),
             random_rois(rng, 1, TRAIN_ROIS, CANVAS, 900.0), max_samples=8,
             **kw14)
    bwd_case("bwd_p7_s2_r11", (2, 128, 10, 16),
             random_rois(rng, 2, 11, (160, 256), 80.0), spatial_scale=1 / 16,
             output_size=7, sampling_ratio=2, max_samples=8)
    for sr in (2, 0):  # off the map, degenerate (zero size) and inverted
        bwd_case(f"bwd_out_of_bounds_s{sr}", (1, 16, 10, 16), oob,
                 spatial_scale=1 / 16, output_size=7, sampling_ratio=sr,
                 max_samples=8)
    bwd_case("bwd_empty", (1, 16, 10, 16), np.zeros((1, 0, 4), np.float32),
             spatial_scale=1 / 16, output_size=7, sampling_ratio=2,
             max_samples=8)
    whole = np.asarray([[[0.0, 0.0, 1216.0, 608.0],
                         [-30.0, -20.0, 1250.0, 640.0]]], np.float32)
    bwd_case("bwd_whole_c4", (1, C4_CHANNELS, *c4), whole, max_samples=8,
             **kw14)
    # FPN P2 at 608x1216 (the DCN YAML's pooler: P 7, sampling ratio 2)
    bwd_case("bwd_whole_p2", (1, 256, CANVAS[0] // 4, CANVAS[1] // 4),
             whole[:, :1], spatial_scale=1 / 4, output_size=7,
             sampling_ratio=2, max_samples=8)
    edges = np.asarray([[[-100.0, 100.0, 200.0, 300.0],
                         [100.0, -100.0, 300.0, 200.0],
                         [1100.0, 100.0, 1400.0, 300.0],
                         [100.0, 500.0, 300.0, 800.0],
                         [-50.0, -50.0, 60.0, 40.0],
                         [1150.0, 560.0, 1300.0, 700.0]]], np.float32)
    bwd_case("bwd_map_edges", (1, 64, *c4), edges, max_samples=8, **kw14)
    for c in (4, 12):  # the last 32-channel slice partly empty
        bwd_case(f"bwd_c{c}", (1, c, *c4),
                 random_rois(rng, 1, 20, CANVAS, 900.0), max_samples=8,
                 **kw14)
    # 800 rows: Ay alone passes the 48 KB target
    tall = np.asarray([[[0.0, 0.0, 128.0, 12800.0],
                        [10.0, 300.0, 90.0, 5000.0]]], np.float32)
    bwd_case("bwd_tall_map", (1, 8, 800, 8), tall, max_samples=8, **kw14)
    bwd_case("bwd_strided_grad", (1, C4_CHANNELS, *c4),
             random_rois(rng, 1, 40, CANVAS, 900.0), strided=True,
             max_samples=8, **kw14)

    from da_detect_tpu_torch.ops import gather_cuda

    gather_errs = {"row_gather": 0.0, "row_gather_bulk": 0.0}
    for case, (s, c, p, stride) in GATHER_CASES.items():
        for dtype in ((torch.float32, torch.bfloat16)
                      if case in GATHER_BF16_CASES else (torch.float32,)):
            wide = torch.from_numpy(rng.randn(s, stride or c).astype(
                np.float32)).to(dev, dtype)
            table = wide[:, 8:8 + c] if stride else wide
            # a tenth of the indices out of range on either side: clamped
            idx = torch.from_numpy(rng.randint(
                -s // 10 - 1, s + s // 10 + 1, p).astype(np.int32)).to(dev)
            for name in gather_errs:
                key = f"{name}_{case}_{str(dtype)[6:]}"
                if name == "row_gather_bulk" and (c * table.element_size()
                                                  ) % 16:
                    try:
                        gather_cuda.row_gather_bulk(table, idx)
                    except ValueError:
                        results[key] = dict(refused="rows not 16-byte "
                                                    "aligned")
                        continue
                    raise AssertionError(f"{key}: unaligned rows accepted")
                err = check_gather(name, table, idx)
                gather_errs[name] = max(gather_errs[name], err)
                results[key] = dict(max_abs_err=err, table=[s, c],
                                    row_stride=table.stride(0), indices=p)
    emit("kernels", **results)
    return dict(
        nms=max(r["mismatches"] for k, r in results.items()
                if k.startswith("nms")),
        roi_align_fwd=max(r["max_abs_err"] for k, r in results.items()
                          if k.startswith("roi")),
        roi_align_bwd=max(r["max_abs_err"] for k, r in results.items()
                          if k.startswith("bwd")),
        **gather_errs)


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


def serve_requests(fn, model, batches, per_forward: dict, label: str):
    """The main path: counts set to 0, one request a batch through ``fn``,
    counts read. Raises if a kernel ran another number of times than
    ``per_forward`` a request. Returns (answers, launches, seconds)."""
    from da_detect_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    answers = [fn(model, b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in kernels.SOURCES}
    n = len(batches)
    for name in kernels.SOURCES:
        if launches[name] != per_forward.get(name, 0) * n:
            raise AssertionError(f"{label}: kernel {name} launched "
                                 f"{launches[name]} times in {n} requests, "
                                 f"expected {per_forward.get(name, 0) * n}")
    return answers, launches, seconds


def check_detections(cfg, dets) -> dict:
    """Shape, finiteness and at least one valid detection; a summary."""
    if tuple(dets.boxes.shape) != (1, cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
                                   4):
        raise AssertionError(f"detections {tuple(dets.boxes.shape)}")
    if not (torch.isfinite(dets.boxes).all()
            and torch.isfinite(dets.scores).all()):
        raise AssertionError("non-finite detections")
    n_valid = int(dets.valid.sum())
    if n_valid == 0:
        raise AssertionError("a request returned no detection")
    return dict(valid=n_valid, top_score=float(dets.scores.max()),
                labels=sorted(set(dets.labels[dets.valid].tolist())))


def phase_slice(dev):
    cfg, fn, model, batches = flagship_model(dev)
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_FORWARD, "slice")
    summary = [check_detections(cfg, dets) for dets in answers]

    with record_kernel_inputs() as captured:
        dets_k = fn(model, batches[0])
    rerun_identical = all(torch.equal(x, y)
                          for x, y in zip(dets_k, answers[0]))
    dets_p = model(batches[0], impl="plain")
    agreement = match_detections(dets_k, dets_p)
    errs = check_captured(captured)
    emit("slice", config=os.path.relpath(FLAGSHIP_YAML, REPO),
         canvas=list(CANVAS), requests=REQUESTS, seconds=seconds,
         launches=launches, detections=summary,
         rerun_identical=rerun_identical, plain_agreement=agreement,
         main_path_inputs={
             "nms": [dict(shape=list(b.shape), iou=t, valid=int(v.sum()),
                          max_keep=k)
                     for b, v, t, k in captured["nms"]],
             "roi_align_fwd": fwd_inputs(captured)},
         max_abs_err=errs)
    return model, fn, batches, captured, launches, errs


def stage_times(model, batch, marks, spans, runs: int = 10) -> dict:
    """Median device time of each stage of the forward, from CUDA events
    recorded by module hooks: ``marks`` names modules (events "name.in" and
    "name.out" around each; "start" and "end" around the forward), ``spans``
    maps a stage to its (first event, last event)."""
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


def nms_split(boxes, valid, thresh, max_keep, keep) -> dict:
    """One NMS call's device time split into its two launches, the IoU mask
    and the walk, and the walk's steps: the 64-box blocks it resolved, up to
    the block of its stop (the slowest image of the batch)."""
    from da_detect_tpu_torch.ops import nms_cuda

    ms = device_profile(
        lambda: nms_cuda.nms_mask_sorted(boxes, valid, thresh, max_keep),
        KERNEL_PROFILE_RUNS,
        kernels=("nms_mask_kernel", "nms_walk_kernel"))["kernel_ms_per_run"]
    mask_ms, walk_ms = ms["nms_mask_kernel"], ms["nms_walk_kernel"]
    steps = int(-(-nms_stops(keep, max_keep).max() // 64))
    return dict(
        device_ms=None if None in (mask_ms, walk_ms) else mask_ms + walk_ms,
        mask_device_ms=mask_ms, walk_device_ms=walk_ms, walk_steps=steps,
        walk_us_per_step=None if walk_ms is None
        else walk_ms * 1e3 / max(steps, 1))


def time_sites(captured, path: str, nms_sites) -> list:
    """Kernel and plain times, and the bound, of each kernel launch a main
    path made (``captured`` from ``record_kernel_inputs``), on its inputs."""
    from da_detect_tpu_torch.ops import (gather, gather_cuda, nms, nms_cuda,
                                         roi_align, roi_align_cuda)

    sites = []
    for (boxes, valid, thresh, k), site in zip(captured["nms"], nms_sites):
        keep = nms_cuda.nms_mask_sorted(boxes, valid, thresh, k)
        nbytes, ops = nms_work(valid, keep, k)
        bound_ms, by = bound(nbytes, ops)
        sites.append(dict(
            kernel="nms", path=path, site=site, shape=list(boxes.shape),
            iou=thresh, max_keep=k, kept=int(keep.sum()), bytes=nbytes,
            operations=ops,
            ms=time_ms(lambda: nms_cuda.nms_mask_sorted(boxes, valid, thresh,
                                                        k)),
            plain_ms=time_ms(lambda: nms.nms_mask_sorted(boxes, valid, thresh,
                                                         k), runs=20),
            bound_ms=bound_ms, bound_by=by,
            **nms_split(boxes, valid, thresh, k, keep)))
    for i, (maps, rois, levels, kw) in enumerate(captured["roi_align_fwd"]):
        work = roi_align_work([m.shape for m in maps], rois, levels, kw)
        bound_ms, by = bound(work["bytes"], work["operations"])
        sites.append(dict(
            kernel="roi_align_fwd", path=path, site=f"pool{i}",
            features=[list(m.shape) for m in maps], rois=list(rois.shape),
            levels=len(maps), **work,
            ms=time_ms(lambda: fwd_call(maps, rois, levels, kw)),
            plain_ms=time_ms(lambda: fwd_call(maps, rois, levels, kw,
                                              plain=True), runs=20),
            device_ms=device_profile(
                lambda: fwd_call(maps, rois, levels, kw),
                KERNEL_PROFILE_RUNS, kernels=("roi_align_fwd_kernel",)
            )["kernel_ms_per_run"]["roi_align_fwd_kernel"],
            bound_ms=bound_ms, bound_by=by))
    for i, (grad, rois, h, w, kw, copied) in enumerate(
            captured["roi_align_bwd"]):
        shape = (grad.shape[0], grad.shape[2], h, w)
        work = roi_align_work([shape], rois, None, kw)
        nbytes, ops = work["bytes"], work["operations"]
        bound_ms, by = bound(nbytes, ops)
        sites.append(dict(
            kernel="roi_align_bwd", path=path, site=f"grad{i}",
            grad=list(grad.shape), grad_copied=copied, features=list(shape),
            rois=list(rois.shape), bytes=nbytes, operations=ops,
            ms=time_ms(lambda: roi_align_cuda.roi_align_backward(
                grad, rois, height=h, width=w, **kw)),
            plain_ms=time_ms(lambda: roi_align.roi_align_grad(
                grad, rois, height=h, width=w, **kw), runs=20),
            device_ms=device_profile(
                lambda: roi_align_cuda.roi_align_backward(
                    grad, rois, height=h, width=w, **kw),
                KERNEL_PROFILE_RUNS, kernels=("roi_align_bwd_kernel",)
            )["kernel_ms_per_run"]["roi_align_bwd_kernel"],
            bound_ms=bound_ms, bound_by=by))
    for name in ("row_gather", "row_gather_bulk"):
        kernel = getattr(gather_cuda, name)
        for i, (table, idx) in enumerate(captured[name]):
            s = table.shape[0]
            if idx.numel() and not (0 <= int(idx.min())
                                    and int(idx.max()) < s):
                raise AssertionError(f"{path}: a {name} index of the main "
                                     f"path lies outside its table of {s}")
            # bytes: each distinct row read once, the indices, the output
            rows = int(torch.unique(idx).numel())
            row_bytes = table.shape[1] * table.element_size()
            nbytes = rows * row_bytes + 4 * idx.numel() \
                + idx.numel() * row_bytes
            bound_ms, by = bound(nbytes, 0)
            sites.append(dict(
                kernel=name, path=path, site=f"tap{i}",
                table=list(table.shape), row_stride=table.stride(0),
                indices=idx.numel(), distinct_rows=rows, bytes=nbytes,
                operations=0,
                ms=time_ms(lambda: kernel(table, idx),
                           runs=GATHER_TIMING_RUNS),
                plain_ms=time_ms(lambda: gather.row_gather(table, idx),
                                 runs=GATHER_TIMING_RUNS),
                library_ms=time_ms(lambda: torch.index_select(table, 0, idx),
                                   runs=GATHER_TIMING_RUNS),
                bound_ms=bound_ms, bound_by=by))
    return sites


def phase_times(model, fn, batches, captured) -> list:
    sites = time_sites(captured, "eval", ("rpn", "box_head"))
    batch = batches[0]
    forward_ms = host_ms(lambda: fn(model, batch))
    forward_plain_ms = host_ms(lambda: model(batch, impl="plain"))
    box = model.roi_heads["box"]
    marks = [("backbone", model.backbone), ("rpn_head", model.rpn["head"]),
             ("extractor", box["feature_extractor"]),
             ("res5_head", box["feature_extractor"].head),
             ("predictor", box["predictor"])]
    spans = {"normalize": ("start", "backbone.in"),
             "backbone": ("backbone.in", "backbone.out"),
             "rpn_head": ("rpn_head.in", "rpn_head.out"),
             "proposals_with_nms": ("rpn_head.out", "extractor.in"),
             "roi_align": ("extractor.in", "res5_head.in"),
             "res5_head": ("res5_head.in", "res5_head.out"),
             "predictor": ("predictor.in", "predictor.out"),
             "postprocess_with_nms": ("predictor.out", "end")}
    stages = stage_times(model, batch, marks, spans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(model, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("times", sites=sites, forward_ms=forward_ms,
         forward_plain_ms=forward_plain_ms, stages_ms=stages,
         max_memory_allocated=peak)
    return sites


# ---------------------------------------------------------------- training

def train_cfg(aligned: bool):
    """The flagship YAML at the 608x1216 canvas in float32. ``aligned``: the
    aligned variant with its instance triplet on (weight 1.0), as the
    reference's aligned triplet trainer runs it; the YAML's weight 0 would
    leave the re-pooled members unused."""
    from da_detect_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP_YAML)
    cfg.TPU.IMAGE_SHAPE = CANVAS
    cfg.TPU.COMPUTE_DTYPE = "float32"
    if aligned:
        cfg.MODEL.DA_HEADS.ALIGNMENT = True
        cfg.MODEL.DA_HEADS.DA_TRIPLET_INS_WEIGHT = 1.0
    cfg.freeze()
    return cfg


def train_step_one(state, args, impl: str, seed: int = 1):
    """Step 1's losses and gradients without the update, dropout off, the
    sampling priorities from a generator seeded with ``seed``."""
    model = state.model
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=args[0].images.device).manual_seed(seed)
    losses, _ = model.train_forward(args[0], args[1], state.da_state,
                                    *args[2:], deterministic=True,
                                    generator=gen, impl=impl)
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    model.zero_grad(set_to_none=True)
    return {k: v.item() for k, v in losses.items()}, grads


def compare_steps(kernel, plain) -> dict:
    (lk, gk), (lp, gp) = kernel, plain
    if set(lk) != set(lp):
        raise AssertionError(f"loss names differ: {sorted(lk)} {sorted(lp)}")
    loss_rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp}
    bad = {k: (lk[k], lp[k]) for k in lp
           if abs(lk[k] - lp[k]) > TRAIN_LOSS_RTOL * abs(lp[k])}
    if bad:
        raise AssertionError(f"kernel-run step-1 losses differ from the "
                             f"plain run beyond rtol {TRAIN_LOSS_RTOL}: {bad}")
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in gp.values())
    worst, worst_name = 0.0, None
    for n, g in gp.items():
        err = float((gk[n] - g).abs().max())
        ratio = err / (TRAIN_GRAD_REL * float(g.abs().max()) + floor)
        if ratio > worst:
            worst, worst_name = ratio, n
    if worst > 1.0:
        raise AssertionError(f"kernel-run step-1 gradient of {worst_name} "
                             f"differs from the plain run: {worst:.3f} x "
                             "its tolerance")
    return dict(losses=lk, max_loss_rel_err=max(loss_rel.values()),
                leaves=len(gp), worst_grad_tolerance_used=worst,
                worst_grad_leaf=worst_name)


def train_split(step, state, args, runs: int) -> dict:
    """Median device spans of ``runs`` calls of the entry's own train step
    (dropout on): forward (``zero_grad`` and ``train_forward``), backward
    (the loss sum and ``backward``), optimizer (``DetectronSGD.step``) and
    the whole step, from CUDA events recorded when the model's
    ``train_forward`` returns and around the optimizer's ``step``, both
    wrapped for these calls only."""
    model, opt = state.model, state.optimizer
    forward, update = model.train_forward, opt.step
    marks: dict[str, torch.cuda.Event] = {}

    def record(key):
        marks[key] = torch.cuda.Event(enable_timing=True)
        marks[key].record()

    def timed_forward(*a, **kw):
        out = forward(*a, **kw)
        record("forward")
        return out

    def timed_update(*a, **kw):
        record("backward")
        update(*a, **kw)
        record("optimizer")

    spans = {"forward": ("start", "forward"),
             "backward": ("forward", "backward"),
             "optimizer": ("backward", "optimizer"), "step": ("start", "end")}
    samples = {k: [] for k in spans}
    model.train_forward, opt.step = timed_forward, timed_update
    try:
        for _ in range(runs):
            record("start")
            state, _ = step(state, *args)
            record("end")
            torch.cuda.synchronize()
            for k, (a, b) in spans.items():
                samples[k].append(marks[a].elapsed_time(marks[b]))
    finally:
        del model.train_forward, opt.step
    return {k: statistics.median(v) for k, v in samples.items()}


# kernel-name fragments -> group, for the profile's breakdown (first match)
KERNEL_GROUPS = (
    ("roi_align_bwd", ("roi_align_bwd",)),
    ("roi_align_fwd", ("roi_align_fwd",)),
    ("nms", ("nms_",)),
    ("row_gather_bulk", ("row_gather_bulk",)),
    ("row_gather", ("row_gather",)),
    ("convolution", ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad",
                     "implicit", "winograd", "fft")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("sort, top-k, scan", ("sort", "radix", "topk", "scan", "cumsum")),
    ("reduction", ("reduce",)),
    ("elementwise, copy", ("elementwise", "vectorized", "copy", "fill",
                           "cat", "index", "gather", "scatter", "where")),
)


def device_profile(run, runs: int, kernels=(), attempts: int = 3) -> dict:
    """``runs`` calls of ``run()`` (a train step, a forward, one kernel's
    wrapper) under ``torch.profiler``: device time a call by kernel group,
    the top kernels and the kernels whose names hold each of ``kernels``,
    and the device's busy share of the host's wall clock (under the
    profiler's own overhead). Unlike CUDA events around a call, device
    times leave out the host's launch work. Now and then a profile records
    no launch of a kernel that ran: it is then taken again, up to
    ``attempts`` times, and a time still missing is None, not 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        named = {name: sum(e.self_device_time_total for e in kern
                           if name in e.key) / 1e3 / runs
                 for name in kernels}
        if all(named.values()):
            break
    groups: dict[str, float] = {}
    for e in kern:
        name = e.key.lower()
        group = next((g for g, frags in KERNEL_GROUPS
                      if any(f in name for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + (
            e.self_device_time_total / 1e3 / runs)
    busy_ms = sum(groups.values())
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    return dict(
        runs=runs, wall_ms_per_run=wall_ms / runs,
        device_ms_per_run=busy_ms,
        device_busy_share=busy_ms * runs / wall_ms,
        groups_ms_per_run=dict(sorted(groups.items(),
                                      key=lambda kv: -kv[1])),
        top_kernels=[dict(name=e.key[:100], calls_per_run=e.count / runs,
                          ms_per_run=e.self_device_time_total / 1e3 / runs)
                     for e in top],
        kernel_ms_per_run={name: t or None for name, t in named.items()})


def run_steps(step, state, args, n: int, expected: dict, label: str):
    """The main path: counts set to 0, ``n`` steps through the train step,
    each timed on the host clock to its synchronize, counts read. Raises if
    a kernel ran another number of times than ``expected`` per step, or a
    loss is not finite."""
    from da_detect_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    times, metrics = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = {name: kernels.LAUNCHES[name] for name in kernels.SOURCES}
    for name in kernels.SOURCES:
        if launches[name] != expected.get(name, 0) * n:
            raise AssertionError(
                f"{label}: kernel {name} launched {launches[name]} times in "
                f"{n} steps, expected {expected.get(name, 0) * n}")
    totals = [float(m["loss_total"]) for m in metrics]
    if not all(np.isfinite(totals)):
        raise AssertionError(f"{label}: non-finite loss: {totals}")
    return state, launches, times, metrics


def phase_train(dev):
    from da_detect_tpu_torch import entry

    cfg = train_cfg(aligned=False)
    step, (state, args) = entry.train_entry(device=str(dev), seed=0, cfg=cfg)
    agreement = compare_steps(train_step_one(state, args, "cuda"),
                              train_step_one(state, args, "plain"))
    state, launches, times, metrics = run_steps(
        step, state, args, TRAIN_STEPS, PER_TRAIN_STEP, "train")
    split = train_split(step, state, args, SPLIT_STEPS)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    profile = device_profile(one_step, PROFILE_STEPS)
    state = holder[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with record_kernel_inputs() as captured:
        state, _ = step(state, *args)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    errs = check_captured(captured)
    margins = float(state.da_state.margin_img)
    del step, state

    a_cfg = train_cfg(aligned=True)
    a_step, (a_state, a_args) = entry.train_entry(device=str(dev), seed=0,
                                                  cfg=a_cfg)
    a_state, a_launches, a_times, a_metrics = run_steps(
        a_step, a_state, a_args, ALIGNED_STEPS, PER_ALIGNED_STEP, "aligned")
    del a_step, a_state
    emit("train", config=os.path.relpath(FLAGSHIP_YAML, REPO),
         canvas=list(CANVAS), steps=TRAIN_STEPS, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         step_ms=times, step_ms_median=statistics.median(times),
         split_ms=split, profile=profile, max_memory_allocated=peak,
         losses=[{k: float(v) for k, v in m.items()} for m in metrics],
         margin_img=margins, plain_agreement=agreement,
         main_path_inputs={
             "nms": [dict(shape=list(b.shape), iou=t, valid=int(v.sum()),
                          max_keep=k)
                     for b, v, t, k in captured["nms"]],
             "roi_align_fwd": fwd_inputs(captured),
             "roi_align_bwd": [dict(grad=list(g.shape), rois=list(r.shape),
                                    height=h, width=w, grad_copied=copied,
                                    **kw)
                               for g, r, h, w, kw, copied in
                               captured["roi_align_bwd"]]},
         max_abs_err=errs,
         aligned=dict(steps=ALIGNED_STEPS, launches=a_launches,
                      step_ms=a_times,
                      losses=[{k: float(v) for k, v in m.items()}
                              for m in a_metrics]))
    return captured, launches, errs


# ---------------------------------------------------------------- DCN

DCN_NMS_SITES = ("rpn_p2", "rpn_p3", "rpn_p4", "rpn_p5", "rpn_p6",
                 "box_head")


def dcn_model(dev, gather_mode: str):
    """The X-101-32x8d-FPN-DCN YAML at the 608x1216 canvas in float32 with
    ``TPU.DCN_GATHER`` = ``gather_mode``, through ``entry(cfg=...)`` with
    random weights from seed 0."""
    from da_detect_tpu_torch import entry

    cfg = entry.dcn_cfg(CANVAS)
    cfg.TPU.DCN_GATHER = gather_mode
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg)
    return cfg, fn, model


def spread_dcn(model, batch) -> list:
    """What the script changes in the random model: the score layers x 30,
    as for the flagship, and every ``conv_offset`` kernel (zero in the
    package's init, which puts each sample on the grid with corner weights
    (1, 0, 0, 0)) drawn normal from DCN_SEED, then scaled in one forward,
    layer by layer in forward order, so that its offsets have a standard
    deviation of DCN_OFFSET_STD pixels. Returns each layer's offset std
    before scaling."""
    from da_detect_tpu_torch.layers import DeformConv2d

    gen = torch.Generator().manual_seed(DCN_SEED)
    raw = []

    def calibrate(mod, _inputs, out):
        raw.append(float(out.std()))
        mod.weight.mul_(DCN_OFFSET_STD / raw[-1])   # the bias is zero
        return out * (DCN_OFFSET_STD / raw[-1])

    handles = []
    with torch.no_grad():
        model.rpn["head"].cls_logits.weight.mul_(SCORE_SCALE)
        model.roi_heads["box"]["predictor"].cls_score.weight.mul_(SCORE_SCALE)
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen))
                handles.append(m.conv_offset.register_forward_hook(calibrate))
        try:
            model(batch)
        finally:
            for h in handles:
                h.remove()
    return raw


def phase_dcn(dev):
    from da_detect_tpu_torch import entry

    cfg, fn, model = dcn_model(dev, "four")
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    raw_std = spread_dcn(model, batches[0])
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_DCN_FORWARD, "dcn")
    summary = [check_detections(cfg, dets) for dets in answers]
    # peak memory of one request, before any input is recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fn(model, batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    with record_kernel_inputs() as captured:
        dets_k = fn(model, batches[0])
    rerun_identical = all(torch.equal(x, y)
                          for x, y in zip(dets_k, answers[0]))
    agreement = match_detections(dets_k, model(batches[0], impl="plain"))

    q_cfg, q_fn, q_model = dcn_model(dev, "quad")
    q_model.load_state_dict(model.state_dict())
    with record_kernel_inputs() as q_captured:
        (dets_q,), q_launches, _ = serve_requests(
            q_fn, q_model, batches[:1], PER_QUAD_FORWARD, "dcn_quad")
    check_detections(q_cfg, dets_q)
    quad_agreement = match_detections(dets_q, dets_k)
    errs = check_captured(captured)
    for k, v in check_captured(q_captured).items():
        errs[k] = max(errs.get(k, 0.0), v)
    emit("dcn", config=os.path.relpath(entry.DCN_YAML, REPO),
         canvas=list(CANVAS), requests=REQUESTS, seconds=seconds,
         launches=launches, quad_launches=q_launches, detections=summary,
         offset_std_before_scaling=dict(min=min(raw_std), max=max(raw_std),
                                        layers=len(raw_std)),
         rerun_identical=rerun_identical, plain_agreement=agreement,
         quad_agreement=quad_agreement, resident_bytes=resident,
         max_memory_allocated=peak,
         main_path_inputs={
             "nms": [dict(shape=list(b.shape), iou=t, valid=int(v.sum()),
                          max_keep=k)
                     for b, v, t, k in captured["nms"]],
             "roi_align_fwd": fwd_inputs(captured)},
         max_abs_err=errs)
    return (model, fn, q_model, q_fn, batches[0], captured, q_captured,
            launches, q_launches, errs)


def gather_device_ms(inputs, name: str) -> dict:
    """Device time of one forward's gathers (``inputs``: the (table, idx)
    of each recorded launch), for the kernel, the plain version and
    ``torch.index_select``: each variant called once per input,
    GATHER_TIMING_RUNS times over under ``torch.profiler`` after a warm-up
    pass, its kernels' own device time summed per pass. GATHER_PROFILES
    such profiles, the three variants in turns; the median and every
    profile's number are kept. Unlike CUDA events around each call, this
    leaves out the host's launch overhead, which is as long as a small
    gather itself."""
    from da_detect_tpu_torch.ops import gather, gather_cuda

    variants = {"ms": getattr(gather_cuda, name),
                "plain_ms": gather.row_gather,
                "library_ms": lambda t, i: torch.index_select(t, 0, i)}

    def runner(fn):
        def run():
            for table, idx in inputs:
                fn(table, idx)
        return run

    for fn in variants.values():
        runner(fn)()
    profiles = {key: [] for key in variants}
    busy = {key: [] for key in variants}
    for _ in range(GATHER_PROFILES):
        for key, fn in variants.items():
            prof = device_profile(runner(fn), GATHER_TIMING_RUNS)
            profiles[key].append(prof["device_ms_per_run"])
            busy[key].append(prof["device_busy_share"])
    out = {}
    for key in variants:
        out[key] = statistics.median(profiles[key])
        out[key.replace("ms", "profiles_ms")] = profiles[key]
        out[key.replace("ms", "busy_share")] = statistics.median(busy[key])
    return out


def pooler_device_ms(captured) -> dict:
    """Device time of the DCN model's whole pooler (``pool_rois``: the
    level assignment and the ROIAlign launch) on the ROIs and maps of the
    forward's own launch, by kernel group, KERNEL_PROFILE_RUNS calls."""
    from da_detect_tpu_torch.models import poolers

    (maps, rois, _, kw), = captured["roi_align_fwd"]
    prof = device_profile(lambda: poolers.pool_rois(maps, rois, **kw,
                                                    impl="cuda"),
                          KERNEL_PROFILE_RUNS,
                          kernels=("roi_align_fwd_kernel",))
    return dict(device_ms=prof["device_ms_per_run"],
                kernel_device_ms=prof["kernel_ms_per_run"][
                    "roi_align_fwd_kernel"],
                groups_ms=prof["groups_ms_per_run"])


def gather_groups(sites) -> dict:
    """The gather sites of one forward summed by kernel and shape."""
    groups = {}
    for s in sites:
        if not s["kernel"].startswith("row_gather"):
            continue
        key = (f"{s['kernel']} table {s['table'][0]}x{s['table'][1]} "
               f"P {s['indices']}")
        g = groups.setdefault(key, dict(taps=0, ms=0.0, plain_ms=0.0,
                                        library_ms=0.0, bytes=0))
        g["taps"] += 1
        for k in ("ms", "plain_ms", "library_ms", "bytes"):
            g[k] += s[k]
    for g in groups.values():
        g["bound_ms"] = bound(g["bytes"], 0)[0]
    return groups


def phase_dcn_times(model, fn, q_model, q_fn, batch, captured,
                    q_captured) -> tuple[list, list]:
    sites = time_sites(captured, "dcn", DCN_NMS_SITES)
    q_sites = time_sites(q_captured, "dcn_quad", DCN_NMS_SITES)
    forward_ms = host_ms(lambda: fn(model, batch))
    quad_forward_ms = host_ms(lambda: q_fn(q_model, batch))
    forward_plain_ms = host_ms(lambda: model(batch, impl="plain"), runs=5,
                               warmup=1)
    body, box = model.backbone.body, model.roi_heads["box"]
    marks = [("stem", body.stem), ("res2", body.layer1),
             ("res3", body.layer2), ("res4", body.layer3),
             ("res5", body.layer4), ("fpn", model.backbone.fpn),
             ("rpn_head", model.rpn["head"]),
             ("extractor", box["feature_extractor"]),
             ("fc6", box["feature_extractor"].fc6),
             ("predictor", box["predictor"])]
    spans = {"normalize": ("start", "stem.in"),
             "body_to_res2": ("stem.in", "res2.out"),
             "res3": ("res3.in", "res3.out"),
             "res4": ("res4.in", "res4.out"),
             "res5": ("res5.in", "res5.out"),
             "fpn": ("fpn.in", "fpn.out"),
             "rpn_and_proposals": ("rpn_head.in", "extractor.in"),
             "pooler": ("extractor.in", "fc6.in"),
             "box_head": ("fc6.in", "predictor.out"),
             "postprocess": ("predictor.out", "end")}
    stages = stage_times(model, batch, marks, spans)
    profile = device_profile(lambda: fn(model, batch), DCN_PROFILE_RUNS)
    pooler = pooler_device_ms(captured)
    device = {"row_gather": gather_device_ms(captured["row_gather"],
                                             "row_gather"),
              "row_gather_bulk": gather_device_ms(
                  q_captured["row_gather_bulk"], "row_gather_bulk")}
    emit("dcn_times", forward_ms=forward_ms, quad_forward_ms=quad_forward_ms,
         forward_plain_ms=forward_plain_ms, stages_ms=stages,
         profile=profile, pooler=pooler, gather_device_ms=device,
         gather_call_ms={"four": gather_groups(sites),
                         "quad": gather_groups(q_sites)},
         sites=[s for s in sites + q_sites
                if not s["kernel"].startswith("row_gather")])
    return sites, q_sites, device


# ---------------------------------------------------------------- summary

def path_summary(sites, launches: int, device=None) -> dict:
    """A kernel's launches in a path's run, and its times and bound summed
    over the sites of one forward or step of that path: CUDA events around
    each call or, where ``device`` gives them (the gathers), device times
    from the profiler, the event times then kept as ``*call_ms``."""
    bound_ms, by = bound(sum(s["bytes"] for s in sites),
                         sum(s["operations"] for s in sites))
    library = [s.get("library_ms") for s in sites]
    out = dict(
        launches=launches, ms=sum(s["ms"] for s in sites),
        plain_ms=sum(s["plain_ms"] for s in sites), bound_ms=bound_ms,
        bound_by=by,
        library_ms=(sum(library) if library and None not in library
                    else None))
    if sites and all(s.get("device_ms") is not None for s in sites):
        # the kernels' own device time (profiler) beside the event time
        out["device_ms"] = sum(s["device_ms"] for s in sites)
    if device:
        for key in ("ms", "plain_ms", "library_ms"):
            out[key.replace("ms", "call_ms")] = out[key]
            out[key] = device[key]
    return out


def kernel_line(paths: dict, errs: dict) -> dict:
    """One row a kernel. ``paths``: path -> (sites of one forward or step,
    launches of the path's run, device times by kernel). The row's own
    numbers are those of the kernel's MAIN_PATH: ``launches`` counts that
    path's whole run (train: 6 steps; dcn: 4 requests; dcn_quad: 1
    request), ms, plain_ms, library_ms and the bound sum one step's or
    forward's launches. Every path the kernel ran on stands under
    ``paths``."""
    rows = []
    for name, (source, replaces) in SOURCES.items():
        per_path = {}
        for path, (sites, launches, device) in paths.items():
            mine = [s for s in sites if s["kernel"] == name]
            if mine or launches.get(name):
                per_path[path] = path_summary(mine, launches.get(name, 0),
                                              device.get(name))
        row = dict(name=name, route="cuda", source=source,
                   replaces=replaces, **per_path[MAIN_PATH[name]],
                   max_abs_err=errs[name], main_path=MAIN_PATH[name],
                   paths=per_path)
        if not name.startswith("row_gather"):
            row["sites"] = [
                {k: s[k] for k in ("path", "site", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by")
                 if k in s}
                for sites, _, _ in paths.values() for s in sites
                if s["kernel"] == name]
        rows.append(row)
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
    errs = phase_kernels(dev)
    model, fn, batches, captured, eval_launches, eval_errs = phase_slice(dev)
    eval_sites = phase_times(model, fn, batches, captured)
    del model, fn, batches, captured
    captured, train_launches, train_errs = phase_train(dev)
    train_sites = time_sites(captured, "train", ("rpn_source", "rpn_target"))
    emit("train_times", sites=train_sites)
    del captured
    (model, fn, q_model, q_fn, batch, captured, q_captured, dcn_launches,
     quad_launches, dcn_errs) = phase_dcn(dev)
    dcn_sites, quad_sites, device = phase_dcn_times(
        model, fn, q_model, q_fn, batch, captured, q_captured)
    for part in (eval_errs, train_errs, dcn_errs):
        for k, v in part.items():
            errs[k] = max(errs[k], v)
    print(json.dumps(kernel_line(
        {"eval": (eval_sites, eval_launches, {}),
         "train": (train_sites, train_launches, {}),
         "dcn": (dcn_sites, dcn_launches, device),
         "dcn_quad": (quad_sites, quad_launches, device)}, errs)))
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
