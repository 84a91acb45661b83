#!/usr/bin/env python3
"""Train-step and eval-forward times of two trees of the port, in turns on
one card.

    python3 da_detect_tpu_torch/e2e_pairs.py --trees PARENT CHANGE [--rounds 3]
        [--dtype float32|bfloat16] [--dcn-step-only | --gathers-only |
        --keypoint-only]

PARENT and CHANGE are roots of two checkouts of the repository (for example
``git archive`` of two commits unpacked side by side). Each round runs one
process a tree, in the order PARENT, CHANGE, CHANGE, PARENT, so that a drift
of the card or the host over the call falls on both alike. A process imports
``da_detect_tpu_torch`` from its own tree, builds that tree's kernels, and
measures the flagship R-50-C4 YAML at 608x1216 in ``--dtype`` (default
float32; the X-101-FPN-DCN step below too) with random weights from seed 0,
as ``chip_smoke.py`` drives it:

- ``forward_ms``: an eval request of batch 1 (class scores x 30), host clock
  to the synchronize, median of 20 after 3;
- ``step_ms``: the triplet-DA train step with dropout on, host clock to the
  synchronize, median of 12 after 3;
- 3 more of each under ``torch.profiler``: ``*_profiled_ms`` (host clock),
  ``*_device_ms`` (the device's kernels, copies and fills) and
  ``*_host_wait_ms`` (the host's time inside the CUDA calls that wait for
  the device: synchronizes and copies), each a call. The rest of a call,
  ``*_profiled_ms - *_host_wait_ms``, is host work: a call whose host
  waits little is host-bound and ends when the host has enqueued it,
  whatever its device time. Every CUDA runtime call's host time a call
  stands beside them (``*_cuda_calls_ms``);
- ``pooler_device_ms``: the X-101-FPN-DCN model's pooler (``pool_rois``
  with impl "cuda": level assignment and ROIAlign) on random P2-P5 maps of
  the 608x1216 canvas (C 256, P 7, sampling ratio 2) and 1000 ROIs of 4 to
  700 pixels a side from a seed, device time a call over 10 profiled calls;
- ``scatter_device_ms``: the row gathers' adjoint in the X-101-32x8d-FPN-DCN
  triplet-DA train step at 608x1216 ("four" gathers; random weights from
  seed 0 with ``spread_dcn``'s offsets, as ``chip_smoke.py`` sets them):
  the 810 calls of step 1 to the tree's ``gather_cuda.row_scatter_add``
  are recorded and replayed as the step made them (with whatever index
  bookkeeping the layer handed over) on random gradient rows, each a
  function with a dense [S, C] output; device time a step, median of 3
  profiles taken in turns with ``scatter_library_device_ms``, the same
  calls as torch.zeros + ``index_add_``. ``scatter_long_row_share``: the
  share of the calls' sources whose destination row owns more than 64;
- ``dcn_step_ms``: that DCN train step after the recorded one, host clock
  to the synchronize, median of DCN_STEP_RUNS. ``--dcn-step-only``
  measures this step and its scatter-add alone.
- ``--gathers-only`` measures the row gathers alone. ``dcn_gather_device_ms``:
  the 270 calls of one X-101-FPN-DCN eval forward ("four", ``--dtype``) to
  the tree's ``gather_cuda.row_gather``, recorded and replayed as the
  forward made them, device time a forward, median of GATHER_PROFILES
  profiles of GATHER_RUNS passes, taken in turns with
  ``dcn_gather_library_device_ms`` (``index_select`` on the same calls);
  ``pool_gather_device_ms`` and ``pool_gather_library_device_ms``: likewise
  the 2 gathers of a deformable PS-ROI pooling forward (without offsets,
  then with them) on float32 score maps [38, 76, 49 * 9] (rows of 36 B)
  and 256 ROIs over the canvas, from a seed, POOL_GATHER_RUNS passes a
  profile.
- ``--keypoint-only`` measures the Keypoint R-CNN YAML alone, uncut at
  800x1344 (random weights from seed 0, class scores x 30), in float32 and
  then bfloat16 in one process (``kp_f32_*``, ``kp_bf16_*``):
  ``forward_ms``, a request with keypoints, median of KP_FORWARD_RUNS after
  3; ``step_ms``, the source-only step on 2 images, median of KP_STEP_RUNS
  after 3; ``forward_device_ms`` and ``step_device_ms`` from 3 profiled
  calls each; ``predictor_request_device_ms``, the keypoint predictor
  alone on a request's 100 ROIs (forward), and
  ``predictor_step_device_ms``, on a step's 2 x 512 (forward and
  backward), device time a call over KP_PREDICTOR_RUNS profiled calls, on
  random inputs from a seed.

Prints one JSON line a process, the card's name and power limit, and last a
summary: for each tree and metric the median over its processes and each
process's value, and CHANGE minus PARENT within each round.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CANVAS = (608, 1216)
FLAGSHIP_YAML = os.path.join(
    "configs", "da_faster_rcnn",
    "e2e_triplet_da_faster_rcnn_R_50_C4_cityscapes_to_foggy_cityscapes.yaml")
SCORE_SCALE = 30.0
FORWARD_RUNS, STEP_RUNS, PROFILE_RUNS, WARMUP = 20, 12, 3, 3
POOLER_RUNS, POOLER_ROIS, FPN_CHANNELS = 10, 1000, 256
SCATTER_PROFILES, SCATTER_LONG_ROW, DCN_STEP_RUNS = 3, 64, 4
# conv_offset kernels drawn from this seed, each scaled so that its offsets
# have this standard deviation (pixels): samples spread over about +-2 px
DCN_SEED, DCN_OFFSET_STD = 0, 1.0
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
# CUDA runtime calls in which the host waits for the device
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")
GATHER_PROFILES, GATHER_RUNS, POOL_GATHER_RUNS = 3, 3, 20
# the deform pool's score maps (38x76, P 7, C' 9), ROIs and offsets' scale
POOL_MAP, POOL_P, POOL_C, POOL_ROIS, POOL_OFFSET_STD = (38, 76), 7, 9, 256, 0.1
KP_FORWARD_RUNS, KP_STEP_RUNS, KP_PREDICTOR_RUNS = 10, 6, 10
KP_METRICS = tuple(
    f"kp_{d}_{m}" for d in ("f32", "bf16")
    for m in ("forward_ms", "step_ms", "forward_device_ms", "step_device_ms",
              "predictor_request_device_ms", "predictor_step_device_ms"))
METRICS = tuple(f"{name}_{m}" for name in ("forward", "step")
                for m in ("ms", "profiled_ms", "device_ms", "host_wait_ms")
                ) + KP_METRICS + ("pooler_device_ms", "scatter_device_ms",
                     "scatter_library_device_ms", "dcn_step_ms",
                     "dcn_gather_device_ms", "dcn_gather_library_device_ms",
                     "pool_gather_device_ms",
                     "pool_gather_library_device_ms")


def flagship_cfg(tree: str, canvas, dtype: str = "float32"):
    from da_detect_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(tree, FLAGSHIP_YAML))
    cfg.TPU.IMAGE_SHAPE = tuple(canvas)
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def host_ms(fn, runs: int, sync) -> list[float]:
    for _ in range(WARMUP):
        fn()
    sync()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profiled(fn, runs: int, sync, cuda: bool, name: str) -> dict:
    """Host clock, device time and the host's wait a call of ``fn``, over
    ``runs`` calls under ``torch.profiler``, each key led by ``name``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
            sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    calls_ms = {e.key: e.self_cpu_time_total / 1e3 / runs for e in events
                if e.device_type == DeviceType.CPU
                and e.key.startswith("cuda")}
    return {f"{name}_profiled_ms": wall_ms / runs,
            f"{name}_device_ms": device_us / 1e3 / runs,
            f"{name}_host_wait_ms": sum(calls_ms.get(k, 0.0)
                                        for k in WAIT_CALLS),
            f"{name}_cuda_calls_ms": calls_ms}


def pooler_inputs(device: str, canvas, seed: int = 0):
    """P2-P5 maps of ``canvas`` (channels-last) and POOLER_ROIS ROIs of 4
    to 700 pixels a side over it, from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    maps = [torch.from_numpy(rng.randn(
        1, -(-canvas[0] // int(1 / s)), -(-canvas[1] // int(1 / s)),
        FPN_CHANNELS).astype(np.float32)).to(device).permute(0, 3, 1, 2)
        for s in FPN_SCALES]
    side = np.exp(rng.uniform(np.log(4), np.log(700), (1, POOLER_ROIS, 2)))
    xy = rng.uniform(-50, (canvas[1], canvas[0]), (1, POOLER_ROIS, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).astype(
        np.float32)).to(device)
    return maps, rois


def twins(a, b, box_atol: float, score_atol: float) -> dict:
    """Each valid detection of ``a`` paired with its own twin in ``b``
    (same label, boxes and scores within the bounds): the valid counts, the
    detections of ``a`` without a twin, the largest errors of the pairs.
    Near-tied scores may swap places, so order is not compared."""
    import torch

    av, bv = a.valid[0].cpu(), b.valid[0].cpu()
    boxes_a, boxes_b = a.boxes[0].cpu()[av], b.boxes[0].cpu()[bv]
    scores_a, scores_b = a.scores[0].cpu()[av], b.scores[0].cpu()[bv]
    labels_a, labels_b = a.labels[0].cpu()[av], b.labels[0].cpu()[bv]
    used = torch.zeros(len(labels_b), dtype=torch.bool)
    box_err = score_err = 0.0
    lone = []
    for i in range(len(labels_a)):
        d_box = (boxes_b - boxes_a[i]).abs().amax(dim=1)
        d_score = (scores_b - scores_a[i]).abs()
        ok = ((labels_b == labels_a[i]) & (d_box <= box_atol)
              & (d_score <= score_atol) & ~used)
        if not bool(ok.any()):
            lone.append(dict(index=i, label=int(labels_a[i]),
                             score=float(scores_a[i])))
            continue
        j = int(torch.nonzero(ok)[0])
        used[j] = True
        box_err = max(box_err, float(d_box[j]))
        score_err = max(score_err, float(d_score[j]))
    return dict(valid=(int(av.sum()), int(bv.sum())),
                matched=int(used.sum()), without_twin=lone,
                max_box_err=box_err, max_score_err=score_err,
                same_order=bool(torch.equal(labels_a, labels_b)
                                and torch.equal(boxes_a, boxes_b)))


def spread_dcn(model, batch) -> list:
    """What the measurements change in a random DCN model: the score layers
    x SCORE_SCALE, as for the flagship, and every ``conv_offset`` kernel
    (zero in the package's init, which puts each sample on the grid with
    corner weights (1, 0, 0, 0)) drawn normal from DCN_SEED, then scaled in
    one forward, layer by layer in forward order, so that its offsets have
    a standard deviation of DCN_OFFSET_STD pixels. Returns each layer's
    offset std before scaling."""
    import torch

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


def dcn_scatter(cfg, device: str, sync, cuda: bool) -> dict:
    """``scatter_device_ms``, ``scatter_library_device_ms``,
    ``scatter_long_row_share`` and ``dcn_step_ms`` (see above) of the DCN
    train step ``cfg``."""
    import torch

    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.ops import gather_cuda

    step, (state, args) = entry.train_entry(device=device, seed=0, cfg=cfg)
    spread_dcn(state.model, args[0])
    kernel, calls = gather_cuda.row_scatter_add, []

    def record(grad, idx, num_rows, *rest):
        calls.append((grad.shape[1], idx.clone(), num_rows, rest))
        return kernel(grad, idx, num_rows, *rest)

    gather_cuda.row_scatter_add = record
    try:
        state, _ = step(state, *args)
        sync()
    finally:
        gather_cuda.row_scatter_add = kernel
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    steps = host_ms(one_step, DCN_STEP_RUNS, sync)
    del step, state, args, holder
    buf = torch.randn(max(c * idx.numel() for c, idx, _, _ in calls),
                      device=device, generator=torch.Generator(
                          device=device).manual_seed(0))

    def library(grad, idx, num_rows, *_):
        return torch.zeros(num_rows, grad.shape[1], device=grad.device
                           ).index_add_(0, idx, grad)

    def replay(fn):
        def run():
            for c, idx, num_rows, rest in calls:
                fn(buf[:idx.numel() * c].view(-1, c), idx, num_rows, *rest)
        return run

    variants = {"scatter": kernel, "scatter_library": library}
    times = {name: [] for name in variants}
    for fn in variants.values():
        replay(fn)()
    for _ in range(SCATTER_PROFILES):
        for name, fn in variants.items():
            times[name].append(profiled(replay(fn), 1, sync, cuda, name)[
                f"{name}_device_ms"])
    long_sources = 0
    for _, idx, num_rows, _ in calls:
        counts = torch.bincount(idx.long().clamp(0, num_rows - 1),
                                minlength=num_rows)
        long_sources += int(counts[counts > SCATTER_LONG_ROW].sum())
    return dict(dcn_step_ms=statistics.median(steps), dcn_steps_ms=steps,
                **{f"{name}_device_ms": statistics.median(t)
                   for name, t in times.items()},
                **{f"{name}_profiles_ms": t for name, t in times.items()},
                scatter_calls=len(calls),
                scatter_long_row_share=long_sources / sum(
                    idx.numel() for _, idx, _, _ in calls))


def recorded_gathers(run) -> list:
    """The (table, idx) of each call to ``gather_cuda.row_gather`` that
    ``run()`` makes, tables detached."""
    from da_detect_tpu_torch.ops import gather_cuda

    kernel, calls = gather_cuda.row_gather, []

    def record(table, idx, *rest):
        calls.append((table.detach(), idx.clone()))
        return kernel(table, idx, *rest)

    gather_cuda.row_gather = record
    try:
        run()
    finally:
        gather_cuda.row_gather = kernel
    return calls


def gather_device(calls, runs: int, sync, cuda: bool, name: str) -> dict:
    """Device time a pass over ``calls`` of the tree's row gather and of
    ``index_select``: GATHER_PROFILES profiles of ``runs`` passes, the two
    in turns; the median and each profile's number."""
    import torch

    from da_detect_tpu_torch.ops import gather_cuda

    variants = {name: gather_cuda.row_gather,
                f"{name}_library": lambda t, i: torch.index_select(t, 0, i)}

    def passes(fn):
        def run():
            for table, idx in calls:
                fn(table, idx)
        return run

    times = {key: [] for key in variants}
    for fn in variants.values():
        passes(fn)()
    for _ in range(GATHER_PROFILES):
        for key, fn in variants.items():
            times[key].append(profiled(passes(fn), runs, sync, cuda, key)[
                f"{key}_device_ms"])
    return {**{f"{key}_device_ms": statistics.median(t)
               for key, t in times.items()},
            **{f"{key}_profiles_ms": t for key, t in times.items()}}


def gathers(device: str, canvas, dtype: str, sync, cuda: bool) -> dict:
    """``dcn_gather*`` and ``pool_gather*`` (see above)."""
    import numpy as np
    import torch

    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.layers.deform_pool import deform_ps_roi_pool

    cfg = entry.dcn_cfg(canvas, dtype)
    cfg.TPU.DCN_GATHER = "four"
    cfg.freeze()
    fn, (model, _) = entry.entry(device=device, seed=0, cfg=cfg)
    batch = entry.make_batch(cfg, 1, seed=0, device=device)[0]
    spread_dcn(model, batch)
    calls = recorded_gathers(lambda: fn(model, batch))
    out = dict(dcn_gather_calls=len(calls),
               **gather_device(calls, GATHER_RUNS, sync, cuda, "dcn_gather"))
    del fn, model, batch, calls

    rng = np.random.RandomState(7)
    maps = torch.from_numpy(rng.randn(
        *POOL_MAP, POOL_P * POOL_P * POOL_C).astype(np.float32)).to(device)
    xy = rng.uniform(-40, (canvas[1] - 40, canvas[0] - 40), (POOL_ROIS, 2))
    side = rng.uniform(16, 400, (POOL_ROIS, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).astype(
        np.float32)).to(device)
    offsets = torch.from_numpy(rng.normal(0.0, POOL_OFFSET_STD, (
        POOL_ROIS, POOL_P, POOL_P, 2)).astype(np.float32)).to(device)
    kw = dict(spatial_scale=1 / 16, output_size=POOL_P,
              out_channels=POOL_C, impl="cuda")

    def pool():
        with torch.no_grad():
            for off in (None, offsets):
                deform_ps_roi_pool(maps, rois, off, **kw)

    calls = recorded_gathers(pool)
    out.update(pool_gather_calls=len(calls),
               **gather_device(calls, POOL_GATHER_RUNS, sync, cuda,
                               "pool_gather"))
    return out


def keypoint(device: str, dtype: str, sync, cuda: bool) -> dict:
    """The Keypoint R-CNN numbers of ``--keypoint-only`` in ``dtype``."""
    import torch

    from da_detect_tpu_torch import entry

    d = "f32" if dtype == "float32" else "bf16"
    cfg = entry.keypoint_cfg(dtype=dtype)
    cfg.freeze()
    fn, (model, _) = entry.entry(device=device, seed=0, cfg=cfg,
                                 with_keypoints=True)
    with torch.no_grad():
        model.rpn["head"].cls_logits.weight.mul_(SCORE_SCALE)
        model.roi_heads["box"]["predictor"].cls_score.weight.mul_(SCORE_SCALE)
    batch = entry.make_batch(cfg, 1, seed=0, device=device)[0]
    forward = host_ms(lambda: fn(model, batch), KP_FORWARD_RUNS, sync)
    forward_profile = profiled(lambda: fn(model, batch), PROFILE_RUNS, sync,
                               cuda, "forward")
    predictor = model.keypoint_head.predictor
    layer = predictor.kps_score_lowres
    c, k = layer.in_channels, layer.out_channels
    gen = torch.Generator().manual_seed(0)
    compute = torch.float32 if dtype == "float32" else torch.bfloat16
    x = torch.randn(1, 100, c, 14, 14, generator=gen).to(device, compute)
    with torch.no_grad():
        request = profiled(lambda: predictor(x), KP_PREDICTOR_RUNS, sync,
                           cuda, "predictor")
    x = torch.randn(2, 512, c, 14, 14, generator=gen).to(
        device, compute).requires_grad_(True)
    g = torch.randn(2, 512, k, 52, 52, generator=gen).to(device)
    leaves = [x, *predictor.parameters()]
    step_pred = profiled(
        lambda: torch.autograd.grad(predictor(x), leaves, g),
        KP_PREDICTOR_RUNS, sync, cuda, "predictor")
    del fn, model, batch, predictor, x, g, leaves

    step, (state, args) = entry.source_train_entry(device=device, seed=0,
                                                   cfg=cfg)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    steps = host_ms(one_step, KP_STEP_RUNS, sync)
    step_profile = profiled(one_step, PROFILE_RUNS, sync, cuda, "step")
    del step, state, args, holder
    return {f"kp_{d}_forward_ms": statistics.median(forward),
            f"kp_{d}_step_ms": statistics.median(steps),
            f"kp_{d}_forward_device_ms": forward_profile["forward_device_ms"],
            f"kp_{d}_step_device_ms": step_profile["step_device_ms"],
            f"kp_{d}_predictor_request_device_ms":
                request["predictor_device_ms"],
            f"kp_{d}_predictor_step_device_ms":
                step_pred["predictor_device_ms"],
            f"kp_{d}_forward_runs_ms": forward,
            f"kp_{d}_step_runs_ms": steps}


def measure(tree: str, device: str = "cuda", canvas=CANVAS,
            dtype: str = "float32", dcn_only: bool = False,
            gathers_only: bool = False, keypoint_only: bool = False
            ) -> dict:
    """One process's numbers for the port found under ``tree``; with
    ``dcn_only``, those of the DCN train step alone; with
    ``gathers_only``, those of the row gathers alone; with
    ``keypoint_only``, the Keypoint R-CNN's in both dtypes."""
    import torch

    from da_detect_tpu_torch import entry, kernels

    if not os.path.abspath(entry.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {entry.__file__}, not the port under "
                           f"{tree}")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        kernels.build()
    out = dict(tree=tree, package=os.path.dirname(entry.__file__),
               dtype=dtype)
    if gathers_only:
        out.update(gathers(device, canvas, dtype, sync, cuda))
        return out
    if keypoint_only:
        for kp_dtype in ("float32", "bfloat16"):
            out.update(keypoint(device, kp_dtype, sync, cuda))
        return out
    if not dcn_only:
        out.update(flagship_and_pooler(tree, device, canvas, dtype, sync,
                                       cuda))
    cfg = entry.dcn_train_cfg(canvas)
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.freeze()
    out.update(dcn_scatter(cfg, device, sync, cuda))
    return out


def flagship_and_pooler(tree: str, device: str, canvas, dtype: str, sync,
                        cuda: bool) -> dict:
    """The flagship's forward and step numbers and the DCN pooler's."""
    import torch

    from da_detect_tpu_torch import entry

    cfg = flagship_cfg(tree, canvas, dtype)
    cfg.freeze()
    fn, (model, _) = entry.entry(device=device, seed=0, cfg=cfg)
    with torch.no_grad():
        model.rpn["head"].cls_logits.weight.mul_(SCORE_SCALE)
        model.roi_heads["box"]["predictor"].cls_score.weight.mul_(SCORE_SCALE)
    batch = entry.make_batch(cfg, 1, seed=0, device=device)[0]
    forward = host_ms(lambda: fn(model, batch), FORWARD_RUNS, sync)
    forward_profile = profiled(lambda: fn(model, batch), PROFILE_RUNS, sync,
                               cuda, "forward")
    del fn, model, batch

    cfg = flagship_cfg(tree, canvas, dtype)
    cfg.freeze()
    step, (state, args) = entry.train_entry(device=device, seed=0, cfg=cfg)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    steps = host_ms(one_step, STEP_RUNS, sync)
    step_profile = profiled(one_step, PROFILE_RUNS, sync, cuda, "step")
    del step, state, args, holder

    from da_detect_tpu_torch.models import poolers

    maps, rois = pooler_inputs(device, canvas)

    def pool():
        with torch.no_grad():
            poolers.pool_rois(maps, rois, scales=FPN_SCALES, output_size=7,
                              sampling_ratio=2, max_samples=8, impl="cuda")

    pool()
    pooler = profiled(pool, POOLER_RUNS, sync, cuda, "pooler")
    return dict(forward_ms=statistics.median(forward),
                step_ms=statistics.median(steps),
                **forward_profile, **step_profile,
                pooler_device_ms=pooler["pooler_device_ms"],
                forward_runs_ms=forward, step_runs_ms=steps)


def run_tree(tree: str, timeout: int, dtype: str, dcn_only: bool,
             gathers_only: bool, keypoint_only: bool) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--tree", tree, "--dtype", dtype]
                          + ["--dcn-step-only"] * dcn_only
                          + ["--gathers-only"] * gathers_only
                          + ["--keypoint-only"] * keypoint_only,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: rc {proc.returncode}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def summarize(results: list[dict], parent: str, change: str) -> dict:
    """Per tree and metric the median and each value; per round, CHANGE
    minus PARENT (each the mean of the round's two processes)."""
    metrics = [m for m in METRICS if all(m in r for r in results)]
    out = {}
    for label, tree in (("parent", parent), ("change", change)):
        mine = [r for r in results if r["tree"] == tree]
        out[label] = {m: dict(median=statistics.median(r[m] for r in mine),
                              values=[r[m] for r in mine]) for m in metrics}
    rounds = sorted({r["round"] for r in results})
    out["change_minus_parent"] = {
        m: [statistics.mean(r[m] for r in results
                            if r["round"] == i and r["tree"] == change)
            - statistics.mean(r[m] for r in results
                              if r["round"] == i and r["tree"] == parent)
            for i in rounds]
        for m in metrics}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("PARENT", "CHANGE"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds a process may take")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="TPU.COMPUTE_DTYPE of the flagship and DCN models")
    ap.add_argument("--dcn-step-only", action="store_true",
                    help="measure the DCN train step (and its scatter-add) "
                         "alone")
    ap.add_argument("--gathers-only", action="store_true",
                    help="measure the row gathers (DCN forward, deform "
                         "pool) alone")
    ap.add_argument("--keypoint-only", action="store_true",
                    help="measure the Keypoint R-CNN request, step and "
                         "predictor alone, in both dtypes")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one process's tree
    a = ap.parse_args()
    if a.tree:
        tree = os.path.abspath(a.tree)
        sys.path[0] = tree  # the tree's package, not this file's
        print(json.dumps(measure(tree, dtype=a.dtype,
                                 dcn_only=a.dcn_step_only,
                                 gathers_only=a.gathers_only,
                                 keypoint_only=a.keypoint_only)),
              flush=True)
        return 0
    if not a.trees:
        ap.error("--trees PARENT CHANGE is required")
    parent, change = (os.path.abspath(t) for t in a.trees)
    results = []
    for i in range(a.rounds):
        for tree in (parent, change, change, parent):
            r = dict(run_tree(tree, a.timeout, a.dtype, a.dcn_step_only,
                              a.gathers_only, a.keypoint_only), round=i)
            results.append(r)
            print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps(summarize(results, parent, change)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
