#!/usr/bin/env python3
"""Train-step and eval-forward times of two trees of the port, in turns on
one card.

    python3 da_detect_tpu_torch/e2e_pairs.py --trees PARENT CHANGE [--rounds 3]

PARENT and CHANGE are roots of two checkouts of the repository (for example
``git archive`` of two commits unpacked side by side). Each round runs one
process a tree, in the order PARENT, CHANGE, CHANGE, PARENT, so that a drift
of the card or the host over the call falls on both alike. A process imports
``da_detect_tpu_torch`` from its own tree, builds that tree's kernels, and
measures the flagship R-50-C4 YAML at 608x1216 in float32 with random weights
from seed 0, as ``chip_smoke.py`` drives it:

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
  700 pixels a side from a seed, device time a call over 10 profiled calls.

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
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
# CUDA runtime calls in which the host waits for the device
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")
METRICS = tuple(f"{name}_{m}" for name in ("forward", "step")
                for m in ("ms", "profiled_ms", "device_ms", "host_wait_ms")
                ) + ("pooler_device_ms",)


def flagship_cfg(tree: str, canvas):
    from da_detect_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(tree, FLAGSHIP_YAML))
    cfg.TPU.IMAGE_SHAPE = tuple(canvas)
    cfg.TPU.COMPUTE_DTYPE = "float32"
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


def measure(tree: str, device: str = "cuda", canvas=CANVAS) -> dict:
    """One process's numbers for the port found under ``tree``."""
    import torch

    from da_detect_tpu_torch import entry, kernels

    if not os.path.abspath(entry.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {entry.__file__}, not the port under "
                           f"{tree}")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        kernels.build()
    cfg = flagship_cfg(tree, canvas)
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

    cfg = flagship_cfg(tree, canvas)
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
    out = dict(tree=tree, package=os.path.dirname(entry.__file__),
               forward_ms=statistics.median(forward),
               step_ms=statistics.median(steps),
               **forward_profile, **step_profile,
               pooler_device_ms=pooler["pooler_device_ms"],
               forward_runs_ms=forward, step_runs_ms=steps)
    return out


def run_tree(tree: str, timeout: int) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--tree", tree], capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: rc {proc.returncode}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def summarize(results: list[dict], parent: str, change: str) -> dict:
    """Per tree and metric the median and each value; per round, CHANGE
    minus PARENT (each the mean of the round's two processes)."""
    out = {}
    for label, tree in (("parent", parent), ("change", change)):
        mine = [r for r in results if r["tree"] == tree]
        out[label] = {m: dict(median=statistics.median(r[m] for r in mine),
                              values=[r[m] for r in mine]) for m in METRICS}
    rounds = sorted({r["round"] for r in results})
    out["change_minus_parent"] = {
        m: [statistics.mean(r[m] for r in results
                            if r["round"] == i and r["tree"] == change)
            - statistics.mean(r[m] for r in results
                              if r["round"] == i and r["tree"] == parent)
            for i in rounds]
        for m in METRICS}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("PARENT", "CHANGE"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds a process may take")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one process's tree
    a = ap.parse_args()
    if a.tree:
        tree = os.path.abspath(a.tree)
        sys.path[0] = tree  # the tree's package, not this file's
        print(json.dumps(measure(tree)), flush=True)
        return 0
    if not a.trees:
        ap.error("--trees PARENT CHANGE is required")
    parent, change = (os.path.abspath(t) for t in a.trees)
    results = []
    for i in range(a.rounds):
        for tree in (parent, change, change, parent):
            r = dict(run_tree(tree, a.timeout), round=i)
            results.append(r)
            print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps(summarize(results, parent, change)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
