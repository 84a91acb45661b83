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
  stands beside them (``*_cuda_calls_ms``).

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
# CUDA runtime calls in which the host waits for the device
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")
METRICS = tuple(f"{name}_{m}" for name in ("forward", "step")
                for m in ("ms", "profiled_ms", "device_ms", "host_wait_ms"))


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
    out = dict(tree=tree, package=os.path.dirname(entry.__file__),
               forward_ms=statistics.median(forward),
               step_ms=statistics.median(steps),
               **forward_profile,
               **profiled(one_step, PROFILE_RUNS, sync, cuda, "step"),
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
