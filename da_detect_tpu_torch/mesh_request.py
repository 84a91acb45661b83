#!/usr/bin/env python3
"""Eval requests of the X-101-32x8d-FPN-DCN model under a mesh of two ranks
sharing one card (gloo), against one process: each rank's request time,
peak memory and parameter bytes.

    python3 da_detect_tpu_torch/mesh_request.py [--dtype bfloat16]
        [--requests 4] [--out FILE]

The YAML at 608x1216 (``entry.dcn_cfg``), random weights from seed 0 with
``e2e_pairs.spread_dcn``'s score scales and 1-pixel offsets, set in the
single process and handed to the ranks whole; one batch-1 request. The
single process answers first; then one spawn of 2 ranks answers under the
(data=1, space=2) and the (data=1, model=2) mesh (``parallel.parallelize``,
JAX's 256-channel rule). Each run: its kernel launches in one request, the
request's host-clock time to the synchronize (median of ``--requests``
after one), ``torch.cuda.max_memory_allocated`` over those requests (the
weights included), its parameter bytes, and its detections' twins in the
single process's (same label, box and score within ``chip_smoke.py``'s
bounds: 1e-2 px and 1e-4 in float32, 1 px and 2e-2 in bfloat16). In
bfloat16 the single process's own detections are also matched against a
float32 copy of its model (``bf16_vs_f32``): how many detections
bfloat16's rounding alone moves in this random-weight model. Prints one
JSON line a run, the card's name and power limit, and writes them to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# run as a file: the repository's root, not this package's directory
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = (("sp2", 2, 1), ("tp2", 1, 2))
CANVAS = (608, 1216)


def _model(cfg, dev, state=None):
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model

    model = build_detection_model(cfg, seed=0)
    if state is not None:
        model.load_state_dict(state)
    return prepare_model(model, dev)


def _requests(model, batch, n: int, dev) -> dict:
    import torch

    from da_detect_tpu_torch import kernels

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.LAUNCHES.clear()
        dets = model(batch)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return dict(dets=type(dets)(*[t.cpu() for t in dets]), launches=launches,
                ms=times, ms_median=statistics.median(times),
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                param_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()))


def _rank(rank, world, init_method, cfg, state, batch, n):
    import torch

    from da_detect_tpu_torch.parallel import (init_distributed, make_mesh,
                                              parallelize, set_mesh)

    dev = init_distributed(torch.device("cuda"), init_method=init_method,
                           rank=rank, world_size=world)
    out = {}
    for label, spatial, model_ranks in MODES:
        mesh = make_mesh(spatial=spatial, model=model_ranks)
        set_mesh(mesh)
        model = parallelize(_model(cfg, dev, state), mesh)
        out[label] = _requests(model, batch.to(dev), n, dev)
        out[label]["split_leaves"] = len(model._tp_plan)
        del model
        torch.cuda.empty_cache()
        set_mesh(None)
    return out


TWIN_BOUNDS = {"float32": (1e-2, 1e-4), "bfloat16": (1.0, 2e-2)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mesh_request: no CUDA device", file=sys.stderr)
        return 1
    from da_detect_tpu_torch import entry, kernels, parallel
    from da_detect_tpu_torch.e2e_pairs import spread_dcn, twins

    kernels.build()
    dev = torch.device("cuda", 0)
    cfg = entry.dcn_cfg(CANVAS, args.dtype)
    cfg.freeze()
    batch, _ = entry.make_batch(cfg, 1, seed=0, device=dev)
    model = _model(cfg, dev)
    spread_dcn(model, batch)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    lines = [dict(run="single", dtype=args.dtype,
                  **_requests(model, batch, args.requests, dev))]
    bounds = TWIN_BOUNDS[args.dtype]
    if args.dtype == "bfloat16":
        f32 = entry.dcn_cfg(CANVAS, "float32")
        f32.freeze()
        ref = _model(f32, dev, state)
        with torch.no_grad():
            dets = ref(batch)
        lines[0]["bf16_vs_f32"] = twins(lines[0]["dets"], type(dets)(
            *[t.cpu() for t in dets]), *bounds)
        del ref
    del model
    torch.cuda.empty_cache()
    ranks = parallel.spawn(_rank, 2, cfg, state, batch.to("cpu"),
                           args.requests)
    for label, _, _ in MODES:
        for r, got in enumerate(ranks):
            lines.append(dict(run=label, rank=r, dtype=args.dtype,
                              **got[label],
                              twins=twins(got[label]["dets"],
                                           lines[0]["dets"], *bounds)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    text = [json.dumps({k: v for k, v in line.items() if k != "dets"})
            for line in lines] + [smi]
    print("\n".join(text), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(text) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
