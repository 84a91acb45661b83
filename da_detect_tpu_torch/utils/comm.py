"""Cross-process helpers on ``torch.distributed`` (port of
``da_detect_tpu/utils/comm.py``; reference utils/comm.py:13-117).

Every helper returns early in a single process: without an initialized
process group, or at world size 1. Then ``all_gather`` is ``[data]``,
``reduce_dict`` a copy and ``synchronize`` nothing. The gradient
all-reduce is DDP's (``parallel/ddp.py``); these are the host-side pieces:
the eval merge, logging and barriers.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _device_ids():
    """NCCL's barrier takes the rank's card; gloo takes none."""
    if dist.get_backend() == "nccl":
        return [torch.cuda.current_device()]
    return None


def synchronize() -> None:
    """A barrier across every process (reference comm.synchronize)."""
    if get_world_size() == 1:
        return
    dist.barrier(device_ids=_device_ids())


def all_gather(data: Any) -> list[Any]:
    """Every process's picklable ``data``, in rank order."""
    world = get_world_size()
    if world == 1:
        return [data]
    out: list[Any] = [None] * world
    dist.all_gather_object(out, data)
    return out


def reduce_dict(d: dict[str, float], average: bool = True) -> dict[str, float]:
    """The mean (or sum) of each scalar over the processes (reference
    reduce_loss_dict), for logging."""
    world = get_world_size()
    if world == 1:
        return dict(d)
    gathered = all_gather({k: float(v) for k, v in d.items()})
    return {k: sum(g[k] for g in gathered) / (world if average else 1)
            for k in d}


def accumulate_predictions(predictions: dict) -> dict:
    """Every process's eval predictions ({image_id: ...}) merged, on every
    process (reference _accumulate_predictions_from_multiple_gpus)."""
    merged: dict = {}
    for part in all_gather(predictions):
        merged.update(part)
    return merged
