"""Per-process logging (port of ``da_detect_tpu/utils/logging_utils.py``;
reference utils/logger.py and utils/collect_env.py)."""

from __future__ import annotations

import logging
import os
import sys

_HANDLERS: dict[str, list[logging.Handler]] = {}


def setup_logger(name: str, save_dir: str | None, rank: int = 0
                 ) -> logging.Logger:
    """Logger ``name`` at INFO: to stdout on rank 0, and on every rank to
    ``save_dir/log_rank{rank}.txt`` when ``save_dir`` is given. A second
    setup of the same name replaces the first's handlers (a process that
    runs several CLIs logs each to its own directory)."""
    logger = logging.getLogger(name)
    for h in _HANDLERS.pop(name, []):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    handlers: list[logging.Handler] = []
    if rank == 0:
        handlers.append(logging.StreamHandler(stream=sys.stdout))
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(save_dir, f"log_rank{rank}.txt")))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    _HANDLERS[name] = handlers
    logger.setLevel(logging.INFO)
    return logger


def collect_env_info() -> str:
    """torch, CUDA and NCCL versions, the device and this process's
    rank in its world."""
    import numpy as np
    import torch

    from .comm import get_rank, get_world_size

    lines = [f"torch: {torch.__version__}", f"numpy: {np.__version__}",
             f"CUDA (torch built with): {torch.version.cuda}"]
    if torch.cuda.is_available():
        nccl = torch.cuda.nccl.version()
        lines += [f"NCCL: {'.'.join(map(str, nccl))}",
                  f"device: {torch.cuda.get_device_name()} "
                  f"(cuda:{torch.cuda.current_device()} of "
                  f"{torch.cuda.device_count()})"]
    else:
        lines.append("device: cpu (no CUDA device)")
    lines.append(f"rank: {get_rank()} of world {get_world_size()}")
    return "\n".join(lines)
