"""Multi-GPU training: data parallelism with DDP (``ddp.py``)."""

from .ddp import (check_divisible, check_mesh, global_average, global_mean,
                  global_sum, init_distributed, shard, shutdown, spawn,
                  unused_parameters, wrap_train_forward)

__all__ = ["check_divisible", "check_mesh", "global_average", "global_mean",
           "global_sum", "init_distributed", "shard", "shutdown", "spawn",
           "unused_parameters", "wrap_train_forward"]
