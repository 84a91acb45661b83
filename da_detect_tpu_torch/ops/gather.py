"""Row gather, plain version (of ``scripts/bench_gather_pallas.py``'s two
TPU kernels, which compute ``jnp.take(table, idx, axis=0, mode="clip")``).

``row_gather(table, idx)``: table [S, C] (any row stride), idx [P] integer
-> [P, C], out-of-range indices clamped to [0, S - 1]. The CUDA kernels'
wrappers are in ``ops/gather_cuda.py``.
"""

from __future__ import annotations

import torch


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))
