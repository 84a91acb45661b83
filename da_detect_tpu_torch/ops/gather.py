"""Row gather and its adjoint, plain versions (of the two TPU kernels of
``scripts/bench_gather_pallas.py``, which compute ``jnp.take(table, idx,
axis=0, mode="clip")``, and of the scatter-add that XLA's autodiff makes of
that take).

``row_gather(table, idx)``: table [S, C] (any row stride), idx [P] integer
-> [P, C], out-of-range indices clamped to [0, S - 1].

``row_scatter_add(grad, idx, num_rows)``: the adjoint of ``row_gather``,
grad [P, C], idx [P] -> [S, C] with ``S = num_rows``: row ``clamp(idx[i])``
receives the sum of every ``grad[i]`` that points at it, every other row is
zero. ``row_scatter_add_(dst, grad, idx)`` adds into a caller's [S, C] view
in place instead (any row stride: a column slice of a wider map).

The CUDA kernels' wrappers are in ``ops/gather_cuda.py``.
"""

from __future__ import annotations

import torch


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def row_scatter_add_(dst: torch.Tensor, grad: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    return dst.index_add_(0, idx.clamp(0, dst.shape[0] - 1), grad)


def row_scatter_add(grad: torch.Tensor, idx: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    dst = grad.new_zeros((num_rows, grad.shape[1]))
    return row_scatter_add_(dst, grad, idx)
