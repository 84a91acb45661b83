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
in place instead (any row stride: a column slice of a wider map). A
bfloat16 scatter-add sums in float32 and rounds each destination value to
bfloat16 once, as the kernel does (not the CPU's bfloat16 ``index_add_``,
which rounds after every addition).

``row_csr(idx, num_rows)``: the index bookkeeping of the scatter-add kernel,
on the CPU and on the card alike: the sources of each destination row, in
order (CSR). ``row_scatter_add_csr_`` sums through it in the kernel's order:
for a row of at most ``LONG_ROW`` sources the order in which ``index_add_``
adds on the CPU, for a longer row a sum of pieces.

The CUDA kernels' wrappers are in ``ops/gather_cuda.py``.
"""

from __future__ import annotations

import collections
import math

import torch

# CSR indices built by row_csr, one a call
CSR_BUILDS: collections.Counter = collections.Counter()
# the scatter-add kernel sums a row of more sources than this in pieces (its
# kLongRow, in kernels/csrc/row_scatter_add.cu)
LONG_ROW = 64


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def row_scatter_add_(dst: torch.Tensor, grad: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    rows = idx.clamp(0, dst.shape[0] - 1)
    if dst.dtype == torch.float32:
        return dst.index_add_(0, rows, grad)
    return dst.copy_(dst.float().index_add_(0, rows, grad.float()))


def row_scatter_add(grad: torch.Tensor, idx: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    dst = grad.new_zeros((num_rows, grad.shape[1]))
    return row_scatter_add_(dst, grad, idx)


def row_csr(idx: torch.Tensor, num_rows: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """idx [..., P] integer, each leading index a segment of its own (the
    DCN layer's taps and deformable groups) -> (perm [..., P] int32,
    row_ptr [..., S + 1] int32) with ``S = num_rows``: within a segment, the
    positions whose index clamps to row r are perm[row_ptr[r]] ..
    perm[row_ptr[r + 1] - 1], ascending. One stable sort of every segment's
    keys ``segment * S + clamp(idx)``, one ``searchsorted`` for the row
    boundaries; no host synchronisation."""
    CSR_BUILDS["row_csr"] += 1
    lead, p = idx.shape[:-1], idx.shape[-1]
    g, dev = math.prod(lead), idx.device
    seg = idx.reshape(g, p)
    if p and not num_rows:
        raise ValueError("row_csr: indices into an empty destination")
    if g * max(num_rows + 1, p) >= 2 ** 31:
        raise ValueError(f"row_csr: {g} segments of {p} indices into "
                         f"{num_rows} rows overflow int32")
    i32 = dict(dtype=torch.int32, device=dev)
    segment = torch.arange(g, **i32)[:, None]
    starts = segment * num_rows
    keys = (seg.to(torch.int32).clamp(0, max(num_rows - 1, 0))
            + starts).reshape(-1)
    ordered, order = torch.sort(keys, stable=True)
    offsets = segment * p
    perm = order.to(torch.int32).view(g, p) - offsets
    bounds = starts + torch.arange(num_rows + 1, **i32)
    row_ptr = torch.searchsorted(ordered, bounds, out_int32=True) - offsets
    return perm.view(*lead, p), row_ptr.view(*lead, num_rows + 1)


def row_scatter_add_csr_(dst: torch.Tensor, grad: torch.Tensor,
                         perm: torch.Tensor, row_ptr: torch.Tensor,
                         long_row: int = LONG_ROW) -> torch.Tensor:
    """dst [S, C] += grad [P, C] through the CSR of ``row_csr`` (perm [P],
    row_ptr [S + 1]), in place, in the scatter-add kernel's order. A row of
    at most ``long_row`` sources adds them one at a time in perm order. A
    longer one is cut into pieces where the sorted positions cross a
    multiple of ``long_row``, each piece summed in perm order from zero;
    its m pieces into 8 groups of ceil(m / 8), each summed in order from
    zero; and the groups added to the row in order. A bfloat16 dst and grad
    are summed so in float32 and each value rounded once."""
    if dst.dtype != torch.float32:
        return dst.copy_(row_scatter_add_csr_(
            dst.float(), grad.float(), perm, row_ptr, long_row))
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.arange(dst.shape[0], device=dst.device)
    short = counts <= long_row
    for k in range(int(counts[short].max()) if short.any() else 0):
        live = rows[short & (counts > k)]
        src = perm[row_ptr[live].long() + k].long()
        dst[live] = dst[live] + grad[src]
    for r in rows[~short].tolist():
        beg, end = int(row_ptr[r]), int(row_ptr[r + 1])
        cuts = [beg, *range((beg // long_row + 1) * long_row, end, long_row),
                end]
        pieces = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            piece = torch.zeros_like(dst[r])
            for j in range(lo, hi):
                piece = piece + grad[int(perm[j])]
            pieces.append(piece)
        per = -(-len(pieces) // 8)
        acc = dst[r]
        for g in range(0, len(pieces), per):
            group = torch.zeros_like(acc)
            for piece in pieces[g:g + per]:
                group = group + piece
            acc = acc + group
        dst[r] = acc
    return dst
