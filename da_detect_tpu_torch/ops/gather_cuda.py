"""Row gathers and their adjoint as hand-written CUDA kernels for Hopper (port
of the two TPU kernels of ``scripts/bench_gather_pallas.py``:
``make_gather(...).run`` and ``make_dma_gather(...).run``; sources
``kernels/csrc/row_gather.cu`` and ``row_gather_bulk.cu``; and the
scatter-add that XLA's autodiff makes of a take, ``row_scatter_add.cu``).

Both gathers compute ``out[i] = table[clamp(idx[i], 0, S - 1)]`` for a table
[S, C] in float32 or bfloat16 whose rows may lie ``table.stride(0)`` elements
apart (a column slice of a wider map), and int32 indices [P]; they return a
new contiguous [P, C]. ``row_gather`` moves a row with one warp's 16-byte
loads; ``row_gather_bulk`` with one bulk copy (TMA) a row and needs 16-byte
aligned rows. Both are differentiable with respect to the table: the
backward is the scatter-add kernel (``row_scatter_add``), float32 or
bfloat16 (summed in float32, each value rounded once), which writes a fresh
[S, C] whole (``torch.empty``, no zero-fill).
``row_scatter_add_`` adds into a caller's [S, C] view in place (any row
stride).

The scatter-add kernel sums each destination row's sources in a fixed
order through the indices' CSR (``ops/gather.py::row_csr``): no atomics,
the same bits from run to run; a row of more than ``LONG_ROW`` sources in
pieces (``ops/gather.py::row_scatter_add_csr_`` is the order). A caller
that gathers with the same indices many times builds the CSR once and
hands it over (``csr=(perm, row_ptr)``): a gather saves it for its
backward. Without one, the scatter-add builds it itself.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version (``ops/gather.py``), which autograd
differentiates, and ignores ``csr``. A gather that needs no gradient goes
through its operator (``da_detect::row_gather``, ``row_gather_bulk``:
``ops/library.py``), whose CUDA implementation is ``launch`` and whose CPU
implementation is the plain version; a differentiable one launches from
its autograd function.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .gather import LONG_ROW, row_csr
from .gather import row_gather as row_gather_plain
from .gather import row_scatter_add as row_scatter_add_plain
from .gather import row_scatter_add_ as row_scatter_add_plain_

GATHER, BULK, SCATTER = "row_gather", "row_gather_bulk", "row_scatter_add"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# gathers: table, idx, out, p, s, c, row stride, stream; the scatter-add:
# grad, idx, perm, row_ptr, scratch, long_start, dst, p, s, c, row stride,
# accumulate, stream
_ARGTYPES = {GATHER: [_P, _P, _P, _L, _I, _I, _L, _P],
             BULK: [_P, _P, _P, _L, _I, _I, _L, _P],
             SCATTER: [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _P]}

_fns: dict = {}


def _launcher(name: str, dtype: torch.dtype):
    key = (name, dtype)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(kernels.load(name), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def _check_table(name: str, table: torch.Tensor, what: str) -> None:
    """[S, C] with unit column stride. A traced table's strides are the
    fake kernels' guess (a traced convolution's output need not be
    channels-last where the card's is): they are checked on the real
    table, at launch."""
    if table.dim() != 2 or not torch.compiler.is_compiling() and (
            table.stride(1) != 1 or table.stride(0) < table.shape[1]):
        raise ValueError(f"kernel {name}: {what} must be [S, C] with unit "
                         f"column stride, got {tuple(table.shape)} strides "
                         f"{table.stride()}")


def _check_idx(name: str, idx: torch.Tensor, device: torch.device) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != device:
        raise ValueError(f"kernel {name}: idx must be int32 [P] on the "
                         f"table's device, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")


def _check(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"gather kernel {name}: unsupported device "
                         f"{table.device}")
    if table.dtype not in _SUFFIX:
        raise ValueError(f"gather kernel {name}: table must be float32 or "
                         f"bfloat16, got {table.dtype}")
    _check_table(name, table, "table")
    _check_idx(name, idx, table.device)
    if table.shape[0] == 0 and idx.numel():
        raise ValueError(f"gather kernel {name}: empty table")


def _run(name: str, dtype: torch.dtype, device: torch.device,
         args: list) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launcher(name, dtype)(*args, stream)
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1


def launch(name: str, table: torch.Tensor, idx: torch.Tensor
           ) -> torch.Tensor:
    """Gather kernel ``name``'s launch on checked CUDA inputs: the
    operator's CUDA implementation. The table's memory is checked here, on
    the real tensor (``_check_table``, ``_check_bulk_rows``)."""
    _check_table(name, table, "table")
    if name == BULK:
        _check_bulk_rows(table)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel():
        _run(name, table.dtype, table.device, [
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            table.shape[0], table.shape[1], table.stride(0)])
    return out


def _needs_grad(table: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and table.requires_grad


class _RowGather(torch.autograd.Function):
    """A gather kernel forward; the scatter-add kernel backward, through
    the indices' CSR when the caller gave one."""

    @classmethod
    def gather(cls, name: str, table: torch.Tensor, idx: torch.Tensor,
               csr) -> torch.Tensor:
        idx = idx.contiguous()
        if _needs_grad(table):
            return cls.apply(table, idx, name, *(csr or (None, None)))
        return getattr(torch.ops.da_detect, name)(table, idx)

    @staticmethod
    def forward(ctx, table, idx, name, perm, row_ptr):
        ctx.num_rows = table.shape[0]
        ctx.save_for_backward(idx, perm, row_ptr)
        return launch(name, table, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, perm, row_ptr = ctx.saved_tensors
        dtable = None
        if ctx.needs_input_grad[0]:
            csr = None if perm is None else (perm, row_ptr)
            dtable = row_scatter_add(grad.contiguous(), idx, ctx.num_rows,
                                     csr)
        return dtable, None, None, None, None


def row_gather(table: torch.Tensor, idx: torch.Tensor, csr=None
               ) -> torch.Tensor:
    """table [S, C] f32/bf16, idx [P] int32 -> [P, C] (the warp kernel).
    ``csr``: ``row_csr(idx, S)``, kept for the backward, or None."""
    if table.device.type == "cpu":
        if _needs_grad(table):
            return row_gather_plain(table, idx)
        return torch.ops.da_detect.row_gather(table, idx)
    _check(GATHER, table, idx)
    return _RowGather.gather(GATHER, table, idx, csr)


def row_gather_bulk(table: torch.Tensor, idx: torch.Tensor, csr=None
                    ) -> torch.Tensor:
    """table [S, C] f32/bf16, idx [P] int32 -> [P, C] (one bulk copy a
    row). Rows must be 16-byte aligned: C * itemsize, the row stride in
    bytes and the table's address multiples of 16. ``csr`` as for
    ``row_gather``."""
    if table.device.type == "cpu":
        if _needs_grad(table):
            return row_gather_plain(table, idx)
        return torch.ops.da_detect.row_gather_bulk(table, idx)
    _check(BULK, table, idx)
    _check_bulk_rows(table)
    item = table.element_size()
    if table.shape[1] * item > 227 * 1024:
        raise ValueError(f"gather kernel {BULK}: a row of "
                         f"{table.shape[1] * item} B exceeds a block's "
                         "shared memory")
    return _RowGather.gather(BULK, table, idx, csr)


def _check_bulk_rows(table: torch.Tensor) -> None:
    """The bulk copy's rows: C * itemsize, and on a real table (not a
    traced one, ``_check_table``) the row stride in bytes and the address,
    multiples of 16."""
    item = table.element_size()
    if (table.shape[1] * item) % 16 or not torch.compiler.is_compiling() and (
            (table.stride(0) * item) % 16 or table.data_ptr() % 16):
        raise ValueError(f"gather kernel {BULK}: rows must be 16-byte "
                         f"aligned (C={table.shape[1]}, row stride "
                         f"{table.stride(0)}, {table.dtype})")


def _scatter(dst: torch.Tensor, grad: torch.Tensor, idx: torch.Tensor,
             csr, accumulate: bool) -> torch.Tensor:
    """Check, build the CSR if none was given, launch (grad not empty)."""
    if dst.device.type != "cuda":
        raise ValueError(f"scatter kernel {SCATTER}: unsupported device "
                         f"{dst.device}")
    if dst.dtype not in _SUFFIX or grad.dtype != dst.dtype:
        raise ValueError(f"scatter kernel {SCATTER}: dst and grad must both "
                         f"be float32 or both bfloat16, got {dst.dtype} and "
                         f"{grad.dtype}")
    _check_table(SCATTER, dst, "dst")
    _check_idx(SCATTER, idx, dst.device)
    s, p = dst.shape[0], idx.shape[0]
    if grad.device != dst.device or grad.dim() != 2 \
            or grad.shape != (p, dst.shape[1]) or not grad.is_contiguous():
        raise ValueError(f"scatter kernel {SCATTER}: grad must be a "
                         f"contiguous [P, C] = [{p}, {dst.shape[1]}] on "
                         f"dst's device, got {tuple(grad.shape)} on "
                         f"{grad.device}")
    if s == 0 and p:
        raise ValueError(f"scatter kernel {SCATTER}: empty dst")
    if not grad.numel():
        return dst
    perm, row_ptr = csr if csr is not None else row_csr(idx, s)
    if perm.dtype != torch.int32 or row_ptr.dtype != torch.int32 \
            or perm.shape != (p,) or row_ptr.shape != (s + 1,) \
            or not (perm.is_contiguous() and row_ptr.is_contiguous()) \
            or perm.device != dst.device or row_ptr.device != dst.device:
        raise ValueError(f"scatter kernel {SCATTER}: csr must be contiguous "
                         f"int32 perm [{p}] and row_ptr [{s + 1}] on dst's "
                         f"device, got {perm.dtype} {tuple(perm.shape)} and "
                         f"{row_ptr.dtype} {tuple(row_ptr.shape)}")
    idx = idx.contiguous()
    # the pieces of rows longer than LONG_ROW, a tile of LONG_ROW sorted
    # sources (the kernel's kLongRow): 2 rows of C and the long row that
    # starts in the tile; the kernel writes them before it reads them
    tiles = -(-p // LONG_ROW)
    scratch = torch.empty((tiles, 2, dst.shape[1]), dtype=torch.float32,
                          device=dst.device)
    long_start = torch.empty(tiles, dtype=torch.int32, device=dst.device)
    _run(SCATTER, dst.dtype, dst.device, [
        grad.data_ptr(), idx.data_ptr(), perm.data_ptr(), row_ptr.data_ptr(),
        scratch.data_ptr(), long_start.data_ptr(), dst.data_ptr(), p, s,
        dst.shape[1], dst.stride(0), int(accumulate)])
    return dst


def row_scatter_add_(dst: torch.Tensor, grad: torch.Tensor,
                     idx: torch.Tensor, csr=None) -> torch.Tensor:
    """dst [S, C] f32 or bf16 (any row stride) += the rows of grad [P, C]
    of dst's dtype at idx [P] int32 (clamped to [0, S - 1]), in place;
    returns dst. ``csr``: ``row_csr(idx, S)``, or None to build it here."""
    if dst.device.type == "cpu":
        return row_scatter_add_plain_(dst, grad, idx)
    return _scatter(dst, grad, idx, csr, accumulate=True)


def row_scatter_add(grad: torch.Tensor, idx: torch.Tensor, num_rows: int,
                    csr=None) -> torch.Tensor:
    """grad [P, C] f32 or bf16, idx [P] int32 -> a new [num_rows, C] of
    grad's dtype (the adjoint of the gathers): the kernel writes every
    row, so the output is allocated uninitialised; with no index it is
    zeros, and nothing is launched.
    ``csr`` as for ``row_scatter_add_``."""
    if grad.device.type == "cpu":
        return row_scatter_add_plain(grad, idx, num_rows)
    make = torch.empty if idx.numel() else torch.zeros
    dst = make((num_rows, grad.shape[1]), dtype=grad.dtype,
               device=grad.device)
    return _scatter(dst, grad, idx, csr, accumulate=False)
