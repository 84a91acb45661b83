"""Row gathers as hand-written CUDA kernels for Hopper (port of the two TPU
kernels of ``scripts/bench_gather_pallas.py``: ``make_gather(...).run`` and
``make_dma_gather(...).run``; sources ``kernels/csrc/row_gather.cu`` and
``row_gather_bulk.cu``).

Both compute ``out[i] = table[clamp(idx[i], 0, S - 1)]`` for a table [S, C]
in float32 or bfloat16 whose rows may lie ``table.stride(0)`` elements apart
(a column slice of a wider map), and int32 indices [P]; they return a new
contiguous [P, C]. ``row_gather`` moves a row with one warp's 16-byte loads;
``row_gather_bulk`` with one bulk copy (TMA) a row and needs 16-byte aligned
rows. On a CUDA tensor each launches its kernel or raises; on a CPU tensor
it runs the plain version, ``ops.gather.row_gather``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .gather import row_gather as row_gather_plain

GATHER, BULK = "row_gather", "row_gather_bulk"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]

_fns: dict = {}


def _launcher(name: str, dtype: torch.dtype):
    key = (name, dtype)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(kernels.load(name), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def _check(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"gather kernel {name}: unsupported device "
                         f"{table.device}")
    if table.dtype not in _SUFFIX:
        raise ValueError(f"gather kernel {name}: table must be float32 or "
                         f"bfloat16, got {table.dtype}")
    if table.dim() != 2 or table.stride(1) != 1 \
            or table.stride(0) < table.shape[1]:
        raise ValueError(f"gather kernel {name}: table must be [S, C] with "
                         f"unit column stride, got {tuple(table.shape)} "
                         f"strides {table.stride()}")
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or idx.device != table.device:
        raise ValueError(f"gather kernel {name}: idx must be int32 [P] on "
                         f"the table's device, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if table.shape[0] == 0 and idx.numel():
        raise ValueError(f"gather kernel {name}: empty table")


def _launch(name: str, table: torch.Tensor, idx: torch.Tensor
            ) -> torch.Tensor:
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel():
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            rc = _launcher(name, table.dtype)(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                idx.shape[0], table.shape[0], table.shape[1],
                table.stride(0), stream)
        kernels.check(rc, name)
        kernels.LAUNCHES[name] += 1
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [S, C] f32/bf16, idx [P] int32 -> [P, C] (the warp kernel)."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    _check(GATHER, table, idx)
    return _launch(GATHER, table, idx)


def row_gather_bulk(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [S, C] f32/bf16, idx [P] int32 -> [P, C] (one bulk copy a
    row). Rows must be 16-byte aligned: C * itemsize, the row stride in
    bytes and the table's address multiples of 16."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    _check(BULK, table, idx)
    item = table.element_size()
    if (table.shape[1] * item) % 16 or (table.stride(0) * item) % 16 \
            or table.data_ptr() % 16:
        raise ValueError(f"gather kernel {BULK}: rows must be 16-byte "
                         f"aligned (C={table.shape[1]}, row stride "
                         f"{table.stride(0)}, {table.dtype})")
    if table.shape[1] * item > 227 * 1024:
        raise ValueError(f"gather kernel {BULK}: a row of "
                         f"{table.shape[1] * item} B exceeds a block's "
                         "shared memory")
    return _launch(BULK, table, idx)
