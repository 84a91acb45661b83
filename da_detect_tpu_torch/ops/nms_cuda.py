"""Greedy NMS keep mask as a hand-written CUDA kernel for Hopper (port of
``da_detect_tpu/ops/nms_pallas.py``; source ``kernels/csrc/nms.cu``).

``nms_mask_sorted`` takes score-descending boxes, like
``nms_mask_pallas_sorted``, and optionally ``max_keep``: the mask then ends
after its ``max_keep``-th kept box, and the kernel's walk stops there. It
checks its inputs and calls the operator ``da_detect::nms_keep``
(``ops/library.py``): on a CUDA tensor that launches the kernel
(``launch``) or raises; on a CPU tensor it runs the plain version,
``ops.nms.nms_mask_sorted``. Callers reach it through
``ops.nms.nms_mask``/``nms_topk`` with ``impl="cuda"``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

KERNEL = "nms"

# the walk block keeps a word a 64 boxes (each block's kept bits) of one
# image in shared memory: 48 KB at this limit
MAX_BOXES = 48 * 1024 // 8 * 64

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = kernels.load(KERNEL).nms_keep_mask
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def nms_mask_sorted(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                    iou_threshold: float,
                    max_keep: int | None = None) -> torch.Tensor:
    """Keep mask over score-descending boxes [B, N, 4] f32 with valid [B, N]
    bool -> [B, N] bool. Legacy +1 widths; IoU > threshold suppresses. With
    ``max_keep``, only the first ``max_keep`` kept boxes of each image."""
    device = boxes_sorted.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"NMS kernel: unsupported device {device}")
    if max_keep is not None and max_keep < 1:
        raise ValueError(f"NMS kernel: max_keep must be >= 1, got {max_keep}")
    if device.type == "cuda":
        if boxes_sorted.dtype != torch.float32 or boxes_sorted.dim() != 3 \
                or boxes_sorted.shape[2] != 4:
            raise ValueError("NMS kernel: boxes must be float32 [B, N, 4], "
                             f"got {boxes_sorted.dtype} "
                             f"{tuple(boxes_sorted.shape)}")
        batch, n = boxes_sorted.shape[:2]
        if valid_sorted.shape != (batch, n) or valid_sorted.device != device:
            raise ValueError("NMS kernel: valid must be [B, N] on the boxes' "
                             f"device, got {tuple(valid_sorted.shape)}")
        if n > MAX_BOXES:
            raise ValueError(f"NMS kernel: N={n} exceeds {MAX_BOXES}")
    return torch.ops.da_detect.nms_keep(boxes_sorted, valid_sorted,
                                        float(iou_threshold), max_keep or 0)


def launch(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
           iou_threshold: float, max_keep: int) -> torch.Tensor:
    """The kernel's launch on checked CUDA inputs (``max_keep`` 0: the whole
    mask): the operator's CUDA implementation."""
    device = boxes_sorted.device
    batch, n = boxes_sorted.shape[:2]
    keep = torch.empty((batch, n), dtype=torch.uint8, device=device)
    if batch == 0 or n == 0:
        return keep.bool()
    boxes = boxes_sorted.contiguous()
    valid = valid_sorted.to(torch.uint8).contiguous()
    col_blocks = -(-n // 64)
    # one 64-word tile a (row block, column block) pair
    mask = torch.empty((batch, col_blocks, col_blocks, 64), dtype=torch.int64,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launcher()(boxes.data_ptr(), valid.data_ptr(),
                         float(iou_threshold), batch, n, min(max_keep, n),
                         mask.data_ptr(), keep.data_ptr(), stream)
    kernels.check(rc, KERNEL)
    kernels.LAUNCHES[KERNEL] += 1
    return keep.bool()
