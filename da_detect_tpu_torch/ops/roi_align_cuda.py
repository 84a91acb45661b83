"""ROIAlign forward as a hand-written CUDA kernel for Hopper (port of
``da_detect_tpu/ops/roi_align_pallas.py``, forward only; source
``kernels/csrc/roi_align_fwd.cu``).

``roi_align`` takes the plain version's arguments. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the plain version,
``ops.roi_align.roi_align``. The kernel reads the feature map in
``torch.channels_last`` memory and writes [B, R, P, P, C]; the result is
returned as the logical [B, R, C, P, P] view of that memory, so that
``reshape(B * R, C, P, P)`` is a channels-last batch for the res5 head.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .roi_align import roi_align as roi_align_plain

KERNEL = "roi_align_fwd"

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = kernels.load(KERNEL).roi_align_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def roi_align(features: torch.Tensor, rois: torch.Tensor, *,
              spatial_scale: float, output_size: int, sampling_ratio: int = 0,
              max_samples: int = 8) -> torch.Tensor:
    """Batched ROIAlign: features [B, C, H, W] f32 (channels-last memory),
    rois [B, R, 4] f32 -> [B, R, C, P, P]."""
    device = features.device
    if device.type == "cpu":
        return roi_align_plain(features, rois, spatial_scale=spatial_scale,
                               output_size=output_size,
                               sampling_ratio=sampling_ratio,
                               max_samples=max_samples)
    if device.type != "cuda":
        raise ValueError(f"ROIAlign kernel: unsupported device {device}")
    if features.dtype != torch.float32 or features.dim() != 4:
        raise ValueError("ROIAlign kernel: features must be float32 "
                         f"[B, C, H, W], got {features.dtype} "
                         f"{tuple(features.shape)}")
    batch, c, h, w = features.shape
    if not features.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("ROIAlign kernel: features must be channels_last")
    if c % 4 or features.data_ptr() % 16:
        raise ValueError("ROIAlign kernel: needs C % 4 == 0 and a 16-byte "
                         f"aligned map (C={c})")
    if rois.dtype != torch.float32 or rois.dim() != 3 \
            or rois.shape[0] != batch or rois.shape[2] != 4 \
            or rois.device != device:
        raise ValueError("ROIAlign kernel: rois must be float32 [B, R, 4] on "
                         f"the features' device, got {rois.dtype} "
                         f"{tuple(rois.shape)} on {rois.device}")
    if sampling_ratio <= 0 and max_samples <= 0:
        raise ValueError("ROIAlign kernel: max_samples must be positive")
    r, p = rois.shape[1], output_size
    out = torch.empty((batch, r, p, p, c), dtype=torch.float32, device=device)
    if out.numel():
        rois = rois.contiguous()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _launcher()(features.data_ptr(), rois.data_ptr(),
                             out.data_ptr(), batch, h, w, c, r, p,
                             float(spatial_scale), int(sampling_ratio),
                             int(max_samples), stream)
        kernels.check(rc, KERNEL)
        kernels.LAUNCHES[KERNEL] += 1
    return out.permute(0, 1, 4, 2, 3)
