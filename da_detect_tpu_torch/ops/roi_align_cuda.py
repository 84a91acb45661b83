"""ROIAlign forward and backward as hand-written CUDA kernels for Hopper
(port of ``da_detect_tpu/ops/roi_align_pallas.py``: ``_pool_fwd_impl`` and
``_pool_bwd``; sources ``kernels/csrc/roi_align_fwd.cu`` and
``roi_align_bwd.cu``).

``roi_align`` on CUDA features is a ``torch.autograd.Function`` whose
forward is ``roi_align_forward`` and whose backward is
``roi_align_backward``, the gradient of the features; the ROIs take none
(proposals are stop-gradient). On CPU features it is the plain version
(``ops.roi_align``), which autograd differentiates. Each of the two kernel
wrappers launches its kernel on a CUDA tensor or raises, and runs its plain
version (``roi_align`` or ``roi_align_grad``) on a CPU tensor. The forward
kernel reads the
feature map in ``torch.channels_last`` memory and writes [B, R, P, P, C],
returned as the logical [B, R, C, P, P] view of that memory, so that
``reshape(B * R, C, P, P)`` is a channels-last batch for the res5 head. The
backward reads the gradient as a [B, R, P, P, C] view in its own strides
when its channels are contiguous (autograd's channels-last gradient: no
copy), copies it otherwise, and returns dF [B, C, H, W] in channels-last
memory, like the features. ``bwd_tiling`` sizes the backward kernel's
shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .roi_align import roi_align as roi_align_plain
from .roi_align import roi_align_grad as roi_align_grad_plain

FORWARD, BACKWARD = "roi_align_fwd", "roi_align_bwd"
_GEOMETRY = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
_ARGTYPES = {
    FORWARD: [ctypes.c_void_p] * 3 + _GEOMETRY + [ctypes.c_void_p],
    # grad and its 4 outer strides, rois, dF, geometry, tile columns, smem
    BACKWARD: [ctypes.c_void_p] + [ctypes.c_longlong] * 4
              + [ctypes.c_void_p] * 2 + _GEOMETRY
              + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}

# the backward kernel's block: a slice of BWD_CHANNELS channels
# (kChannels in roi_align_bwd.cu); its shared memory is sized to
# BWD_SMEM_TARGET where the map allows it, and never past SMEM_MAX, the
# most a block may have on sm_90
BWD_CHANNELS = 32
BWD_SMEM_TARGET = 48 * 1024
SMEM_MAX = 227 * 1024

_fns: dict = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(kernels.load(name), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_cuda(name: str, x: torch.Tensor, what: str, rois: torch.Tensor,
                sampling_ratio: int, max_samples: int) -> None:
    """Raise on what the kernels do not take; ``x`` is the operand with the
    channels last (the features' NHWC view, or the gradient)."""
    if x.device.type != "cuda":
        raise ValueError(f"ROIAlign kernel {name}: unsupported device "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"ROIAlign kernel {name}: {what} must be float32, "
                         f"got {x.dtype}")
    if x.shape[-1] % 4 or x.data_ptr() % 16:
        raise ValueError(f"ROIAlign kernel {name}: needs C % 4 == 0 and "
                         f"16-byte aligned {what} (C={x.shape[-1]})")
    if rois.dtype != torch.float32 or rois.dim() != 3 \
            or rois.shape[0] != x.shape[0] or rois.shape[2] != 4 \
            or rois.device != x.device:
        raise ValueError(f"ROIAlign kernel {name}: rois must be float32 "
                         f"[B, R, 4] on the {what} device, got {rois.dtype} "
                         f"{tuple(rois.shape)} on {rois.device}")
    if sampling_ratio <= 0 and max_samples <= 0:
        raise ValueError(f"ROIAlign kernel {name}: max_samples must be "
                         "positive")


def _launch(name: str, head: list, rois: torch.Tensor, h: int, w: int,
            c: int, p: int, spatial_scale: float, sampling_ratio: int,
            max_samples: int, tail: tuple = ()) -> None:
    """Launch ``name`` on the current stream with ``head`` (the arguments
    before the geometry: pointers, ROIs' included, and strides), the
    geometry, then ``tail``."""
    device = rois.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launcher(name)(*head, rois.shape[0], h, w, c, rois.shape[1], p,
                             float(spatial_scale), int(sampling_ratio),
                             int(max_samples), *tail, stream)
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1


def bwd_tiling(height: int, width: int, output_size: int,
               samples: int) -> tuple[int, int]:
    """(tile columns, dynamic shared memory bytes) of a backward block on an
    H x W map, P = ``output_size``, ``samples`` a bin side at most. The
    layout is roi_align_bwd.cu's: per column of the tile, U (P x
    BWD_CHANNELS floats), Ax (P) and the column's bin range (2 ints); fixed,
    the samples of both axes (16 B each), Ay over the rows (P x H) and each
    row's bin range, and the staged gradient (P x P x BWD_CHANNELS floats).
    As many columns as BWD_SMEM_TARGET holds, at least one and at most W;
    raises if one column passes SMEM_MAX."""
    p = output_size
    per_col = 4 * p * BWD_CHANNELS + 4 * p + 8
    fixed = 2 * 16 * p * samples + height * (4 * p + 8) \
        + 4 * p * p * BWD_CHANNELS
    cols = max(1, min(width, (BWD_SMEM_TARGET - fixed) // per_col))
    smem = fixed + cols * per_col
    if smem > SMEM_MAX:
        raise ValueError(f"ROIAlign backward kernel: a {height}-row map at "
                         f"P={p} needs {smem} B of shared memory a block, "
                         f"more than {SMEM_MAX}")
    return cols, smem


def grad_view(grad: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The [B, R, P, P, C] view of ``grad`` [B, R, C, P, P] the backward
    kernel reads, and whether it had to be copied: in place when the
    channels are contiguous, the other strides multiples of 4 and the base
    16-byte aligned (float4 reads), else a contiguous copy."""
    g = grad.permute(0, 1, 3, 4, 2)
    if g.stride(4) == 1 and all(s % 4 == 0 for s in g.stride()[:4]) \
            and g.data_ptr() % 16 == 0:
        return g, False
    return g.contiguous(), True


def roi_align_forward(features: torch.Tensor, rois: torch.Tensor, *,
                      spatial_scale: float, output_size: int,
                      sampling_ratio: int = 0,
                      max_samples: int = 8) -> torch.Tensor:
    """Batched ROIAlign: features [B, C, H, W] f32 (channels-last memory),
    rois [B, R, 4] f32 -> [B, R, C, P, P]. Not differentiable itself."""
    kw = dict(spatial_scale=spatial_scale, output_size=output_size,
              sampling_ratio=sampling_ratio, max_samples=max_samples)
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, **kw)
    if features.dim() != 4:
        raise ValueError("ROIAlign kernel: features must be [B, C, H, W], "
                         f"got {tuple(features.shape)}")
    batch, c, h, w = features.shape
    _check_cuda(FORWARD, features.permute(0, 2, 3, 1), "features", rois,
                sampling_ratio, max_samples)
    if not features.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("ROIAlign kernel: features must be channels_last")
    r, p = rois.shape[1], output_size
    out = torch.empty((batch, r, p, p, c), dtype=torch.float32,
                      device=features.device)
    if out.numel():
        rois = rois.contiguous()
        _launch(FORWARD, [features.data_ptr(), rois.data_ptr(),
                          out.data_ptr()], rois, h, w, c, p, spatial_scale,
                sampling_ratio, max_samples)
    return out.permute(0, 1, 4, 2, 3)


def roi_align_backward(grad: torch.Tensor, rois: torch.Tensor, *,
                       height: int, width: int, spatial_scale: float,
                       output_size: int, sampling_ratio: int = 0,
                       max_samples: int = 8) -> torch.Tensor:
    """d features of ROIAlign: grad [B, R, C, P, P] f32 (any strides),
    rois [B, R, 4] f32 -> dF [B, C, H, W] f32 in channels-last memory."""
    kw = dict(spatial_scale=spatial_scale, output_size=output_size,
              sampling_ratio=sampling_ratio, max_samples=max_samples)
    if grad.device.type == "cpu":
        return roi_align_grad_plain(grad, rois, height=height, width=width,
                                    **kw)
    if grad.dim() != 5 or grad.shape[3] != output_size \
            or grad.shape[4] != output_size:
        raise ValueError("ROIAlign backward kernel: grad must be "
                         f"[B, R, C, {output_size}, {output_size}], got "
                         f"{tuple(grad.shape)}")
    batch, r, c = grad.shape[:3]
    g, _ = grad_view(grad)
    _check_cuda(BACKWARD, g, "grad", rois, sampling_ratio, max_samples)
    dfeat = torch.zeros((batch, height, width, c), dtype=torch.float32,
                        device=grad.device)
    if g.numel() and dfeat.numel():
        cols, smem = bwd_tiling(height, width, output_size,
                                sampling_ratio if sampling_ratio > 0
                                else max_samples)
        rois = rois.contiguous()
        _launch(BACKWARD, [g.data_ptr(), *g.stride()[:4], rois.data_ptr(),
                           dfeat.data_ptr()], rois, height, width, c,
                output_size, spatial_scale, sampling_ratio, max_samples,
                (cols, smem))
    return dfeat.permute(0, 3, 1, 2)


class _RoIAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, rois, spatial_scale, output_size,
                sampling_ratio, max_samples):
        ctx.kw = dict(height=features.shape[2], width=features.shape[3],
                      spatial_scale=spatial_scale, output_size=output_size,
                      sampling_ratio=sampling_ratio, max_samples=max_samples)
        ctx.save_for_backward(rois)
        return roi_align_forward(features, rois, spatial_scale=spatial_scale,
                                 output_size=output_size,
                                 sampling_ratio=sampling_ratio,
                                 max_samples=max_samples)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        dfeat = None
        if ctx.needs_input_grad[0]:
            dfeat = roi_align_backward(grad, rois, **ctx.kw)
        return dfeat, None, None, None, None, None


def roi_align(features: torch.Tensor, rois: torch.Tensor, *,
              spatial_scale: float, output_size: int, sampling_ratio: int = 0,
              max_samples: int = 8) -> torch.Tensor:
    """Differentiable batched ROIAlign through the kernels: features
    [B, C, H, W] f32, rois [B, R, 4] f32 -> [B, R, C, P, P]."""
    if features.device.type == "cpu":
        return roi_align_plain(features, rois.detach(),
                               spatial_scale=spatial_scale,
                               output_size=output_size,
                               sampling_ratio=sampling_ratio,
                               max_samples=max_samples)
    return _RoIAlign.apply(features, rois.detach(), spatial_scale,
                           output_size, sampling_ratio, max_samples)
