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
memory, like the features. ``bwd_tiling`` and ``fwd_tiling`` size the
kernels' shared memory. The backward kernel sums each dF value in a fixed
order (no atomics): it is the same bit for bit from run to run.

Both kernels take float32 or bfloat16 (the compute dtype). In bfloat16 the
forward reads the map and writes the output in bfloat16, with float32
weights and sums and one rounding an output; the backward reads the
bfloat16 gradient, accumulates dF in float32 and returns it cast once to
bfloat16, the features' dtype (as the TPU kernel's caller does).

FPN pooling is one forward launch: ``roi_align_levels_forward`` takes up
to four levels and each ROI's level, and pools each ROI from its own level
only (plain version: ``ops.roi_align.roi_align_levels``, every ROI from
every level, then a mask). ``roi_align_levels`` is its autograd function;
its backward runs the backward kernel once a level on the gradient masked
to that level's ROIs.

The two forward wrappers check their inputs and call the operators
``da_detect::roi_align`` and ``roi_align_levels`` (``ops/library.py``):
on the card they launch the kernel (``launch_pool``), on the CPU they run
the plain versions. ``roi_align`` and ``roi_align_levels`` go through
their autograd functions only where a gradient is needed; otherwise they
are the forward wrappers, on either device.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import kernels
from .roi_align import roi_align as roi_align_plain
from .roi_align import roi_align_grad as roi_align_grad_plain
from .roi_align import roi_align_levels as roi_align_levels_plain

FORWARD, BACKWARD = "roi_align_fwd", "roi_align_bwd"
_ARGTYPES = {
    # per-level pointers, heights, widths and scales, the level count, each
    # ROI's level, rois, out, batch, C, R, P, sampling ratio, max samples,
    # tile pixels, smem, slices a block
    FORWARD: [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
              ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
              ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
             + [ctypes.c_void_p],
    # grad and its 4 outer strides, rois, dF, batch, H, W, C, R, P, scale,
    # sampling ratio, max samples, smem
    BACKWARD: [ctypes.c_void_p] + [ctypes.c_longlong] * 4
              + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
              + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}

# both kernels' block: a slice of BWD_CHANNELS channels (kChannels in the
# sources); the forward's shared memory is sized to FWD_SMEM_TARGET where the
# map allows it, and neither passes SMEM_MAX, the most a block may have on
# sm_90. A backward block owns a BWD_TILE x BWD_TILE pixel tile of dF (kTile)
# and tests BWD_CHUNK ROIs against it at a time (kChunk)
BWD_CHANNELS = 32
BWD_TILE = 16
BWD_CHUNK = 1024
FWD_SMEM_TARGET = 48 * 1024
SMEM_MAX = 227 * 1024
# the levels one forward launch takes (kMaxLevels in roi_align_fwd.cu)
MAX_LEVELS = 4
# forward blocks a launch aims at: a few waves of the 4 blocks an H100 SM
# holds (132 SMs); fewer ROIs or channels give fewer blocks
FWD_BLOCKS_TARGET = 4 * 4 * 132

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

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


def _per16(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in a 16-byte word."""
    return 16 // dtype.itemsize


def _check_cuda(name: str, x: torch.Tensor, what: str, rois: torch.Tensor,
                sampling_ratio: int, max_samples: int) -> None:
    """Raise on what the kernels do not take; ``x`` is the operand with the
    channels last (the features' NHWC view, or the gradient)."""
    if x.device.type != "cuda":
        raise ValueError(f"ROIAlign kernel {name}: unsupported device "
                         f"{x.device}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"ROIAlign kernel {name}: {what} must be float32 "
                         f"or bfloat16, got {x.dtype}")
    per = _per16(x.dtype)
    if x.shape[-1] % per:
        raise ValueError(f"ROIAlign kernel {name}: needs C % {per} == 0 and "
                         f"16-byte aligned {what} (C={x.shape[-1]}, "
                         f"{x.dtype})")
    if rois.dtype != torch.float32 or rois.dim() != 3 \
            or rois.shape[0] != x.shape[0] or rois.shape[2] != 4 \
            or rois.device != x.device:
        raise ValueError(f"ROIAlign kernel {name}: rois must be float32 "
                         f"[B, R, 4] on the {what} device, got {rois.dtype} "
                         f"{tuple(rois.shape)} on {rois.device}")
    if sampling_ratio <= 0 and max_samples <= 0:
        raise ValueError(f"ROIAlign kernel {name}: max_samples must be "
                         "positive")


def _check_aligned(name: str, x: torch.Tensor, what: str) -> None:
    """Raise unless ``x``'s memory starts 16-byte aligned: a check of the
    real tensor at launch (a traced tensor has no address)."""
    if x.data_ptr() % 16:
        raise ValueError(f"ROIAlign kernel {name}: needs 16-byte aligned "
                         f"{what}")


def _launch(name: str, dtype: torch.dtype, device: torch.device,
            args: list) -> None:
    """Launch ``name``'s ``dtype`` variant with ``args`` on the current
    stream of ``device``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launcher(name, dtype)(*args, stream)
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1


def fwd_tiling(height: int, width: int, output_size: int,
               samples: int, elem_bytes: int = 4) -> tuple[int, int]:
    """(tile pixels, dynamic shared memory bytes) of a forward block on an
    H x W map of ``elem_bytes`` elements (4: float32, 2: bfloat16), P =
    ``output_size``, ``samples`` a bin side at most. The layout is
    roi_align_fwd.cu's: two buffers of the tile's pixels (BWD_CHANNELS
    elements each), the samples of both axes (16 B each) and each bin's span
    on both axes (8 B each). As many pixels as FWD_SMEM_TARGET holds, at
    least one and at most H x W; raises if one pixel passes SMEM_MAX."""
    p = output_size
    per_pixel = 2 * elem_bytes * BWD_CHANNELS
    fixed = 2 * 16 * p * samples + 2 * 8 * p
    tile = max(1, min(height * width,
                      (FWD_SMEM_TARGET - fixed) // per_pixel))
    smem = fixed + tile * per_pixel
    if smem > SMEM_MAX:
        raise ValueError(f"ROIAlign forward kernel: P={p} at {samples} "
                         f"samples a bin side needs {smem} B of shared "
                         f"memory a block, more than {SMEM_MAX}")
    return tile, smem


def bwd_tiling(height: int, width: int, output_size: int,
               samples: int, elem_bytes: int = 4) -> tuple[int, int]:
    """(tiles, dynamic shared memory bytes) of the backward launch on an
    H x W map, P = ``output_size``, ``samples`` a bin side at most, for a
    gradient of ``elem_bytes`` elements (4: float32, 2: bfloat16): the
    BWD_TILE x BWD_TILE pixel tiles that cover the map (a block each, a
    channel slice and image), and roi_align_bwd.cu's layout: the staged
    gradient (P x P x BWD_CHANNELS elements of the gradient's type), U (P x
    BWD_TILE x BWD_CHANNELS floats), the samples of both axes (16 B each),
    Ay and Ax over the tile (P x BWD_TILE floats each), each tile row's and
    column's bin range (2 ints) and a byte a ROI of a chunk. Raises if the
    layout passes SMEM_MAX."""
    p, t = output_size, BWD_TILE
    smem = elem_bytes * p * p * BWD_CHANNELS + 4 * p * t * BWD_CHANNELS \
        + 2 * 16 * p * samples + 2 * 4 * p * t + 2 * 8 * t + BWD_CHUNK
    if smem > SMEM_MAX:
        raise ValueError(f"ROIAlign backward kernel: P={p} at {samples} "
                         f"samples a bin side needs {smem} B of shared "
                         f"memory a block, more than {SMEM_MAX}")
    return -(-height // t) * -(-width // t), smem


def fwd_slices(channels: int, rois: int, batch: int) -> int:
    """BWD_CHANNELS-channel slices a forward block pools: as many as keep
    the launch at FWD_BLOCKS_TARGET blocks or more, spread evenly over the
    blocks of a ROI (the ROI's geometry is computed once a block)."""
    n = -(-channels // BWD_CHANNELS)
    runs = -(-n // max(1, min(n, n * rois * batch // FWD_BLOCKS_TARGET)))
    return -(-n // runs)


def grad_view(grad: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The [B, R, P, P, C] view of ``grad`` [B, R, C, P, P] the backward
    kernel reads, and whether it had to be copied: in place when the
    channels are contiguous, the other strides 16 bytes' multiples and the
    base 16-byte aligned (16-byte copies), else a contiguous copy."""
    g = grad.permute(0, 1, 3, 4, 2)
    per = _per16(grad.dtype)
    if g.stride(4) == 1 and all(s % per == 0 for s in g.stride()[:4]) \
            and g.data_ptr() % 16 == 0:
        return g, False
    return g.contiguous(), True


def _pool(features: Sequence[torch.Tensor], rois: torch.Tensor,
          levels: torch.Tensor | None, scales: Sequence[float],
          output_size: int, sampling_ratio: int,
          max_samples: int) -> torch.Tensor:
    """Check the shapes, dtypes and devices of 1 to MAX_LEVELS maps
    [B, C, H_l, W_l] f32 or bf16 (one dtype) on the card, ``scales``, ROIs
    and ``levels`` [B, R] (int32 or int64; None: one map), then call the
    operator: [B, R, C, P, P] in the maps' dtype."""
    if not 1 <= len(features) <= MAX_LEVELS or len(scales) != len(features):
        raise ValueError(f"ROIAlign kernel: 1 to {MAX_LEVELS} maps, one "
                         f"scale each, got {len(features)} maps and "
                         f"{len(scales)} scales")
    for f in features:
        if f.dim() != 4:
            raise ValueError("ROIAlign kernel: features must be "
                             f"[B, C, H, W], got {tuple(f.shape)}")
        _check_cuda(FORWARD, f.permute(0, 2, 3, 1), "features", rois,
                    sampling_ratio, max_samples)
    batch, c = features[0].shape[:2]
    dtype = features[0].dtype
    if any(f.shape[:2] != (batch, c) or f.device != rois.device
           or f.dtype != dtype for f in features):
        raise ValueError("ROIAlign kernel: the levels must share B, C, the "
                         "dtype and the device, got "
                         f"{[(tuple(f.shape), f.dtype) for f in features]}")
    kw = (output_size, int(sampling_ratio), int(max_samples))
    if levels is None:
        return torch.ops.da_detect.roi_align(features[0], rois,
                                             float(scales[0]), *kw)
    if levels.shape != (batch, rois.shape[1]) \
            or levels.device != rois.device \
            or levels.dtype not in (torch.int32, torch.int64):
        raise ValueError("ROIAlign kernel: levels must be int32 or int64 "
                         f"[B, R] on the ROIs' device, got {levels.dtype} "
                         f"{tuple(levels.shape)} on {levels.device}")
    return torch.ops.da_detect.roi_align_levels(
        list(features), rois, levels.to(torch.int64),
        [float(x) for x in scales], *kw)


def launch_pool(features: Sequence[torch.Tensor], rois: torch.Tensor,
                levels: torch.Tensor | None, scales: Sequence[float],
                output_size: int, sampling_ratio: int,
                max_samples: int) -> torch.Tensor:
    """One forward launch on inputs ``_pool`` checked: the operators' CUDA
    implementation. The maps' memory is checked here, on the real tensors
    (channels-last, 16-byte aligned): a traced map's strides are the fake
    convolution's guess, and it has no address."""
    for f in features:
        if not f.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("ROIAlign kernel: features must be "
                             "channels_last")
        _check_aligned(FORWARD, f, "features")
    batch, c = features[0].shape[:2]
    dtype = features[0].dtype
    r, p = rois.shape[1], output_size
    out = torch.empty((batch, r, p, p, c), dtype=dtype, device=rois.device)
    if out.numel():
        samples = sampling_ratio if sampling_ratio > 0 else max_samples
        tile, smem = max(fwd_tiling(f.shape[2], f.shape[3], p, samples,
                                    out.element_size()) for f in features)
        n = len(features)
        rois = rois.contiguous()
        if levels is not None:
            levels = levels.to(torch.int64).contiguous()
        _launch(FORWARD, dtype, rois.device, [
            (ctypes.c_void_p * n)(*[f.data_ptr() for f in features]),
            (ctypes.c_int * n)(*[f.shape[2] for f in features]),
            (ctypes.c_int * n)(*[f.shape[3] for f in features]),
            (ctypes.c_float * n)(*[float(s) for s in scales]), n,
            None if levels is None else levels.data_ptr(), rois.data_ptr(),
            out.data_ptr(), batch, c, r, p, int(sampling_ratio),
            int(max_samples), tile, smem, fwd_slices(c, r, batch)])
    return out.permute(0, 1, 4, 2, 3)


def roi_align_forward(features: torch.Tensor, rois: torch.Tensor, *,
                      spatial_scale: float, output_size: int,
                      sampling_ratio: int = 0,
                      max_samples: int = 8) -> torch.Tensor:
    """Batched ROIAlign: features [B, C, H, W] f32 or bf16 (channels-last
    memory), rois [B, R, 4] f32 -> [B, R, C, P, P] in the features' dtype.
    Not differentiable itself."""
    if features.device.type == "cpu":
        return torch.ops.da_detect.roi_align(
            features, rois, float(spatial_scale), output_size,
            int(sampling_ratio), int(max_samples))
    return _pool([features], rois, None, [spatial_scale], output_size,
                 sampling_ratio, max_samples)


def roi_align_levels_forward(features: Sequence[torch.Tensor],
                             rois: torch.Tensor, levels: torch.Tensor, *,
                             scales: Sequence[float], output_size: int,
                             sampling_ratio: int = 0,
                             max_samples: int = 8) -> torch.Tensor:
    """Multi-level ROIAlign in one launch: maps [B, C, H_l, W_l] f32 or
    bf16 (channels-last memory) at ``scales``, rois [B, R, 4] f32, levels
    [B, R] (each ROI's index into the maps) -> [B, R, C, P, P] in the maps'
    dtype, each ROI pooled from its own level. Not differentiable itself."""
    if features[0].device.type == "cpu":
        return torch.ops.da_detect.roi_align_levels(
            list(features), rois, levels, [float(x) for x in scales],
            output_size, int(sampling_ratio), int(max_samples))
    return _pool(features, rois, levels, scales, output_size, sampling_ratio,
                 max_samples)


def roi_align_backward(grad: torch.Tensor, rois: torch.Tensor, *,
                       height: int, width: int, spatial_scale: float,
                       output_size: int, sampling_ratio: int = 0,
                       max_samples: int = 8) -> torch.Tensor:
    """d features of ROIAlign: grad [B, R, C, P, P] f32 or bf16 (any
    strides), rois [B, R, 4] f32 -> dF [B, C, H, W] in the gradient's dtype
    and channels-last memory (summed in float32, cast once)."""
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
    _check_aligned(BACKWARD, g, "grad")
    # the kernel writes every value of dF; with no ROI it does not run
    dfeat = (torch.empty if g.numel() else torch.zeros)(
        (batch, height, width, c), dtype=torch.float32, device=grad.device)
    if g.numel() and dfeat.numel():
        _, smem = bwd_tiling(height, width, output_size,
                             sampling_ratio if sampling_ratio > 0
                             else max_samples, g.element_size())
        rois = rois.contiguous()
        _launch(BACKWARD, g.dtype, rois.device, [
            g.data_ptr(), *g.stride()[:4], rois.data_ptr(), dfeat.data_ptr(),
            batch, height, width, c, r, output_size, float(spatial_scale),
            int(sampling_ratio), int(max_samples), smem])
    return dfeat.to(grad.dtype).permute(0, 3, 1, 2)


def _needs_grad(features: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(f.requires_grad
                                           for f in features)


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
    [B, C, H, W] f32 or bf16, rois [B, R, 4] f32 -> [B, R, C, P, P]."""
    if not _needs_grad([features]):
        return roi_align_forward(features, rois.detach(),
                                 spatial_scale=spatial_scale,
                                 output_size=output_size,
                                 sampling_ratio=sampling_ratio,
                                 max_samples=max_samples)
    if features.device.type == "cpu":
        return roi_align_plain(features, rois.detach(),
                               spatial_scale=spatial_scale,
                               output_size=output_size,
                               sampling_ratio=sampling_ratio,
                               max_samples=max_samples)
    return _RoIAlign.apply(features, rois.detach(), spatial_scale,
                           output_size, sampling_ratio, max_samples)


class _RoIAlignLevels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rois, levels, kw, *features):
        ctx.kw = kw
        ctx.shapes = [f.shape[2:] for f in features]
        ctx.save_for_backward(rois, levels)
        return roi_align_levels_forward(features, rois, levels, **kw)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        kw = dict(ctx.kw)
        scales = kw.pop("scales")
        dfeats = []
        for i, ((h, w), scale) in enumerate(zip(ctx.shapes, scales)):
            if not ctx.needs_input_grad[3 + i]:
                dfeats.append(None)
                continue
            sel = (levels == i).to(grad.dtype)[..., None, None, None]
            dfeats.append(roi_align_backward(grad * sel, rois, height=h,
                                             width=w, spatial_scale=scale,
                                             **kw))
        return (None, None, None, *dfeats)


def roi_align_levels(features: Sequence[torch.Tensor], rois: torch.Tensor,
                     levels: torch.Tensor, *, scales: Sequence[float],
                     output_size: int, sampling_ratio: int = 0,
                     max_samples: int = 8) -> torch.Tensor:
    """Differentiable multi-level ROIAlign through the kernels: maps
    [B, C, H_l, W_l] f32 or bf16 at ``scales``, rois [B, R, 4] f32, levels
    [B, R] -> [B, R, C, P, P]; one forward launch, and a backward launch a
    level.
    On CPU maps the plain version, which autograd differentiates."""
    kw = dict(scales=tuple(scales), output_size=output_size,
              sampling_ratio=sampling_ratio, max_samples=max_samples)
    if not _needs_grad(features):
        return roi_align_levels_forward(features, rois.detach(), levels, **kw)
    if features[0].device.type == "cpu":
        return roi_align_levels_plain(features, rois.detach(), levels, **kw)
    return _RoIAlignLevels.apply(rois.detach(), levels, kw, *features)
