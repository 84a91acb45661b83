"""ROIAlign, plain PyTorch (port of ``da_detect_tpu/ops/roi_align.py``).

The reference's original non-aligned ROIAlign (no -0.5 half-pixel offset),
written as the JAX package writes it: bilinear sampling is separable, so each
ROI's pooling is two small contractions with interpolation matrices

    pooled = Ay @ F @ Ax^T        Ay: [P, H], Ax: [P, W]

whose rows hold the bilinear weights of a bin's samples, pre-summed and
averaged. Numerics: no coordinate rounding, ROI sizes clamped to >= 1, the
-1/size out-of-bounds rule, edge clamping, and ``sampling_ratio == 0``
meaning ceil(roi / P) samples a bin side, capped at ``max_samples``.

This is the plain version of the CUDA kernel in ``ops/roi_align_cuda.py``.
Features are logical NCHW; outputs are [B, R, C, P, P].
"""

from __future__ import annotations

import torch


def _interp_matrix(starts, bin_sizes, grids, axis_size: int, pooled: int,
                   max_samples: int) -> torch.Tensor:
    """Per-ROI separable interpolation matrix, pre-summed over samples.

    starts, bin_sizes, grids [R] f32 (grids: samples a bin, <= max_samples).
    Returns [R, pooled, axis_size] with the 1/grid average folded in."""
    dev = starts.device
    ph = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    iy = torch.arange(max_samples, dtype=torch.float32,
                      device=dev)[None, None, :]
    g = grids[:, None, None]
    coords = (starts[:, None, None] + ph * bin_sizes[:, None, None]
              + (iy + 0.5) * bin_sizes[:, None, None] / g)      # [R, P, S]
    sample_ok = iy < g
    inb = (coords >= -1.0) & (coords <= axis_size)              # CUDA oob rule
    cc = coords.clamp(0.0, axis_size - 1)
    grid_pos = torch.arange(axis_size, dtype=torch.float32, device=dev)
    w = (1.0 - (cc[..., None] - grid_pos).abs()).clamp(min=0.0)  # [R,P,S,A]
    w = torch.where((sample_ok & inb)[..., None], w, 0.0) / g[..., None]
    return w.sum(dim=2)                                          # [R, P, A]


def _roi_grid(rois, spatial_scale: float, pooled: int, sampling_ratio: int,
              max_samples: int):
    """Shared ROI preamble: start/size with the >= 1 clamp, bin sizes and
    the per-ROI sample grid. rois [..., 4] f32. Returns (start_h, start_w,
    bin_h, bin_w, grid_h, grid_w)."""
    s = sampling_ratio if sampling_ratio > 0 else max_samples
    start_w = rois[..., 0] * spatial_scale
    start_h = rois[..., 1] * spatial_scale
    roi_w = (rois[..., 2] * spatial_scale - start_w).clamp(min=1.0)
    roi_h = (rois[..., 3] * spatial_scale - start_h).clamp(min=1.0)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which can miss the IEEE quotient the kernel
    # computes by an ulp, and `ph * bin` carries that into the samples
    pooled_t = torch.full_like(roi_w, pooled)
    bin_w = roi_w / pooled_t
    bin_h = roi_h / pooled_t
    if sampling_ratio > 0:
        grid_h = torch.full_like(roi_h, s)
        grid_w = torch.full_like(roi_w, s)
    else:
        grid_h = torch.ceil(roi_h / pooled_t).clamp(1, s)
        grid_w = torch.ceil(roi_w / pooled_t).clamp(1, s)
    return start_h, start_w, bin_h, bin_w, grid_h, grid_w


def roi_align_image(features: torch.Tensor, rois: torch.Tensor, *,
                    spatial_scale: float, output_size: int,
                    sampling_ratio: int = 0,
                    max_samples: int = 8) -> torch.Tensor:
    """ROIAlign over one image. features [C, H, W], rois [R, 4] xyxy in
    image coordinates. Returns [R, C, P, P]."""
    _, h, w = features.shape
    p = output_size
    rois = rois.float()
    s = sampling_ratio if sampling_ratio > 0 else max_samples
    start_h, start_w, bin_h, bin_w, grid_h, grid_w = _roi_grid(
        rois, spatial_scale, p, sampling_ratio, max_samples)
    ay = _interp_matrix(start_h, bin_h, grid_h, h, p, s).to(features.dtype)
    ax = _interp_matrix(start_w, bin_w, grid_w, w, p, s).to(features.dtype)
    # contract the larger spatial axis first: smaller intermediate
    if w >= h:
        t = torch.einsum("rqw,chw->rqch", ax, features)
        return torch.einsum("rph,rqch->rcpq", ay, t)
    t = torch.einsum("rph,chw->rpcw", ay, features)
    return torch.einsum("rqw,rpcw->rcpq", ax, t)


def roi_align(features: torch.Tensor, rois: torch.Tensor, *,
              spatial_scale: float, output_size: int, sampling_ratio: int = 0,
              max_samples: int = 8) -> torch.Tensor:
    """Batched ROIAlign: features [B, C, H, W], rois [B, R, 4] ->
    [B, R, C, P, P]. Differentiable in ``features`` by autograd."""
    return torch.stack([
        roi_align_image(f, r, spatial_scale=spatial_scale,
                        output_size=output_size,
                        sampling_ratio=sampling_ratio,
                        max_samples=max_samples)
        for f, r in zip(features, rois)])


def roi_align_grad(grad: torch.Tensor, rois: torch.Tensor, *, height: int,
                   width: int, spatial_scale: float, output_size: int,
                   sampling_ratio: int = 0,
                   max_samples: int = 8) -> torch.Tensor:
    """d features of ``roi_align`` for the upstream gradient grad
    [B, R, C, P, P] -> [B, C, H, W]: autograd of ``roi_align`` itself, which
    is linear in the features, so a zero map of the shape stands for any.
    The plain version of the CUDA backward kernel; ROIs take no gradient."""
    with torch.enable_grad():
        f = grad.new_zeros((grad.shape[0], grad.shape[2], height, width),
                           requires_grad=True)
        out = roi_align(f, rois.detach(), spatial_scale=spatial_scale,
                        output_size=output_size,
                        sampling_ratio=sampling_ratio,
                        max_samples=max_samples)
        (dfeat,) = torch.autograd.grad(out, f, grad.detach())
    return dfeat
