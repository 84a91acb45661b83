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
Features are logical NCHW; outputs are [B, R, C, P, P]. ``roi_align_levels``
is the multi-level (FPN) form in the JAX package's fixed shape: every ROI
pooled from every level, the ROI's own level kept by a mask sum.
"""

from __future__ import annotations

from typing import Sequence

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


def roi_align_levels(features: Sequence[torch.Tensor], rois: torch.Tensor,
                     levels: torch.Tensor, *, scales: Sequence[float],
                     output_size: int, sampling_ratio: int = 0,
                     max_samples: int = 8) -> torch.Tensor:
    """Multi-level ROIAlign: maps [B, C, H_l, W_l] at ``scales``, rois
    [B, R, 4], levels [B, R] (each ROI's index into the maps) ->
    [B, R, C, P, P]. A ROI whose level is none of the maps' gets zeros."""
    out = None
    for i, (feat, scale) in enumerate(zip(features, scales)):
        pooled = roi_align(feat, rois, spatial_scale=scale,
                           output_size=output_size,
                           sampling_ratio=sampling_ratio,
                           max_samples=max_samples)
        sel = (levels == i).to(pooled.dtype)[..., None, None, None]
        out = pooled * sel if out is None else out + pooled * sel
    return out


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


# ROIs a chunk of ``roi_pool_image``: its peak bound is in its docstring
ROI_POOL_CHUNK = 16


def _pool_bounds(start, bin_size, limit: int, pooled: int):
    """Each bin's [lo, hi) cells along one axis, [R, P] f32: floor/ceil of
    the bin edges with ROIPool's 1e-4 snap, shifted by the ROI's start and
    clipped to the map."""
    eps = 1e-4
    idx = torch.arange(pooled, dtype=torch.float32, device=start.device)
    lo = torch.floor(idx[None, :] * bin_size[:, None] + eps) + start[:, None]
    hi = torch.ceil((idx[None, :] + 1.0) * bin_size[:, None] - eps) \
        + start[:, None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def _range_max_table(features: torch.Tensor) -> torch.Tensor:
    """Sparse table of running maxima along H: [L, H, C, W] for features
    [C, H, W], level l holding max(F[:, y : y + 2^l]) at row y (rows whose
    window passes the map's end hold a shorter one, never read)."""
    levels = [features.permute(1, 0, 2)]
    step = 1
    while 2 * step <= features.shape[1]:
        prev = levels[-1]
        nxt = prev.clone()
        nxt[:-step] = torch.maximum(prev[:-step], prev[step:])
        levels.append(nxt)
        step *= 2
    return torch.stack(levels)


def roi_pool_image(features: torch.Tensor, rois: torch.Tensor, *,
                   spatial_scale: float, output_size: int) -> torch.Tensor:
    """ROIPool over one image (the reference's csrc/cuda/ROIPool_cuda.cu;
    the JAX package keeps it for capability parity, and no shipped YAML
    calls it): the max of each bin of each ROI, its coordinates rounded to
    the map's grid. features [C, H, W], rois [R, 4] xyxy in image
    coordinates -> [R, C, P, P] in the features' dtype.

    The bins are the JAX package's: ROI corners ``round(x * scale)``, its
    size at least 1, bin edges by floor / ceil with a 1e-4 snap, clipped to
    the map; an empty bin gives 0 (as does a bin whose max is not finite,
    as there). Differentiable by autograd: the gradient goes to each bin's
    max (ties share it). On the card the table's rows gather their
    gradient through the row reads' backward (``index_put_`` with
    accumulation, which sorts the row indices and adds each row's terms in
    order, without atomics), so a rerun gives the same bits.

    A separable max in place of JAX's one-hot form, which would hold
    [R, P, P, H, W, C]: the max over each bin's rows comes from a sparse
    table of running maxima along H (``_range_max_table``: two reads a bin
    and column), then each bin's columns from a masked max over W, for
    ``ROI_POOL_CHUNK`` ROIs at a time. Peak, in elements of the features'
    dtype, without autograd: the table's C·H·W·(⌊log2 H⌋ + 1), plus
    ``ROI_POOL_CHUNK``·(3P + P²)·C·W for a chunk (its two row reads, their
    max, the masked columns), plus the output. The flagship's C4 map
    (1024 × 38 × 76, P 7, chunks of 16) holds 17.7 M + 87.2 M elements,
    0.42 GB in float32. Under autograd each chunk keeps what its backward
    reads, so the peak grows with R."""
    c, h, w = features.shape
    p = output_size
    rois = rois.float()
    start_w = torch.round(rois[:, 0] * spatial_scale)
    start_h = torch.round(rois[:, 1] * spatial_scale)
    end_w = torch.round(rois[:, 2] * spatial_scale)
    end_h = torch.round(rois[:, 3] * spatial_scale)
    pooled_t = torch.full_like(start_w, p)
    bin_w = (end_w - start_w + 1.0).clamp(min=1.0) / pooled_t
    bin_h = (end_h - start_h + 1.0).clamp(min=1.0) / pooled_t
    ylo, yhi = (b.long() for b in _pool_bounds(start_h, bin_h, h, p))
    xlo, xhi = _pool_bounds(start_w, bin_w, w, p)
    # rows [lo, hi) of a bin: the max of the table's windows of 2^l rows at
    # lo and at hi - 2^l, l = floor(log2(hi - lo)), from one flat row index
    n = (yhi - ylo).clamp(min=1)
    lvl = torch.floor(torch.log2(n.double())).long()
    table = _range_max_table(features).reshape(-1, c * w)
    first = lvl * h + ylo.clamp(max=h - 1)
    second = lvl * h + (yhi - 2 ** lvl).clamp(min=0)
    empty_y = yhi <= ylo
    xs = torch.arange(w, dtype=torch.float32, device=features.device)
    in_x = (xs >= xlo[..., None]) & (xs < xhi[..., None])        # [R, P, W]
    neg = torch.tensor(float("-inf"), dtype=features.dtype,
                       device=features.device)
    out = []
    for i in range(0, rois.shape[0], ROI_POOL_CHUNK):
        j = slice(i, i + ROI_POOL_CHUNK)
        rows = torch.maximum(table[first[j].reshape(-1)],
                             table[second[j].reshape(-1)])
        rows = rows.view(-1, p, c, w)                           # [r, P, C, W]
        rows = torch.where(empty_y[j][..., None, None], neg, rows)
        cols = torch.where(in_x[j][:, None, :, None, :],
                           rows[:, :, None], neg).amax(-1)      # [r,P,P,C]
        out.append(cols.permute(0, 3, 1, 2))
    pooled = torch.cat(out) if out else features.new_zeros((0, c, p, p))
    return torch.where(torch.isfinite(pooled), pooled,
                       torch.zeros((), dtype=pooled.dtype,
                                   device=pooled.device))
