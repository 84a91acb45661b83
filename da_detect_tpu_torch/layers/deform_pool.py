"""Deformable position-sensitive ROI pooling (port of
``da_detect_tpu/layers/deform_pool.py``; DCN's ``DeformRoIPooling``).

Position-sensitive score maps ``features`` [H, W, P*P*C'] (one image,
channels last, bin-major: the channels of bin ``ph * P + pw`` are
``[bin * C', (bin + 1) * C')``) are pooled into [R, P, P, C']: each bin of
each ROI averages ``sample_per_part``^2 bilinear samples of its own channel
group, the samples moved by the bin's learned offset (``offsets`` [R, P, P,
2] normalized (dx, dy), scaled by ``trans_std`` and the ROI's size). The
ROI is rounded and its sides clamped to at least 0.1, as in the reference
kernel; a sample off the map reads zeros.

The corner takes are one row gather: the map viewed as a table of
[H*W*P*P, C'] rows (no copy: bin-major channels make row ``(y * W + x) *
P*P + bin`` the bin's C' values at pixel (y, x)), and every corner of every
sample of every bin one index into it, corner-major, so one launch serves
all bins. ``impl`` "cuda" takes them through ``ops/gather_cuda.py``: on a
CUDA map the row-gather kernel, whose backward is the scatter-add kernel
(summing each map row's sources in a fixed order through the indices'
CSR); on a CPU map the plain version. ``impl`` "plain" through
``ops/gather.py``. The corner sum runs in the JAX package's order, ``w0*v0
+ w1*v1 + w2*v2 + w3*v3``, with out-of-map corners' weights zero; the
offsets' gradients flow through the bilinear weights in plain autograd.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import gather, gather_cuda
from .deform_conv import _corner_indices


def _take(impl: str):
    if impl == "cuda":
        return gather_cuda.row_gather
    if impl == "plain":
        return gather.row_gather
    raise ValueError(f"unknown gather impl: {impl!r}")


def deform_ps_roi_pool(features: torch.Tensor, rois: torch.Tensor,
                       offsets: torch.Tensor | None, *, spatial_scale: float,
                       output_size: int, out_channels: int,
                       sample_per_part: int = 4, trans_std: float = 0.1,
                       impl: str = "cuda") -> torch.Tensor:
    """features [H, W, P*P*C'] float32; rois [R, 4] xyxy image coords;
    offsets [R, P, P, 2] normalized (or None) -> [R, P, P, out_channels]."""
    take = _take(impl)
    p, s = output_size, sample_per_part
    h, w, ch = features.shape
    cpp = ch // (p * p)
    rois = rois.float()
    # reference kernel: rounded roi, sizes clamped >= 0.1
    x1 = torch.round(rois[:, 0]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 2]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    bin_w, bin_h = rw / p, rh / p
    sub_w, sub_h = bin_w / s, bin_h / s

    f32 = dict(dtype=torch.float32, device=features.device)
    ph = torch.arange(p, **f32)
    iy = torch.arange(s, **f32)
    # sample grid per (bin, subsample): [R, P, S]
    ys = (y1[:, None, None] + ph[None, :, None] * bin_h[:, None, None]
          + (iy[None, None, :] + 0.5) * sub_h[:, None, None])
    xs = (x1[:, None, None] + ph[None, :, None] * bin_w[:, None, None]
          + (iy[None, None, :] + 0.5) * sub_w[:, None, None])
    r = rois.shape[0]
    if offsets is not None:
        ys = ys[:, :, None, :, None] + (offsets[..., 1] * trans_std
                                        * rh[:, None, None])[..., None, None]
        xs = xs[:, None, :, None, :] + (offsets[..., 0] * trans_std
                                        * rw[:, None, None])[..., None, None]
    else:
        ys, xs = ys[:, :, None, :, None], xs[:, None, :, None, :]
    shape = (r, p, p, s, s)
    ys, xs = ys.expand(shape), xs.expand(shape)

    idx, wts = _corner_indices(ys, xs, h, w)               # [R, P, P, S, S, 4]
    bins = torch.arange(p * p, dtype=torch.int32,
                        device=features.device).view(1, p, p, 1, 1, 1)
    rows = (idx * (p * p) + bins).permute(5, 0, 1, 2, 3, 4).reshape(-1)
    vals = take(features.reshape(h * w * p * p, cpp), rows).view(
        4, -1, cpp)
    wts = wts.reshape(-1, 4).to(features.dtype)
    acc = wts[:, 0, None] * vals[0]
    for k in range(1, 4):
        acc = acc + wts[:, k, None] * vals[k]
    return acc.view(r, p, p, s * s, cpp).mean(3)[..., :out_channels]


class DeformRoIPooling(nn.Module):
    """The reference's DeformRoIPooling (``no_trans``) and
    ModulatedDeformRoIPoolingPack pair: with offsets, the ROIs are pooled
    once without them, two linear layers (``offset_fc1``: P*P*C' -> 1024
    with ReLU; ``offset_fc2``: 1024 -> P*P*2, zero-initialised, so an
    untrained module pools without offsets) predict each bin's offset in
    float32 (Flax's ``Dense`` without a dtype promotes to its float32
    parameters), and the ROIs are pooled again with them. ``dtype``: the
    pooled features are rounded to it before ``offset_fc1``, as the JAX
    package casts them."""

    def __init__(self, spatial_scale: float, output_size: int,
                 out_channels: int, no_trans: bool = False,
                 trans_std: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kw = dict(spatial_scale=spatial_scale, output_size=output_size,
                       out_channels=out_channels, trans_std=trans_std)
        self.no_trans = no_trans
        self.dtype = dtype
        if not no_trans:
            p = output_size
            self.offset_fc1 = nn.Linear(p * p * out_channels, 1024)
            self.offset_fc2 = nn.Linear(1024, p * p * 2)
            std = (1.0 / self.offset_fc1.in_features) ** 0.5 \
                / .87962566103423978
            with torch.no_grad():  # Flax's Dense init: lecun normal, bias 0
                nn.init.trunc_normal_(self.offset_fc1.weight, 0.0, std,
                                      -2 * std, 2 * std)
                for t in (self.offset_fc1.bias, self.offset_fc2.weight,
                          self.offset_fc2.bias):
                    t.zero_()

    def forward(self, features: torch.Tensor, rois: torch.Tensor,
                impl: str = "cuda") -> torch.Tensor:
        offsets = None
        if not self.no_trans:
            base = deform_ps_roi_pool(features, rois, None, impl=impl,
                                      **self.kw)
            flat = base.reshape(base.shape[0], -1).to(self.dtype).float()
            hidden = torch.relu(self.offset_fc1(flat))
            p = self.kw["output_size"]
            offsets = self.offset_fc2(hidden).view(-1, p, p, 2)
        return deform_ps_roi_pool(features, rois, offsets, impl=impl,
                                  **self.kw)
