"""Deformable convolution, DCNv1 and DCNv2 (port of
``da_detect_tpu/layers/deform_conv.py``), forward and backward.

The JAX package scans over the k*k kernel taps: each tap gathers the
bilinear corners of every output pixel's sample from the flattened feature
map, weights and sums them, and contracts the result with the tap's kernel
slice into a float32 accumulator. The port keeps that form. Each tap's rows
come from one launch of a row gather (``ops/gather_cuda.py``) a deformable
group:

- ``gather_mode="four"`` (``TPU.DCN_GATHER``, the default): the four
  corners' indices as one index vector into the [B*H*W, C] map, through the
  warp kernel (``row_gather``);
- ``gather_mode="quad"``: one row a sample from the overlapped four-corner
  table ``flat4[i] = [f[i], f[i+1], f[i+w], f[i+w+1]]`` of width 4C, through
  the bulk-copy kernel (``row_gather_bulk``). As in JAX it needs
  ``deformable_groups == 1`` and a map of at least 2x2, else it gathers as
  "four".

The corner sum runs in JAX's order, ``w0*v0 + w1*v1 + w2*v2 + w3*v3`` left
to right; the bilinear weight, the out-of-bounds zero and the DCNv2
modulation are folded into one weight a corner.

Dtypes (``dtype``, ``TPU.COMPUTE_DTYPE``), as in the JAX package:
``conv_offset`` computes in ``dtype`` and its output is taken to float32;
the sample coordinates, corner indices, bilinear weights and DCNv2 mask are
float32; the gathered map is in ``dtype`` (in bfloat16 the row gathers run
their bfloat16 variants), and so is the corner sum: in "four" mode each
product and partial sum rounds to ``dtype`` (JAX's elementwise ops), in
"quad" mode the four products are summed in float32 and rounded once (JAX's
einsum). Each tap's contraction takes ``dtype`` operands (the sample and the
kernel cast to ``dtype``) and accumulates in float32 into a float32 result
(``preferred_element_type=float32``): the operands are widened to float32,
whose products of bfloat16 values are exact. The layer's output is the
float32 accumulator. Grouped (ResNeXt) kernels
contract per group, which is the function JAX's block-diagonal lowering
computes. ``conv_offset`` predicts [B, dg*nk*(2 or 3), oh, ow]: first the
dg*2*nk offsets ordered (group, tap, (dy, dx)), then the dg*nk mask logits.
It is zero-initialised, so an untrained layer is a plain convolution.

Training: with autograd on, each tap (its gathers, corner sum and
contraction) runs under ``torch.utils.checkpoint`` (non-reentrant), as JAX
runs its tap scan under ``jax.checkpoint``: the backward gathers the tap's
rows again, and nothing of size [P, C] a tap is kept (at 608x1216 the
X-101 model's 270 taps would keep ~14 GB a backbone pass). The gathers'
backward is the scatter-add kernel into the map (``ops/gather_cuda.py``),
which sums each map row's sources in order through the indices' CSR: with
impl "cuda" and an input on the card that needs a gradient, the layer
sorts every tap's and group's indices once (``ops.gather.row_csr``) and
hands each tap its part; under ``torch.no_grad()``, and on the CPU (where
the wrappers run the plain versions), nothing is sorted. The gradients of
the offsets and the DCNv2 mask flow through the bilinear weights in plain
autograd.

``impl``: "cuda" gathers through the kernels' wrappers (which run the plain
version for CPU tensors), "plain" through ``ops.gather.row_gather``.
Inputs and outputs are logical NCHW in ``torch.channels_last`` memory.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import gather, gather_cuda
from .cast import Conv2d


def _corner_indices(ys, xs, h: int, w: int):
    """ys/xs [...] float sample coords -> per-corner flat row indices
    (int32) and bilinear weights with out-of-bounds corners zeroed, each
    [..., 4]."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    ycs = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    xcs = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    wts = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx,
                       ly * (1 - lx), ly * lx], dim=-1)
    inb = (ycs >= 0) & (ycs < h) & (xcs >= 0) & (xcs < w)
    idx = (ycs.clamp(0, h - 1) * w + xcs.clamp(0, w - 1)).to(torch.int32)
    return idx, torch.where(inb, wts, 0.0)


def _quad_slot_weights(ys, xs, h: int, w: int):
    """One row index a sample into the overlapped four-corner table (the
    floor corner clamped to [0, h-2] x [0, w-2]) and the weight of each of
    its 4 slots: the bilinear weight of the true corner that lands on the
    slot, zero where clamping moved the window or the corner is off the
    map."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    y0c = y0.clamp(0, h - 2)
    x0c = x0.clamp(0, w - 2)
    wy = [torch.where(y0c + d == y0, 1 - ly, 0.0)
          + torch.where(y0c + d == y0 + 1, ly, 0.0) for d in (0, 1)]
    wx = [torch.where(x0c + d == x0, 1 - lx, 0.0)
          + torch.where(x0c + d == x0 + 1, lx, 0.0) for d in (0, 1)]
    wts = torch.stack([wy[0] * wx[0], wy[0] * wx[1],
                       wy[1] * wx[0], wy[1] * wx[1]], dim=-1)
    return (y0c * w + x0c).to(torch.int32), wts


def _corner_sum(wts: torch.Tensor, vals) -> torch.Tensor:
    """wts [P, 4] float32, vals four [P, C] -> [P, C] in the values' dtype,
    summed left to right, each step rounded to it."""
    wts = wts.to(vals[0].dtype)
    acc = wts[:, 0, None] * vals[0]
    for k in range(1, 4):
        acc = acc + wts[:, k, None] * vals[k]
    return acc


def _corner_sum_once(wts: torch.Tensor, vals) -> torch.Tensor:
    """``_corner_sum`` with the products (of the weights rounded to the
    values' dtype) summed in float32 and rounded once, as an einsum over
    the corners does."""
    dtype = vals[0].dtype
    acc = _corner_sum(wts.to(dtype).float(), [v.float() for v in vals])
    return acc.to(dtype)


def _contract(samp: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """samp [P, C] with a tap's kernel slice wk [fg, C/fg, F/fg] -> [P, F]
    in float32, group by group: operands in their dtype, the products and
    sums in float32."""
    samp, wk = samp.float(), wk.float()
    if wk.shape[0] == 1:
        return samp @ wk[0]
    p, fg = samp.shape[0], wk.shape[0]
    return torch.bmm(samp.view(p, fg, -1).transpose(0, 1),
                     wk).transpose(0, 1).reshape(p, -1)


def _tap_four(take, flat, idx, perm, row_ptr, wts, wk):
    """One tap, "four" mode: flat [N, C]; idx [dg, 4P] (corner-major);
    perm [dg, 4P] and row_ptr [dg, N + 1], each group's CSR for the
    backward, or None; wts [dg, P, 4] -> [P, F]. A gather a deformable
    group, of its column slice."""
    dg, p = wts.shape[:2]
    cg = flat.shape[1] // dg
    parts = [_corner_sum(wts[g], take(
        flat[:, g * cg:(g + 1) * cg], idx[g],
        None if perm is None else (perm[g], row_ptr[g])).view(
            4, p, cg).unbind(0)) for g in range(dg)]
    return _contract(parts[0] if dg == 1 else torch.cat(parts, dim=-1), wk)


def _tap_quad(take, table, idx, perm, row_ptr, wts, wk):
    """One tap, "quad" mode: table [N', 4C]; idx [P]; perm [P] and row_ptr
    [N' + 1], its CSR, or None; wts [P, 4] -> [P, F]."""
    p, c = idx.shape[0], table.shape[1] // 4
    rows = take(table, idx, None if perm is None else (perm, row_ptr))
    return _contract(_corner_sum_once(wts, rows.view(p, 4, c).unbind(1)),
                     wk)


class DeformConv2d(nn.Module):
    """3x3 (or k x k) deformable convolution without bias, as the JAX
    package builds it in ResNet ``conv2``. ``weight`` has the grouped
    convolution layout [out, in / groups, k, k] (float32); ``dtype`` is the
    compute dtype; the output is float32."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1, deformable_groups: int = 1,
                 modulated: bool = False, gather_mode: str = "four",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if gather_mode not in ("four", "quad"):
            raise ValueError(f"unknown gather_mode: {gather_mode}")
        if in_channels % groups or out_channels % groups \
                or in_channels % deformable_groups:
            raise ValueError("channels must divide into the groups")
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.groups = groups
        self.deformable_groups = deformable_groups
        self.modulated = modulated
        self.gather_mode = gather_mode
        self.dtype = dtype
        self.padding = dilation * (kernel_size - 1) // 2
        nk = kernel_size * kernel_size
        self.conv_offset = Conv2d(
            in_channels, deformable_groups * nk * (3 if modulated else 2),
            kernel_size, stride=stride, padding=self.padding,
            dilation=dilation, compute_dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        nn.init.kaiming_normal_(self.weight)

    def _sample_grid(self, x: torch.Tensor, om=None, row0: int = 0):
        """Sample coordinates ys, xs [B, oh, ow, dg, nk] and the DCNv2 mask
        [B, oh, ow, dg, nk] (None for DCNv1), from ``conv_offset``'s output
        ``om`` (default: on ``x``), whose first row is output row
        ``row0``."""
        if om is None:
            om = self.conv_offset(x)
        b = om.shape[0]
        k, dg, nk = self.kernel_size, self.deformable_groups, \
            self.kernel_size ** 2
        om = om.float().permute(0, 2, 3, 1)
        oh, ow = om.shape[1:3]
        mask = None
        if self.modulated:
            mask = torch.sigmoid(om[..., dg * 2 * nk:]).reshape(
                b, oh, ow, dg, nk)
            om = om[..., :dg * 2 * nk]
        off = om.reshape(b, oh, ow, dg, nk, 2)
        f32 = dict(dtype=torch.float32, device=om.device)
        ky, kx = torch.meshgrid(torch.arange(k, **f32),
                                torch.arange(k, **f32), indexing="ij")
        ky = (ky * self.dilation).reshape(-1)
        kx = (kx * self.dilation).reshape(-1)
        base_y = torch.arange(row0, row0 + oh, **f32) * self.stride \
            - self.padding
        base_x = torch.arange(ow, **f32) * self.stride - self.padding
        by = (base_y[:, None] + ky[None, :]).reshape(1, oh, 1, 1, nk)
        bx = (base_x[:, None] + kx[None, :]).reshape(1, 1, ow, 1, nk)
        return by + off[..., 0], bx + off[..., 1], mask

    def forward(self, x: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
        return self.deform(x, self.conv_offset(x), impl)

    def deform(self, x: torch.Tensor, om: torch.Tensor, impl: str = "cuda",
               row0: int = 0, weight=None, groups=None) -> torch.Tensor:
        """The layer on the map ``x`` with ``conv_offset``'s output ``om``
        for the output rows from ``row0`` (the mesh's row shards), with
        ``weight`` in ``groups`` (the mesh's split kernel; default the
        layer's)."""
        weight = self.weight if weight is None else weight
        if impl == "cuda":
            take, take_wide = gather_cuda.row_gather, \
                gather_cuda.row_gather_bulk
        elif impl == "plain":
            def take(table, idx, _csr):
                return gather.row_gather(table, idx)
            take_wide = take
        else:
            raise ValueError(f"unknown gather impl: {impl!r}")
        b, c, h, w = x.shape
        dg, nk, fg = self.deformable_groups, self.kernel_size ** 2, \
            self.groups if groups is None else groups
        ys, xs, mask = self._sample_grid(x, om, row0)
        oh, ow = ys.shape[1:3]
        p = b * oh * ow
        quad = self.gather_mode == "quad" and dg == 1 and h >= 2 and w >= 2
        if quad:
            idx, wts = _quad_slot_weights(ys, xs, h, w)
        else:
            idx, wts = _corner_indices(ys, xs, h, w)
        if mask is not None:
            wts = wts * mask[..., None]
        # each image's rows into the batch-flattened map (quad-table rows
        # use the same stride: the overlapped rows never cross an image)
        idx = idx + (torch.arange(b, dtype=torch.int32, device=x.device)
                     * (h * w)).reshape((b,) + (1,) * (idx.dim() - 1))
        # [nk, dg, (4,) P]: each tap's (and group's) rows one contiguous
        # index vector, corner-major in "four" mode
        if quad:
            idx = idx.permute(4, 3, 0, 1, 2).reshape(nk, dg, p)
        else:
            idx = idx.permute(4, 3, 5, 0, 1, 2).reshape(nk, dg, 4 * p)
        wts = wts.permute(4, 3, 0, 1, 2, 5).reshape(nk, dg, p, 4)

        flat = x.to(self.dtype).permute(0, 2, 3, 1).reshape(b * h * w, c)
        if quad:
            flat2 = torch.cat([flat[:-1], flat[1:]], dim=-1)
            table = torch.cat([flat2[:-w], flat2[w:]], dim=-1)
        cpf, fpg = c // fg, weight.shape[0] // fg
        # [nk, fg, C/fg, F/fg]: tap t, group g -> that group's kernel slice
        wk = weight.to(self.dtype).reshape(fg, fpg, cpf, nk).permute(
            3, 0, 2, 1)
        acc = torch.zeros((p, weight.shape[0]), dtype=torch.float32,
                          device=x.device)
        # with autograd on, each tap runs under a non-reentrant checkpoint:
        # the backward gathers the tap's rows again instead of keeping them
        # (jax.checkpoint of the JAX package's tap scan), so no [P, C]
        # buffer of a tap outlives the forward
        recompute = torch.is_grad_enabled()
        # the scatter-add kernel's CSR of every tap and group, from one sort
        # a layer, built here and handed to each tap as an input of its
        # checkpoint, so the recompute builds nothing
        perm = row_ptr = None
        if recompute and impl == "cuda" and x.is_cuda and x.requires_grad:
            perm, row_ptr = gather.row_csr(
                idx, table.shape[0] if quad else flat.shape[0])
        fn, tap_take, src = (_tap_quad, take_wide, table) if quad \
            else (_tap_four, take, flat)
        for t in range(nk):
            at = (t, 0) if quad else t
            csr = (None, None) if perm is None else (perm[at], row_ptr[at])
            args = (tap_take, src, idx[at], *csr, wts[at], wk[t])
            if recompute:
                part = checkpoint(fn, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                part = fn(*args)
            acc = acc + part
        return acc.view(b, oh, ow, -1).permute(0, 3, 1, 2)
