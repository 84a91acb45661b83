"""Spatial partitioning (``TPU.MESH_SPATIAL``): the backbone on row shards
over the mesh's ``space`` group, what GSPMD does for the JAX package
(``da_detect_tpu/parallel/mesh.py``: its ``space`` axis splits each canvas's
H and XLA inserts the halo exchanges).

Every feature map of the backbone has H rows split into balanced, fixed
ranges, one a space rank (``row_range``: 19 rows over 2 ranks are 10 and
9). A layer computes the output rows of its rank's range from the input
rows they need, derived from its kernel, stride, padding and dilation: the
rows its rank owns, and the rows beyond its range fetched from the other
ranks (``fetch_rows``: one all-gather of each rank's top and bottom edge
strips, sized for the widest need; the rows above the map's top and below
its bottom are the layer's padding, zero, or -inf for a max pool). Its
backward sends each fetched row's gradient back to its owner (one
all-reduce of the strips' gradients) and adds it there. Layers:

- ``MeshConv2d`` (every convolution of the body and the FPN: the 7x7/s2
  stem, strided 3x3 and 1x1, grouped and depthwise, the laterals, P6/P7)
  and the max pools of the stem, the FPN and VGG-16 (``MeshRowOps``,
  replacing their ``layers.RowOps`` methods): the H padding becomes
  fetched or padding rows;
- FBNet's SAME padding before its stride-2 convs (``MeshRowOps.same_pad``):
  W padded locally; the H pads, asymmetric and set by the map's global
  height (0 before and k - 2 after on an even side at stride 2), become
  padding rows above the map's top and below its bottom, fetched together
  with the rows the next conv's window reads from the other ranks, in one
  fetch. The result is marked (``_WINDOW``), so the unpadded conv that
  follows computes on it as it is and fetches nothing;
- FrozenBN, FBNet's fixed-statistics BatchNorm, ReLU and the residual sums:
  row-local, unchanged;
- ``MeshGroupNorm``: each group's sum all-reduced over space for the mean,
  then its centred sum of squares for the variance (two passes, as
  accurate as the single process's Welford sums; Flax's E[x²] - E[x]²
  cancels in float32);
- the FPN's nearest 2x upsample (``MeshRowOps``): the rows it repeats
  fetched (the range of a map and of its upsampled lateral do not line up
  after an uneven split);
- ``MeshDeformConv2d``: its samples reach anywhere, so it reads the whole
  map (one all-gather) and computes its own output rows; the backward sums
  the map's gradient over space (all-reduce) and keeps its own rows.

The backbone takes its data slice's whole canvases, cuts its own rows, and
all-gathers each output map over space (backward: each rank keeps its own
rows of the gradient): everything downstream (RPN, NMS, ROIAlign, heads,
DA heads, losses) runs whole on every space rank. The gradients of the
backbone's parameters are partial sums, one a space rank, and those of
the rest whole on each: ``mesh.reduce_mesh_grads`` sums the first and
averages the second over space after the backward (the data average is
DDP's).

Global heights: a rank sees only its rows, so the backbone records each
map's H under its width W and the rank's row count (W is never split;
every level of a pyramid has its own W but where W reaches 1, and there
the row counts differ), starting from the canvas, and each layer looks
its input's H up and records its output's (a conflict raises). A map
with fewer rows than space ranks raises. The bodies on row shards: the
ResNe(X)t bodies and their FPNs (deformable stages included), VGG-16 and
the FBNet trunks; another backbone raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..layers import Conv2d, DeformConv2d, GroupNorm, RowOps
from ..layers.rows import same_pads

_HEIGHTS: dict | None = None  # the pass's {(W, own rows): global H}
# the attribute marking a map that holds exactly the rows its rank's
# output rows of the unpadded conv that follows read, padding rows
# included; its value is that conv's output height
_WINDOW = "_row_window"


def row_range(n: int, parts: int, i: int) -> tuple[int, int]:
    """Rank ``i``'s rows [lo, hi) of ``n`` split over ``parts``: balanced,
    the first ``n % parts`` ranks one row more."""
    base, extra = divmod(n, parts)
    lo = i * base + min(i, extra)
    return lo, lo + base + (i < extra)


def _ranges(n: int, parts: int) -> list:
    if n < parts:
        raise ValueError(f"a map of {n} rows cannot be split over {parts} "
                         "space ranks: the canvas is too small for "
                         "TPU.MESH_SPATIAL")
    return [row_range(n, parts, i) for i in range(parts)]


def _key(x: torch.Tensor) -> tuple:
    return x.shape[-1], x.shape[-2]


@contextlib.contextmanager
def _pass(x: torch.Tensor, height: int):
    global _HEIGHTS
    saved, _HEIGHTS = _HEIGHTS, {_key(x): height}
    try:
        yield
    finally:
        _HEIGHTS = saved


def global_height(x: torch.Tensor) -> int:
    """The global H of a row-sharded map, by its width and own rows."""
    if _HEIGHTS is None or _key(x) not in _HEIGHTS:
        raise RuntimeError("a row-sharded layer ran outside its backbone's "
                           "pass (or on a map of unknown shape)")
    return _HEIGHTS[_key(x)]


def _record(y: torch.Tensor, height: int) -> torch.Tensor:
    known = _HEIGHTS.setdefault(_key(y), height)
    if known != height:
        raise RuntimeError(f"two maps of width {y.shape[-1]} and "
                           f"{y.shape[-2]} own rows with heights {known} "
                           f"and {height}")
    return y


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 travels as its bytes (uint8): gloo's gathers on CUDA
    tensors take neither bfloat16 nor int16."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def all_gather(t: torch.Tensor, group, parts: int) -> list:
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(parts)]
    dist.all_gather([_wire(o) for o in out], _wire(t), group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` of a fresh copy (bfloat16 summed in float32)."""
    y = t.float().contiguous() if t.dtype == torch.bfloat16 \
        else t.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(t.dtype)


class _Geometry:
    """Who needs which rows of a map of ``h`` rows: ``needs[q]`` the global
    rows [a, b) rank q reads (outside [0, h): padding rows); the edge strips
    each rank sends, ``top`` rows from its first row and ``bottom`` rows up
    to its last, sized for the widest need."""

    def __init__(self, h: int, parts: int, needs: list):
        self.h, self.own, self.needs = h, _ranges(h, parts), needs
        top = bottom = 0
        for q, (a, b) in enumerate(needs):
            for p, (lo, hi) in enumerate(self.own):
                ra, rb = max(a, lo), min(b, hi)
                if p == q or ra >= rb:
                    continue
                if p > q:
                    top = max(top, rb - lo)
                else:
                    bottom = max(bottom, hi - ra)
        self.top, self.bottom = top, bottom

    def pieces(self, q: int) -> list:
        """Rank q's rows in order: (owner or None for padding, a, b)."""
        a, b = self.needs[q]
        out = []
        if a < 0:
            out.append((None, a, min(0, b)))
        for p, (lo, hi) in enumerate(self.own):
            ra, rb = max(a, lo), min(b, hi)
            if ra < rb:
                out.append((p, ra, rb))
        if b > self.h:
            out.append((None, max(a, self.h), b))
        return out


def _keep_format(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 4 and like.is_contiguous(
            memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y


class _Fetch(torch.autograd.Function):
    """Rows ``needs[me]`` of a row-sharded map: own rows, rows of the other
    ranks from their edge strips (one all-gather), padding rows of
    ``fill``."""

    @staticmethod
    def forward(ctx, x, geo, me, group, fill):
        lo, hi = geo.own[me]
        n, top, bottom = hi - lo, geo.top, geo.bottom
        strips = None
        if top or bottom:
            pad = x.new_zeros(x.shape[:2] + (top + bottom,) + x.shape[3:])
            k = min(top, n)
            pad[:, :, :k] = x[:, :, :k]
            k = min(bottom, n)
            pad[:, :, top + bottom - k:] = x[:, :, n - k:]
            strips = all_gather(pad, group, len(geo.own))
        parts = []
        for p, a, b in geo.pieces(me):
            if p is None:
                parts.append(x.new_full(x.shape[:2] + (b - a,) + x.shape[3:],
                                        fill))
            elif p == me:
                parts.append(x[:, :, a - lo:b - lo])
            elif p > me:
                plo = geo.own[p][0]
                parts.append(strips[p][:, :, a - plo:b - plo])
            else:
                off = top + bottom - (geo.own[p][1] - a)
                parts.append(strips[p][:, :, off:off + b - a])
        ctx.geo, ctx.me, ctx.group = geo, me, group
        ctx.x_shape = x.shape
        return _keep_format(torch.cat(parts, dim=2), x)

    @staticmethod
    def backward(ctx, g):
        geo, me = ctx.geo, ctx.me
        lo, hi = geo.own[me]
        n, top, bottom = hi - lo, geo.top, geo.bottom
        gx = g.new_zeros(ctx.x_shape)
        buf = None
        if top or bottom:
            buf = g.new_zeros((len(geo.own),) + g.shape[:2]
                              + (top + bottom,) + g.shape[3:])
        at = 0
        for p, a, b in geo.pieces(me):
            part = g[:, :, at:at + b - a]
            at += b - a
            if p is None:
                continue
            if p == me:
                gx[:, :, a - lo:b - lo] += part
            elif p > me:
                plo = geo.own[p][0]
                buf[p, :, :, a - plo:b - plo] += part
            else:
                off = top + bottom - (geo.own[p][1] - a)
                buf[p, :, :, off:off + b - a] += part
        if buf is not None:
            mine = all_reduce_sum(buf, ctx.group)[me]
            k = min(top, n)
            gx[:, :, :k] += mine[:, :, :k]
            k = min(bottom, n)
            gx[:, :, n - k:] += mine[:, :, top + bottom - k:]
        return gx, None, None, None, None


def fetch_rows(x: torch.Tensor, mesh, h: int, needs: list,
               fill: float = 0.0) -> torch.Tensor:
    """This rank's rows ``needs[space rank]`` of the row-sharded map ``x``
    (global height ``h``); ``needs`` holds every space rank's [a, b)."""
    geo = _Geometry(h, mesh.space, needs)
    return _Fetch.apply(x, geo, mesh.space_rank, mesh.space_group, fill)


def window_needs(h: int, parts: int, k: int, s: int, pad: tuple,
                 d: int = 1):
    """(output height, every rank's input rows) of a window of size ``k``,
    stride ``s``, padding ``pad`` = (top, bottom) and dilation ``d`` over
    ``h`` rows: rank q's output rows [o0, o1) read
    [o0*s - top, (o1 - 1)*s - top + d*(k - 1) + 1)."""
    top, bottom = pad
    ho = (h + top + bottom - d * (k - 1) - 1) // s + 1
    needs = [(o0 * s - top, (o1 - 1) * s - top + d * (k - 1) + 1)
             for o0, o1 in _ranges(ho, parts)]
    return ho, needs


def halo(x: torch.Tensor, mesh, k: int, s: int, pad: tuple, d: int = 1,
         fill: float = 0.0):
    """(the input rows this rank's output rows of a window read, padding
    rows included; the output's global height)."""
    ho, needs = window_needs(global_height(x), mesh.space, k, s, pad, d)
    return fetch_rows(x, mesh, global_height(x), needs, fill), ho


class _GatherRows(torch.autograd.Function):
    """The whole map from every rank's rows (one all-gather of row shards
    padded to the longest). Backward: ``sum_grad`` all-reduces the
    gradient over space first (each rank's is partial); else every rank
    holds the whole gradient already. Each keeps its own rows."""

    @staticmethod
    def forward(ctx, x, own, me, group, sum_grad):
        longest = max(hi - lo for lo, hi in own)
        pad = x.new_zeros(x.shape[:2] + (longest,) + x.shape[3:])
        pad[:, :, :x.shape[2]] = x
        parts = all_gather(pad, group, len(own))
        ctx.own, ctx.me, ctx.group, ctx.sum_grad = own, me, group, sum_grad
        return _keep_format(torch.cat(
            [t[:, :, :hi - lo] for t, (lo, hi) in zip(parts, own)], dim=2), x)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = all_reduce_sum(g, ctx.group)
        lo, hi = ctx.own[ctx.me]
        return g[:, :, lo:hi], None, None, None, None


def gather_rows(x: torch.Tensor, mesh, h: int,
                sum_grad: bool) -> torch.Tensor:
    return _GatherRows.apply(x, _ranges(h, mesh.space), mesh.space_rank,
                             mesh.space_group, sum_grad)


class _AllReduce(torch.autograd.Function):
    """A sum over ``group`` whose every rank uses the total: the backward
    sums the gradients the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


# ------------------------------------------------------------- layers

class MeshConv2d(Conv2d):
    """A convolution under the mesh: on row shards (``_rows``: the H
    padding becomes fetched or padding rows) and/or split over ``model``
    (``_split``, ``tensor.py``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh, padding, ho = self._mesh, self.padding, None
        if self._rows:
            # a ``row_same_pad`` output holds this conv's rows already
            ho = getattr(x, _WINDOW, None)
            if ho is None:
                x, ho = halo(x, mesh, self.kernel_size[0], self.stride[0],
                             (self.padding[0],) * 2, self.dilation[0])
            padding = (0, self.padding[1])
        from .tensor import split_call
        y = split_call(self, x, lambda xs, w, b, g: self.conv(
            xs, w, b, padding, g))
        return _record(y, ho) if self._rows else y


def row_max_pool(x: torch.Tensor, mesh, k: int, s: int,
                 p: int) -> torch.Tensor:
    """``F.max_pool2d(x, k, s, p)`` on row shards (-inf padding rows)."""
    xs, ho = halo(x, mesh, k, s, (p, p), fill=float("-inf"))
    return _record(F.max_pool2d(xs, k, s, padding=(0, p)), ho)


def row_same_pad(x: torch.Tensor, mesh, k: int, s: int) -> torch.Tensor:
    """``RowOps.same_pad(x, k, s)`` on row shards: W padded here, and the
    rows this rank's output rows of the unpadded k x k conv at stride s
    read, SAME's H pads (from the global height) as zero rows; marked
    (``_WINDOW``) with that conv's output height."""
    h = global_height(x)
    x = F.pad(x, same_pads(x.shape[3], k, s) + [0, 0]).contiguous(
        memory_format=torch.channels_last)
    ho, needs = window_needs(h, mesh.space, k, s, tuple(same_pads(h, k, s)))
    xs = fetch_rows(x, mesh, h, needs)
    setattr(xs, _WINDOW, ho)
    return xs


def row_upsample_2x(x: torch.Tensor, mesh, like: torch.Tensor):
    """``RowOps.upsample_2x(x, like)`` on row shards: the
    rows of ``like``'s range, output row o repeating input row o // 2."""
    h_out = global_height(like)
    needs = [(o0 // 2, (o1 - 1) // 2 + 1)
             for o0, o1 in _ranges(h_out, mesh.space)]
    a = needs[mesh.space_rank][0]
    o0, o1 = row_range(h_out, mesh.space, mesh.space_rank)
    xs = fetch_rows(x, mesh, global_height(x), needs)
    up = F.interpolate(xs, scale_factor=2, mode="nearest")
    return up[:, :, o0 - 2 * a:o1 - 2 * a, :like.shape[3]]


class MeshGroupNorm(GroupNorm):
    """GroupNorm under the mesh: on row shards (``_rows``: each group's
    mean, then its variance about it, from sums all-reduced over space)
    and/or with its vectors split over ``model`` (gathered at use)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .tensor import full_vector
        w, b = full_vector(self, "weight"), full_vector(self, "bias")
        if not self._rows:
            y = F.group_norm(x.float(), self.num_groups, w, b, self.eps)
            return _keep_format(y, x)
        n, c = x.shape[:2]
        g, group = self.num_groups, self._mesh.space_group
        xg = x.float().reshape(n, g, -1)
        count = (c // g) * global_height(x) * x.shape[3]
        mean = _AllReduce.apply(xg.sum(-1), group) / count
        centered = xg - mean[..., None]
        var = _AllReduce.apply((centered * centered).sum(-1), group) / count
        y = centered * torch.rsqrt(var + self.eps)[..., None]
        y = y.reshape(x.shape) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
        return _keep_format(y, x)


class MeshDeformConv2d(DeformConv2d):
    """A deformable convolution under the mesh: on row shards (its offsets
    from its row-sharded ``conv_offset``; the whole map all-gathered, its
    own output rows sampled from it) and/or its kernel split over
    ``model``."""

    def forward(self, x: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
        om, row0 = self.conv_offset(x), 0
        if self._rows:
            mesh = self._mesh
            h = global_height(x)
            ho = global_height(om)
            row0 = row_range(ho, mesh.space, mesh.space_rank)[0]
            x = gather_rows(x, mesh, h, sum_grad=True)
        from .tensor import split_call
        return split_call(self, x, lambda xs, w, _b, g: self.deform(
            xs, om, impl, row0=row0, weight=w, groups=g))


class MeshRowOps:
    """Mixed into a backbone module's class (``layers.RowOps``): its max
    pool, 2x upsample and SAME padding on row shards."""

    def max_pool(self, x: torch.Tensor, kernel_size: int, stride: int,
                 padding: int = 0) -> torch.Tensor:
        return row_max_pool(x, self._mesh, kernel_size, stride, padding)

    def upsample_2x(self, x: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
        return row_upsample_2x(x, self._mesh, like)

    def same_pad(self, x: torch.Tensor, kernel: int,
                 stride: int) -> torch.Tensor:
        return row_same_pad(x, self._mesh, kernel, stride)


class SpatialBackbone:
    """Mixed into the backbone's own class: cut this rank's rows of the
    canvases, run the row-sharded body (and FPN), all-gather every output
    map over space."""

    def forward(self, x: torch.Tensor, impl: str = "cuda"):
        mesh = self._mesh
        h = x.shape[2]
        lo, hi = _ranges(h, mesh.space)[mesh.space_rank]
        x = x[:, :, lo:hi]
        with _pass(x, h):
            feats = super().forward(x, impl)
            return [gather_rows(f, mesh, global_height(f), sum_grad=False)
                    for f in feats]


def _swap(module, cls, mesh) -> None:
    if not isinstance(module, cls):
        if not hasattr(module, "compute_dtype"):  # a plain torch layer
            module.compute_dtype = torch.float32
        module.__class__ = cls
        module._rows = module._split = False
    module._mesh = mesh


def partition_backbone(model, mesh) -> list:
    """Put ``model.backbone`` on row shards over ``mesh``'s space group;
    returns its parameters (their gradients are partial sums)."""
    from ..models.backbone.backbone import ResNetBackbone
    from ..models.backbone.fbnet import FBNetTrunk
    from ..models.backbone.vgg import VGG16

    bb = model.backbone
    if not isinstance(bb, (ResNetBackbone, VGG16, FBNetTrunk)):
        raise NotImplementedError(
            f"spatial partitioning of a {type(bb).__name__} backbone "
            "(TPU.MESH_SPATIAL > 1 covers the ResNe[X]t, FPN, VGG-16 and "
            "FBNet bodies)")
    for m in bb.modules():
        if isinstance(m, DeformConv2d):
            _swap(m, MeshDeformConv2d, mesh)
        elif isinstance(m, torch.nn.Conv2d):
            if m.padding_mode != "zeros":
                raise NotImplementedError(f"padding mode {m.padding_mode}")
            _swap(m, MeshConv2d, mesh)
        elif isinstance(m, GroupNorm):
            _swap(m, MeshGroupNorm, mesh)
        elif isinstance(m, RowOps):
            m.__class__ = _mixed(MeshRowOps, type(m))
            m._mesh = mesh
            continue
        else:
            continue
        m._rows = True
    bb.__class__ = _mixed(SpatialBackbone, type(bb))
    bb._mesh = mesh
    return [p for p in bb.parameters() if p.requires_grad]


def _mixed(mixin, cls):
    """``cls`` with ``mixin``'s methods first."""
    return type(f"{mixin.__name__}{cls.__name__}", (mixin, cls), {})
