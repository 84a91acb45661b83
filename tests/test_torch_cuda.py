"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one (which need not have JAX, so tests/conftest.py is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

NMS keep masks must agree exactly, truncated ones (``max_keep``) too;
ROIAlign to rtol = atol = 1e-5 (float32 sums in another order), one level
or four in one launch; the ROIAlign
backward within 1e-5 of the largest |dF| (its sums run in another order,
and its atomics in an order that changes from run to run); one train
step through the kernels against the same step through the plain versions:
losses rtol 1e-4, gradients within 1e-3 of each leaf's largest |g|. The two
row gathers are copies and must equal the plain version bit for bit; a
deformable convolution through them agrees with its plain run to 1e-5.
"""

import numpy as np
import pytest
import torch

from da_detect_tpu_torch import entry, kernels
from da_detect_tpu_torch.models import poolers
from da_detect_tpu_torch.ops import (gather, gather_cuda, nms, nms_cuda,
                                     roi_align, roi_align_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _boxes(seed, b, n):
    """Overlapping clusters in descending score order, ~20% invalid."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 300, (b, max(n // 16, 1), 2))
    c = centers[:, np.arange(n) % centers.shape[1]] + rng.uniform(
        -20, 20, (b, n, 2))
    half = rng.uniform(10, 60, (b, n, 2))
    boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(rng.rand(b, n) > 0.2)


@pytest.mark.parametrize("b,n,thresh", [(1, 1, 0.5), (2, 63, 0.7),
                                        (3, 64, 0.3), (1, 65, 0.5),
                                        (2, 700, 0.7), (1, 2048, 0.3),
                                        (2, 6000, 0.7), (1, 12000, 0.7)])
def test_nms_kernel_matches_plain(dev, b, n, thresh):
    boxes, valid = (t.to(dev) for t in _boxes(n, b, n))
    before = kernels.LAUNCHES["nms"]
    got = nms_cuda.nms_mask_sorted(boxes, valid, thresh)
    want = nms.nms_mask_sorted(boxes, valid, thresh)
    assert kernels.LAUNCHES["nms"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_nms_kernel_invalid_rows_and_ragged_batch(dev):
    """Three images with all, about half and none of their boxes valid."""
    boxes, _ = _boxes(3, 3, 1000)
    valid = torch.ones(3, 1000, dtype=torch.bool)
    valid[1] = torch.from_numpy(np.random.RandomState(4).rand(1000) > 0.5)
    valid[2] = False
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms_cuda.nms_mask_sorted(boxes, valid, 0.5)
    torch.testing.assert_close(got, nms.nms_mask_sorted(boxes, valid, 0.5),
                               rtol=0, atol=0)
    assert not got[2].any() and got[0].sum() > got[1].sum() > 0


@pytest.mark.parametrize("k", [1, 100, 2000, 10 ** 6])
def test_nms_kernel_max_keep(dev, k):
    """The walk's early stop at the train RPN's shape: the kernel's mask
    equals the plain one truncated after its k-th kept box (k past the
    survivors: the full mask), and nms_topk through it equals the top k
    taken from the full mask."""
    boxes, valid = (t.to(dev) for t in _boxes(12, 2, 12000))
    full = nms.nms_mask_sorted(boxes, valid, 0.7)
    want = full & (torch.cumsum(full, dim=1) <= k)
    got = nms_cuda.nms_mask_sorted(boxes, valid, 0.7, max_keep=k)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        nms.nms_mask_sorted(boxes, valid, 0.7, max_keep=k), want, rtol=0,
        atol=0)
    scores = torch.linspace(1.0, 0.0, 12000, device=dev).expand(2, -1)
    got_k = nms.nms_topk(boxes, scores, valid, 0.7, k, impl="cuda",
                         presorted=True)
    want_k = nms.topk_survivors(full, scores, k)
    for g, w in zip(got_k, want_k):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_nms_topk_kernel_route_matches_plain(dev):
    boxes, valid = (t.to(dev) for t in _boxes(7, 2, 500))
    scores = torch.rand(2, 500, generator=torch.Generator().manual_seed(7)
                        ).to(dev)
    want = nms.nms_topk(boxes, scores, valid, 0.5, 100, impl="plain")
    got = nms.nms_topk(boxes, scores, valid, 0.5, 100, impl="cuda")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _rois(seed, b, r, h, w, max_side):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-60, w * 16, (b, r))
    y1 = rng.uniform(-60, h * 16, (b, r))
    return torch.from_numpy(np.stack(
        [x1, y1, x1 + rng.uniform(2, max_side, (b, r)),
         y1 + rng.uniform(2, max_side, (b, r))], -1).astype(np.float32))


@pytest.mark.parametrize("b,r,h,w,c,p,sr,cap", [
    (2, 11, 10, 16, 128, 7, 2, 8), (1, 37, 38, 76, 64, 14, 0, 8),
    (1, 9, 38, 76, 8, 14, 0, 4), (2, 5, 7, 9, 4, 7, 0, 8)])
def test_roi_align_kernel_matches_plain(dev, b, r, h, w, c, p, sr, cap):
    feats = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(r)
                        ).to(dev).permute(0, 3, 1, 2)
    rois = _rois(r, b, r, h, w, 2000.0).to(dev)
    kw = dict(spatial_scale=1.0 / 16, output_size=p, sampling_ratio=sr,
              max_samples=cap)
    got = roi_align_cuda.roi_align(feats, rois, **kw)
    torch.testing.assert_close(got, roi_align.roi_align(feats, rois, **kw),
                               rtol=1e-5, atol=1e-5)


# FPN P2-P5 of a 608x1216 canvas, as the DCN model's pooler reads them
FPN_SHAPES = ((152, 304), (76, 152), (38, 76), (19, 38))
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


def _fpn_inputs(seed, b, r, c, dev, empty_level=None):
    """Maps of the 4 levels, ROIs of 4 to 700 pixels a side over the canvas
    and their levels by FPN's rule (``empty_level``: its ROIs dropped)."""
    gen = torch.Generator().manual_seed(seed)
    maps = [torch.randn(b, h, w, c, generator=gen).to(dev).permute(0, 3, 1, 2)
            for h, w in FPN_SHAPES]
    rng = np.random.RandomState(seed)
    side = np.exp(rng.uniform(np.log(4), np.log(700), (b, 3 * r, 2)))
    xy = rng.uniform(-50, (1216, 608), (b, 3 * r, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).astype(
        np.float32))
    levels = poolers.assign_levels(rois, 2, 5)
    if empty_level is not None:
        keep = (levels != empty_level).all(0)
        rois, levels = rois[:, keep], levels[:, keep]
    return maps, rois[:, :r].to(dev), levels[:, :r].to(dev)


@pytest.mark.parametrize("b,r,c,sr,empty_level", [
    (1, 1000, 256, 2, None),    # the DCN pooler's shapes
    (2, 300, 64, 2, 1),         # two images, no ROI on P3
    (1, 200, 12, 0, None),      # adaptive sampling; C leaves a slice partial
    (2, 0, 64, 2, None)])       # no ROI
def test_roi_align_levels_kernel_matches_plain(dev, b, r, c, sr, empty_level):
    maps, rois, levels = _fpn_inputs(r + c, b, r, c, dev, empty_level)
    kw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=sr,
              max_samples=8)
    before = kernels.LAUNCHES["roi_align_fwd"]
    got = roi_align_cuda.roi_align_levels_forward(maps, rois, levels, **kw)
    assert kernels.LAUNCHES["roi_align_fwd"] == before + (r > 0)
    want = roi_align.roi_align_levels(maps, rois, levels, **kw)
    assert got.shape == want.shape == (b, r, c, 7, 7)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if empty_level is not None:
        assert not (levels == empty_level).any()
    # int32 levels and a level outside the maps (zeros) take the same launch
    off = levels.to(torch.int32)
    off[:, :3] = 7
    got = roi_align_cuda.roi_align_levels_forward(maps, rois, off, **kw)
    torch.testing.assert_close(
        got, roi_align.roi_align_levels(maps, rois, off, **kw), rtol=1e-5,
        atol=1e-5)


def test_roi_align_levels_autograd_matches_plain(dev):
    """dF of each level through the level-aware autograd function (one
    forward launch, a backward launch a level on the masked gradient)
    against autograd of the plain form."""
    maps, rois, levels = _fpn_inputs(21, 1, 300, 64, dev)
    kw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=2,
              max_samples=8)
    g = torch.randn(1, 300, 64, 7, 7, generator=torch.Generator(
        ).manual_seed(22)).to(dev)
    grads = []
    for fn in (roi_align_cuda.roi_align_levels, roi_align.roi_align_levels):
        leaves = [m.detach().clone().requires_grad_() for m in maps]
        before = dict(kernels.LAUNCHES)
        out = fn(leaves, rois, levels, **kw)
        grads.append(torch.autograd.grad((out * g).sum(), leaves))
        if fn is roi_align_cuda.roi_align_levels:
            assert kernels.LAUNCHES["roi_align_fwd"] == before.get(
                "roi_align_fwd", 0) + 1
            assert kernels.LAUNCHES["roi_align_bwd"] == before.get(
                "roi_align_bwd", 0) + 4
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("fpn", [False, True], ids=["c4", "fpn"])
def test_pooler_launches_roi_align_once(dev, fpn):
    """pool_rois makes one forward launch, one level (C4) or four (FPN)."""
    if fpn:
        maps, rois, _ = _fpn_inputs(31, 1, 500, 32, dev)
        kw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=2)
    else:
        maps = [torch.randn(1, 38, 76, 64, device=dev).permute(0, 3, 1, 2)]
        rois = _rois(31, 1, 500, 38, 76, 900.0).to(dev)
        kw = dict(scales=(1 / 16,), output_size=14, sampling_ratio=0)
    before = kernels.LAUNCHES["roi_align_fwd"]
    with torch.no_grad():
        got = poolers.pool_rois(maps, rois, **kw, impl="cuda")
        want = poolers.pool_rois(maps, rois, **kw, impl="plain")
    assert kernels.LAUNCHES["roi_align_fwd"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", [None, 2 * 1024, 4 * 1024])
def test_roi_align_fwd_tiling_extremes(dev, monkeypatch, target):
    """The forward kernel's tile at its extremes on the card: ROIs covering
    the whole C4 map at cap 8 (its widest bin rows), and with the target cut
    so far that the tile holds a handful of pixels, so the ROIs are walked in
    many steps and bins wider than the tile read their corners from L2."""
    if target is not None:
        monkeypatch.setattr(roi_align_cuda, "FWD_SMEM_TARGET", target)
    tile, _ = roi_align_cuda.fwd_tiling(38, 76, 14, 8)
    assert tile == 177 if target is None else tile < 16
    gen = torch.Generator().manual_seed(41)
    feats = torch.randn(1, 38, 76, 64, generator=gen).to(dev).permute(
        0, 3, 1, 2)
    rois = torch.cat([torch.tensor([WHOLE_MAP + EDGE_ROIS]),
                      _rois(42, 1, 60, 38, 76, 900.0)], 1).to(dev)
    kw = dict(spatial_scale=1 / 16, output_size=14, sampling_ratio=0,
              max_samples=8)
    got = roi_align_cuda.roi_align_forward(feats, rois, **kw)
    torch.testing.assert_close(got, roi_align.roi_align(feats, rois, **kw),
                               rtol=1e-5, atol=1e-5)


def test_roi_align_plain_on_card_matches_cpu(dev):
    """The plain version computes the same function on either device: its
    bin sizes are IEEE quotients on the card too (PyTorch's CUDA division by
    a Python scalar is a reciprocal multiply, an ulp off, which the bilinear
    samples magnify past 1e-5 on a 38x76 map)."""
    gen = torch.Generator().manual_seed(5)
    feats = torch.randn(1, 38, 76, 64, generator=gen).permute(0, 3, 1, 2)
    rois = _rois(5, 1, 300, 38, 76, 900.0)
    kw = dict(spatial_scale=1.0 / 16, output_size=14, sampling_ratio=0,
              max_samples=8)
    on_card = roi_align.roi_align(feats.to(dev), rois.to(dev), **kw)
    torch.testing.assert_close(on_card.cpu(),
                               roi_align.roi_align(feats, rois, **kw),
                               rtol=1e-5, atol=1e-5)


def test_roi_align_kernel_refuses_other_layouts(dev):
    rois = torch.zeros(1, 2, 4, device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        roi_align_cuda.roi_align(torch.zeros(1, 8, 5, 5, device=dev), rois,
                                 spatial_scale=1.0, output_size=2)
    with pytest.raises(ValueError, match="C % 4"):
        roi_align_cuda.roi_align(
            torch.zeros(1, 5, 5, 6, device=dev).permute(0, 3, 1, 2), rois,
            spatial_scale=1.0, output_size=2)


OFF_MAP = [[-40.0, -30.0, 60.0, 50.0], [200.0, 120.0, 300.0, 200.0],
           [-100.0, -100.0, -50.0, -50.0], [1e4, 1e4, 2e4, 2e4],
           [30.0, 40.0, 30.0, 40.0], [80.0, 90.0, 20.0, 10.0],
           [-16.0, 0.0, 1300.0, 700.0]]


EDGE_ROIS = [[-100.0, 100.0, 200.0, 300.0], [100.0, -100.0, 300.0, 200.0],
             [1100.0, 100.0, 1400.0, 300.0], [100.0, 500.0, 300.0, 800.0],
             [-50.0, -50.0, 60.0, 40.0], [1150.0, 560.0, 1300.0, 700.0]]
WHOLE_MAP = [[0.0, 0.0, 1216.0, 608.0], [-30.0, -20.0, 1250.0, 640.0]]

# case: (B, C, H, W, P, sampling ratio, spatial scale, ROIs or (B, R))
BWD_CASES = {
    "slice": (1, 1024, 38, 76, 14, 0, 1 / 16, (1, 256)),  # the train step
    "p7_s2_r11": (2, 128, 10, 16, 7, 2, 1 / 16, (2, 11)),
    "off_map_s0": (1, 64, 38, 76, 14, 0, 1 / 16, OFF_MAP),
    "off_map_s2": (1, 64, 38, 76, 14, 2, 1 / 16, OFF_MAP),
    "empty": (1, 1024, 38, 76, 14, 0, 1 / 16, (1, 0)),
    "whole_c4": (1, 1024, 38, 76, 14, 0, 1 / 16, WHOLE_MAP),
    "whole_p2": (1, 256, 152, 304, 7, 2, 1 / 4, WHOLE_MAP[:1]),
    "edges": (1, 64, 38, 76, 14, 0, 1 / 16, EDGE_ROIS),
    "c4": (1, 4, 38, 76, 14, 0, 1 / 16, (1, 20)),
    "c12": (2, 12, 38, 76, 7, 2, 1 / 16, (2, 9)),
    # 800 rows: Ay passes the 48 KB target, the kernel's limit is raised
    "tall": (1, 8, 800, 8, 14, 0, 1 / 16, [[0.0, 0.0, 128.0, 12800.0],
                                           [10.0, 300.0, 90.0, 5000.0]]),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_roi_align_backward_kernel_matches_plain(dev, case):
    """At the train step's shapes ([1,1024,38,76], R = 256, P = 14) and on
    the edge cases: ROIs off the map, degenerate and inverted, none, the
    whole C4 and P2 maps, straddling each edge, channel counts that leave
    the last 32-channel slice partly empty, and a map tall enough to need
    more than 48 KB of shared memory a block."""
    gen = torch.Generator().manual_seed(11)
    b, c, h, w, p, sr, scale, rois = BWD_CASES[case]
    if isinstance(rois, tuple):
        rois = _rois(3, *rois, h, w, 900.0) if rois[1] else torch.zeros(
            rois[0], 0, 4)
    else:
        rois = torch.tensor([rois], dtype=torch.float32)
    rois = rois.to(dev)
    kw = dict(spatial_scale=scale, output_size=p, sampling_ratio=sr,
              max_samples=8)
    g = torch.randn(b, rois.shape[1], c, p, p, generator=gen).to(dev)
    before = kernels.LAUNCHES["roi_align_bwd"]
    got = roi_align_cuda.roi_align_backward(g, rois, height=h, width=w, **kw)
    want = roi_align.roi_align_grad(g, rois, height=h, width=w, **kw)
    assert kernels.LAUNCHES["roi_align_bwd"] == before + (case != "empty")
    assert got.is_contiguous(memory_format=torch.channels_last)
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    if case == "empty":
        assert not got.any()
    else:
        assert scale > 0


def test_roi_align_backward_reads_strided_grad(dev):
    """An R slice of a channels-last gradient is read in place (no copy)
    and gives the same dF as its contiguous copy."""
    gen = torch.Generator().manual_seed(13)
    full = torch.randn(1, 12, 14, 14, 64, generator=gen).to(dev)
    grad = full.permute(0, 1, 4, 2, 3)[:, 2:9]
    assert not roi_align_cuda.grad_view(grad)[1]
    rois = _rois(6, 1, 7, 38, 76, 900.0).to(dev)
    kw = dict(height=38, width=76, spatial_scale=1 / 16, output_size=14,
              sampling_ratio=0, max_samples=8)
    got = roi_align_cuda.roi_align_backward(grad, rois, **kw)
    want = roi_align.roi_align_grad(grad.contiguous(), rois, **kw)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_roi_align_autograd_function_on_card(dev):
    """The pooler's route: forward kernel, then backward kernel on the
    gradient autograd hands over (a permuted view)."""
    gen = torch.Generator().manual_seed(12)
    feats = torch.randn(1, 38, 76, 64, generator=gen).to(dev).permute(
        0, 3, 1, 2).requires_grad_()
    rois = _rois(4, 1, 40, 38, 76, 900.0).to(dev)
    kw = dict(spatial_scale=1.0 / 16, output_size=14, sampling_ratio=0,
              max_samples=8)
    g = torch.randn(1, 40, 64, 14, 14, generator=gen).to(dev)
    before = dict(kernels.LAUNCHES)
    out = roi_align_cuda.roi_align(feats, rois, **kw)
    (got,) = torch.autograd.grad((out * g).sum(), feats)
    assert kernels.LAUNCHES["roi_align_fwd"] == before.get("roi_align_fwd",
                                                           0) + 1
    assert kernels.LAUNCHES["roi_align_bwd"] == before.get("roi_align_bwd",
                                                           0) + 1
    want = roi_align.roi_align_grad(g, rois, height=38, width=76, **kw)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_train_step_kernels_match_plain(dev):
    """One train step of the narrowed flagship through the kernels against
    the same step through the plain versions, same weights and draws."""
    step, (state, args) = entry.train_entry(device="cuda", aligned=True)
    model = state.model
    results = []
    for impl in ("cuda", "plain"):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(3)
        losses, _ = model.train_forward(*args[:2], state.da_state, *args[2:],
                                        aligned=True, deterministic=True,
                                        generator=gen, impl=impl)
        sum(losses.values()).backward()
        results.append(({k: v.item() for k, v in losses.items()},
                        {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.requires_grad}))
    (lk, gk), (lp, gp) = results
    assert set(lk) == set(lp)
    for k in lp:
        assert lk[k] == pytest.approx(lp[k], rel=1e-4), (k, lk, lp)
    # leaves whose terms cancel to near zero: a floor of 1e-6 of the
    # model's largest gradient
    floor = 1e-6 * max(float(g.abs().max()) for g in gp.values())
    for n, g in gp.items():
        torch.testing.assert_close(gk[n], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + floor)


GATHER_CASES = {
    # name: (S, C, P, row stride or None)
    "probe": (76 * 152, 512, 4 * 76 * 152, None),   # the TPU probe's shape
    "res5_tap": (19 * 38, 2048, 4 * 722, None),
    "quad_res3": (46208 - 1 - 304, 4 * 512, 11552, None),
    "c6_scalar": (50, 6, 333, None),                # no 16-byte vectors
    "column_slice": (40, 16, 257, 48),              # a deformable group
    "empty": (10, 8, 0, None),
}


def _gather_inputs(case, dtype, dev):
    s, c, p, stride = GATHER_CASES[case]
    gen = torch.Generator().manual_seed(s + p)
    wide = torch.randn(s, stride or c, generator=gen).to(dtype)
    table = wide[:, 8:8 + c] if stride else wide
    # a tenth of the indices out of range on either side: clamped
    idx = torch.randint(-s // 10 - 1, s + s // 10 + 1, (p,), generator=gen,
                        dtype=torch.int32)
    return table.to(dev), idx.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GATHER_CASES))
@pytest.mark.parametrize("name", ["row_gather", "row_gather_bulk"])
def test_row_gather_kernels_match_plain(dev, name, case, dtype):
    table, idx = _gather_inputs(case, dtype, dev)
    fn = getattr(gather_cuda, name)
    if name == "row_gather_bulk" and case == "c6_scalar":
        with pytest.raises(ValueError, match="16-byte"):
            fn(table, idx)
        return
    before = kernels.LAUNCHES[name]
    got = fn(table, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + (case != "empty")
    want = gather.row_gather(table, idx)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("gather_mode,kernel", [("four", "row_gather"),
                                                ("quad", "row_gather_bulk")])
def test_deform_conv_kernels_match_plain(dev, gather_mode, kernel):
    """A res4-like deformable conv (32 groups, offsets of a few pixels, so
    corners fall between pixels and off the map): one gather launch a tap,
    and the same output as the plain gathers to 1e-5."""
    from da_detect_tpu_torch.layers import DeformConv2d

    torch.manual_seed(0)
    m = DeformConv2d(256, 256, 3, stride=2, groups=32,
                     gather_mode=gather_mode).to(dev)
    with torch.no_grad():
        m.conv_offset.weight.normal_(0.0, 0.05)
    x = torch.randn(1, 256, 19, 38, device=dev).contiguous(
        memory_format=torch.channels_last)
    before = kernels.LAUNCHES[kernel]
    with torch.no_grad():
        got = m(x, impl="cuda")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[kernel] == before + 9
        want = m(x, impl="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
