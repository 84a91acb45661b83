"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one (which need not have JAX, so tests/conftest.py is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

NMS keep masks must agree exactly, truncated ones (``max_keep``) too;
ROIAlign to rtol = atol = 1e-5 (float32 sums in another order), one level
or four in one launch; the ROIAlign
backward within 1e-5 of the largest |dF| (its sums run in another order)
and bit for bit equal to its own rerun (a fixed order, no atomics); one train
step through the kernels against the same step through the plain versions:
losses rtol 1e-4, gradients within 1e-3 of each leaf's largest |g|. The two
row gathers are copies and must equal the plain version bit for bit; a
deformable convolution through them agrees with its plain run to 1e-5. The
gathers' adjoint, the scatter-add kernel, sums each destination row's
sources in source order, a row of more than ``LONG_ROW`` sources in pieces
(no atomics): it equals its own order run on the CPU
(``row_scatter_add_csr_``) and its own second run bit for bit, and the
CPU's ``index_add_`` on every row it sums in source order; it writes every
row of an uninitialised output, and stays within 1e-5 of the largest |dst|
of the card's ``index_add_`` (which adds with atomics); so are the
gradients of a gather and of a deformable convolution through it (1e-5 of
each leaf's largest |g|). A narrowed
X-101-FPN-DCN triplet step through the kernels agrees with its plain run as
the flagship's does, with exact launch counts.

bfloat16 (the JAX package's compute dtype): the ROIAlign forward kernel
keeps float32 weights and sums and rounds each output once, where the plain
version (the JAX package's einsum form) also rounds its weights and its
first contraction; so the kernel is held to within one bfloat16 ulp of each
output of the plain version run in float32 on the same (bfloat16) inputs,
and to 4 ulps of the largest |output| of the plain version run in bfloat16.
The ROIAlign backward sums dF in float32 and rounds it once: within one ulp
of each value of the float32 plain adjoint of the same gradient (plus
1e-5 of the largest |dF| for the other order of its sums), and 4 ulps of the
largest |dF| of the bfloat16 plain adjoint. The bfloat16 scatter-add sums in
float32 in the kernel's order and rounds once: bit for bit its plain order
(``row_scatter_add_csr_``, which widens, sums and rounds the same way) and
its own rerun. The bfloat16 train steps, kernel-run against plain-run, are
held relative to what bfloat16 itself does to the step (the plain step of
an f32 copy of the model): each loss within one bfloat16 ulp or twice the
plain bf16 step's distance from the f32 one, each gradient leaf (L2) within
twice that distance plus one ulp of its norm; with random weights, ulp-level
differences move a bfloat16 step's gradients far more than a fixed bound
would allow.

The sanity gate's GroupNorm model in bfloat16: its float32 C4 map takes
the float32 ROIAlign kernels (forward and backward), launched and held to
the plain step as the bf16 steps are.

DDP: the train step at world size 1 through NCCL equals the unwrapped step
bit for bit (cuDNN deterministic), and ``entry.dryrun_multichip(1)`` passes
its own checks.

FBNet and RetinaNet: the ROIAlign kernels at the FBNet poolers' shapes (P
6, adaptive sampling, 16 x 512 ROIs, 128 and 88 channels), a narrowed FBNet
Mask R-CNN step through the kernels against its plain run as the
flagship's; NMS on RetinaNet's class-offset boxes exactly, and a narrowed
RetinaNet request through the kernel equal to its plain run, its train
step launching no kernel.

Keypoint R-CNN and the demo: the bfloat16 model's C4 mask and keypoint
predictors compute in float32 on the card as on the CPU (1e-5); the
keypoint pooler's site (P 14, sampling 2, P2-P5 of 800x1344 at C 256; 100
and 2 x 512 ROIs) through one forward launch and a backward launch a
level against the plain pooler; a narrowed keypoint step through the
kernels against its plain run (losses; the gradients against the plain
step on the forward kernel's pooled values, since a ReLU input within
rounding of 0 flips between the two runs); ``COCODemo`` on the card with
a request's launches, equal to its plain run.

The data path: the packed transport (one pinned buffer a step, copied on a
side stream) gives the CPU loader's batches bit for bit to a consumer that
reads each batch late; the TTA merge's NMS launch keeps the plain version's
indices.

Serving: each kernel's operator (``ops/library.py``) launches its kernel
once and equals its wrapper bit for bit; the bfloat16 flagship at 320x640
exported as an ``aot`` artifact answers as the eager forward bit for bit,
a replay launching what an eager request launches (read from a profile).
"""

import time

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
    (1, 9, 38, 76, 8, 14, 0, 4), (2, 5, 7, 9, 4, 7, 0, 8),
    # the FBNet poolers: P 6, adaptive sampling, 16 images of 512 ROIs on
    # the 320x640 map at 128 channels and the 600x1000 one at 88 (the last
    # 32-channel slice 24 wide)
    (16, 512, 20, 40, 128, 6, 0, 8), (16, 512, 38, 63, 88, 6, 0, 8)])
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


@pytest.mark.parametrize("r,c", [(300, 64), (512, 256)])
def test_roi_align_levels_autograd_matches_plain(dev, r, c):
    """dF of each level through the level-aware autograd function (one
    forward launch, a backward launch a level on the masked gradient)
    against autograd of the plain form; 512 ROIs at C 256 are the DCN
    train step's (256 sampled ROIs an image, two box-head passes)."""
    maps, rois, levels = _fpn_inputs(21, 1, r, c, dev)
    kw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=2,
              max_samples=8)
    g = torch.randn(1, r, c, 7, 7, generator=torch.Generator(
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
    # 800 rows: 50 tiles in a column, ROIs across many of them
    "tall": (1, 8, 800, 8, 14, 0, 1 / 16, [[0.0, 0.0, 128.0, 12800.0],
                                           [10.0, 300.0, 90.0, 5000.0]]),
    # more ROIs than a block tests against its tile at a time (BWD_CHUNK)
    "chunks": (1, 64, 38, 76, 7, 2, 1 / 16, (1, 1100)),
    # the FBNet poolers' train step: P 6, adaptive sampling, 16 x 512 ROIs
    "fbnet_c128": (16, 128, 20, 40, 6, 0, 1 / 16, (16, 512)),
    "fbnet_c88": (16, 88, 38, 63, 6, 0, 1 / 16, (16, 512)),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_roi_align_backward_kernel_matches_plain(dev, case):
    """At the train step's shapes ([1,1024,38,76], R = 256, P = 14) and on
    the edge cases: ROIs off the map, degenerate and inverted, none, the
    whole C4 and P2 maps, straddling each edge, channel counts that leave
    the last 32-channel slice partly empty, a tall map, and more ROIs than a
    block takes at a time. A second launch gives the same dF bit for bit
    (each value summed in a fixed order, no atomics)."""
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
    assert torch.equal(
        roi_align_cuda.roi_align_backward(g, rois, height=h, width=w, **kw),
        got)


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


@pytest.mark.parametrize("max_keep", [None, 100])
def test_nms_kernel_class_offset_boxes(dev, max_keep):
    """RetinaNet's site: 5000 candidates of 80 classes offset by class x
    (largest coordinate + 1), out near 1.1e5 px, at IoU 0.4, whole and
    stopped at 100 kept: the plain version's keep mask exactly."""
    boxes, valid = _boxes(5, 1, 5000)
    cls = torch.from_numpy(np.random.RandomState(6).randint(
        1, 81, (1, 5000)).astype(np.float32))
    boxes = boxes + cls[..., None] * (boxes.max() + 1.0)
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms_cuda.nms_mask_sorted(boxes, valid, 0.4, max_keep)
    want = nms.nms_mask_sorted(boxes, valid, 0.4, max_keep)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(want.sum()) == (max_keep or int(want.sum())) >= 100


def _narrow_fbnet_cfg(yaml):
    cfg = entry.fbnet_cfg(yaml, dtype="float32")
    cfg.MODEL.FBNET.SCALE_FACTOR = 0.5
    cfg.TPU.IMAGE_SHAPE = (128, 192)
    cfg.TPU.MAX_GT_BOXES = 8
    cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 9
    return cfg


def test_fbnet_step_kernels_match_plain(dev):
    """One source-only step of the narrowed FBNet Mask R-CNN (4 images,
    512 ROIs each) through the kernels against the same step through the
    plain versions: losses rtol 1e-4, gradients within 1e-3 of each leaf's
    largest |g| (plus 1e-6 of the model's largest); the kernels launched
    once each a pooler (NMS once: the RPN has one level)."""
    cfg = _narrow_fbnet_cfg(entry.FBNET_MASK_YAML)
    cfg.SOLVER.IMS_PER_BATCH = 32       # 4 images a card
    step, (state, args) = entry.source_train_entry(device=str(dev), cfg=cfg)
    model = state.model
    results = []
    for impl in ("cuda", "plain"):
        model.zero_grad(set_to_none=True)
        before = dict(kernels.LAUNCHES)
        gen = torch.Generator(device=dev).manual_seed(3)
        losses, _ = model.train_forward(*args, state.da_state,
                                        deterministic=True, generator=gen,
                                        impl=impl)
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        ran = {k: kernels.LAUNCHES[k] - before.get(k, 0)
               for k in ("nms", "roi_align_fwd", "roi_align_bwd")}
        assert ran == ({"nms": 1, "roi_align_fwd": 2, "roi_align_bwd": 2}
                       if impl == "cuda" else dict.fromkeys(ran, 0))
        results.append(({k: v.item() for k, v in losses.items()},
                        {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.requires_grad}))
    (lk, gk), (lp, gp) = results
    assert set(lk) == set(lp) and lp["loss_mask"] > 0
    for k in lp:
        assert lk[k] == pytest.approx(lp[k], rel=1e-4), (k, lk, lp)
    floor = 1e-6 * max(float(g.abs().max()) for g in gp.values())
    for n, g in gp.items():
        torch.testing.assert_close(gk[n], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + floor)


def test_retinanet_kernel_route_matches_plain(dev):
    """The narrowed RetinaNet on the card: a request through the NMS kernel
    (one launch) equals the plain run exactly, the class logits spread so
    that candidates pass the threshold; a train step launches no kernel."""
    cfg = entry.retinanet_cfg(dtype="float32")
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 32
    cfg.TPU.IMAGE_SHAPE = (256, 384)
    fn, (model, batch) = entry.entry(device=str(dev), cfg=cfg)
    with torch.no_grad():
        model.rpn["head"].cls_logits.bias.zero_()
        model.rpn["head"].cls_logits.weight.mul_(30.0)
    before = kernels.LAUNCHES["nms"]
    got = fn(model, batch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nms"] == before + 1
    want = model(batch, impl="plain")
    assert int(got.valid.sum()) == cfg.TEST.DETECTIONS_PER_IMG
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    step, (state, args) = entry.source_train_entry(device=str(dev), cfg=cfg)
    before = dict(kernels.LAUNCHES)
    state, metrics = step(state, *args)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == before
    assert all(np.isfinite(float(v)) for v in metrics.values())


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


SCATTER_CASES = {
    # name: (S, C, P, row stride or None, index range [lo, hi))
    "res3_four": (76 * 152, 512, 4 * 76 * 152, None, None),
    "res5_four": (19 * 38, 2048, 4 * 722, None, None),
    "quad_res3": (46208 - 1 - 304, 4 * 512, 11552, None, None),  # 4C rows
    "column_slice": (40, 16, 257, 48, None),        # a deformable group
    "c6_scalar": (50, 6, 333, None, None),           # no 16-byte vectors
    "out_of_range": (300, 64, 5000, None, (-400, 700)),
    "one_hot_row": (1000, 128, 20000, None, (17, 18)),  # every index alike
    "empty": (10, 8, 0, None, None),
}


def _scatter_inputs(case, dev):
    """(the whole map, the [S, C] destination in it, grad, idx)."""
    s, c, p, stride, span = SCATTER_CASES[case]
    gen = torch.Generator().manual_seed(s + p)
    lo, hi = span or (-s // 10 - 1, s + s // 10 + 1)
    grad = torch.randn(p, c, generator=gen)
    idx = torch.randint(lo, hi, (p,), generator=gen, dtype=torch.int32)
    wide = torch.randn(s, stride or c, generator=gen).to(dev)
    dst = wide[:, 8:8 + c] if stride else wide
    return wide, dst, grad.to(dev), idx.to(dev)


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_row_scatter_add_kernel_matches_index_add(dev, case):
    """The kernel adds into dst (strided or not) in place; index_add_ on a
    copy is the reference, within 1e-5 of its largest |dst|; columns
    outside a slice untouched; one launch unless empty."""
    wide, dst, grad, idx = _scatter_inputs(case, dev)
    want = wide.clone()
    cols = slice(8, 8 + dst.shape[1]) if dst is not wide else slice(None)
    gather.row_scatter_add_(want[:, cols], grad, idx)
    before = kernels.LAUNCHES["row_scatter_add"]
    assert gather_cuda.row_scatter_add_(dst, grad, idx) is dst
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_scatter_add"] == before + (case != "empty")
    torch.testing.assert_close(wide, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    fresh = gather_cuda.row_scatter_add(grad, idx, dst.shape[0])
    torch.testing.assert_close(
        fresh, gather.row_scatter_add(grad, idx, dst.shape[0]), rtol=0,
        atol=1e-5 * max(float(fresh.abs().max()) if fresh.numel() else 0,
                        1.0))


def _cpu_order(start, grad, idx):
    """What the kernel computes from ``start`` (a CPU copy of the
    destination), in its order (``row_scatter_add_csr_``), and which rows
    it sums in source order (at most LONG_ROW sources), on the CPU."""
    grad, idx = grad.cpu(), idx.cpu()
    perm, row_ptr = gather.row_csr(idx, start.shape[0])
    short = (row_ptr[1:] - row_ptr[:-1]) <= gather.LONG_ROW
    return gather.row_scatter_add_csr_(start.clone(), grad, perm,
                                       row_ptr), short


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_row_scatter_add_kernel_matches_cpu_bit_for_bit(dev, case):
    """In place (strided or not) and into a fresh output: the kernel's
    sums equal the CPU's index_add_ bit for bit on every row of at most
    LONG_ROW sources (both add in source order), and on every row the
    kernel's order in plain PyTorch on the CPU (the out-of-range indices
    pile a tenth of the sources onto each end row, and one_hot_row all of
    them onto one: those rows are summed in pieces); the given CSR and the
    one the wrapper builds agree."""
    wide, dst, grad, idx = _scatter_inputs(case, dev)
    s = dst.shape[0]
    start = dst.cpu()
    ordered, short = _cpu_order(start, grad, idx)
    added = gather.row_scatter_add_(start.clone(), grad.cpu(), idx.cpu())
    outside = wide.cpu()
    gather_cuda.row_scatter_add_(dst, grad, idx)
    got = dst.cpu()
    assert torch.equal(got, ordered)
    assert torch.equal(got[short], added[short])
    if dst is not wide:
        outside[:, 8:8 + dst.shape[1]] = got
        assert torch.equal(wide.cpu(), outside)
    fresh, _ = _cpu_order(torch.zeros(dst.shape), grad, idx)
    assert torch.equal(gather_cuda.row_scatter_add(grad, idx, s).cpu(), fresh)
    csr = gather.row_csr(idx, s)
    assert torch.equal(gather_cuda.row_scatter_add(grad, idx, s, csr).cpu(),
                       fresh)
    if case == "one_hot_row":
        assert not short[17]


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_row_scatter_add_kernel_is_deterministic(dev, case):
    """Two launches on the same inputs give the same bits."""
    _, dst, grad, idx = _scatter_inputs(case, dev)
    csr = gather.row_csr(idx, dst.shape[0])
    first = gather_cuda.row_scatter_add(grad, idx, dst.shape[0], csr)
    second = gather_cuda.row_scatter_add(grad, idx, dst.shape[0], csr)
    assert torch.equal(first, second)


@pytest.mark.parametrize("accumulate", [False, True],
                         ids=["overwrite", "add"])
@pytest.mark.parametrize("case", ["column_slice", "c6_scalar", "res5_four",
                                  "one_hot_row"])
def test_row_scatter_add_writes_its_columns_only(dev, case, accumulate):
    """The map's columns outside the [S, C] view are NaN. Overwriting (the
    fresh output's launch: its memory is uninitialised) writes every row of
    the view over NaN, a row without a source as zeros; adding sums into
    the view's old values. Either way the view equals the kernel's order on
    the CPU bit for bit and the columns outside it stay NaN."""
    wide, dst, grad, idx = _scatter_inputs(case, dev)
    c = dst.shape[1]
    if dst is not wide:
        wide[:, :8] = float("nan")
        wide[:, 8 + c:] = float("nan")
    if not accumulate:
        dst.fill_(float("nan"))
    want, _ = _cpu_order(dst.cpu() if accumulate else torch.zeros(dst.shape),
                         grad, idx)
    assert gather_cuda._scatter(dst, grad, idx, None, accumulate) is dst
    assert torch.equal(dst.cpu(), want)
    if dst is not wide:
        assert torch.isnan(wide[:, :8]).all()
        assert torch.isnan(wide[:, 8 + c:]).all()


def test_row_scatter_add_refuses_other_dtypes(dev):
    dst = torch.zeros(8, 16, device=dev, dtype=torch.bfloat16)
    grad = torch.ones(4, 16, device=dev, dtype=torch.bfloat16)
    idx = torch.arange(4, device=dev, dtype=torch.int32)
    for bad_dst, bad_grad in ((dst.half(), grad.half()), (dst, grad.float()),
                              (dst.float(), grad)):
        with pytest.raises(ValueError, match="both"):
            gather_cuda.row_scatter_add_(bad_dst, bad_grad, idx)
    # bfloat16 launches: rows 0..3 get one source each, summed in float32
    # and rounded once
    got = gather_cuda.row_scatter_add_(dst, grad, idx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu()[:4], torch.ones(4, 16, dtype=torch.bfloat16))
    assert not got[4:].any()
    with pytest.raises(ValueError, match="contiguous"):
        gather_cuda.row_scatter_add_(dst.float(), grad.float().t(), idx)
    perm, row_ptr = gather.row_csr(idx, 8)
    for bad in ((perm.long(), row_ptr), (perm, row_ptr[:-1]),
                (perm[:3], row_ptr)):
        with pytest.raises(ValueError, match="csr"):
            gather_cuda.row_scatter_add_(dst.float(), grad.float(), idx, bad)


@pytest.mark.parametrize("case", ["probe", "quad_res3", "column_slice"])
@pytest.mark.parametrize("name", ["row_gather", "row_gather_bulk"])
def test_row_gather_autograd_matches_plain(dev, name, case):
    """A gather's output has a grad_fn on a table that needs a gradient;
    its backward (one scatter-add launch) equals autograd of the plain
    gather to 1e-5 of the largest |dtable|."""
    table, idx = _gather_inputs(case, torch.float32, dev)
    cot = torch.randn(idx.shape[0], table.shape[1],
                      generator=torch.Generator().manual_seed(5)).to(dev)
    grads = []
    for fn in (getattr(gather_cuda, name), gather.row_gather):
        leaf = table.detach().clone().requires_grad_()
        out = fn(leaf, idx)
        assert out.grad_fn is not None
        before = kernels.LAUNCHES["row_scatter_add"]
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        grads.append(leaf.grad)
        if fn is not gather.row_gather:
            assert kernels.LAUNCHES["row_scatter_add"] == before + 1
    got, want = grads
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("gather_mode,kernel", [("four", "row_gather"),
                                                ("quad", "row_gather_bulk")])
def test_deform_conv_backward_kernels_match_plain(dev, gather_mode, kernel):
    """The res4-like deformable conv's backward through the kernels: 9
    gathers forward, 9 again in the backward (each tap recomputed), 9
    scatter-adds, one CSR built for all 9 taps; dx, dweight and conv_offset's gradients within 1e-5 of
    each leaf's largest |g| of the plain run, and dx not zero."""
    from da_detect_tpu_torch.layers import DeformConv2d

    torch.manual_seed(0)
    m = DeformConv2d(256, 256, 3, stride=2, groups=32,
                     gather_mode=gather_mode).to(dev)
    with torch.no_grad():
        m.conv_offset.weight.normal_(0.0, 0.05)
    x0 = torch.randn(1, 256, 19, 38, device=dev).contiguous(
        memory_format=torch.channels_last)
    cot = torch.randn(1, 256, 10, 19, device=dev)
    grads = []
    for impl in ("cuda", "plain"):
        x = x0.clone().requires_grad_()
        m.zero_grad(set_to_none=True)
        before = dict(kernels.LAUNCHES)
        built = gather.CSR_BUILDS["row_csr"]
        (m(x, impl=impl) * cot).sum().backward()
        torch.cuda.synchronize()
        made = {k: kernels.LAUNCHES[k] - before.get(k, 0)
                for k in (kernel, "row_scatter_add")}
        made["row_csr"] = gather.CSR_BUILDS["row_csr"] - built
        assert made == ({kernel: 18, "row_scatter_add": 9, "row_csr": 1}
                        if impl == "cuda" else
                        {kernel: 0, "row_scatter_add": 0, "row_csr": 0})
        grads.append({"x": x.grad, **{n: p.grad for n, p
                                      in m.named_parameters()}})
    got, want = grads
    assert got["x"] is not None and float(got["x"].abs().max()) > 0
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("gather_mode,dg", [("four", 1), ("four", 2),
                                            ("quad", 1)])
def test_deform_conv_hands_each_tap_its_csr(dev, monkeypatch, gather_mode,
                                            dg):
    """In training (autograd on, an input on the card that needs a
    gradient) a deformable conv builds one CSR for all its taps and
    deformable groups, and each gather, in the forward and in the
    backward's recompute, gets the CSR of its own indices (``row_csr`` of
    that tap and group alone). Under torch.no_grad(), or with an input
    that needs no gradient, none is built or handed over."""
    from da_detect_tpu_torch.layers import DeformConv2d

    torch.manual_seed(0)
    m = DeformConv2d(32, 16, 3, stride=2 if dg == 2 else 1,
                     dilation=dg, deformable_groups=dg, modulated=dg == 2,
                     gather_mode=gather_mode).to(dev)
    with torch.no_grad():
        m.conv_offset.weight.normal_(0.0, 0.5)
    handed = []

    def recorder(kernel):
        def rec(table, idx, csr=None):
            handed.append((table.shape[0], idx.clone(), csr))
            return kernel(table, idx, csr)
        return rec

    for name in ("row_gather", "row_gather_bulk"):
        monkeypatch.setattr(gather_cuda, name,
                            recorder(getattr(gather_cuda, name)))
    x0 = torch.randn(2, 32, 12, 17, device=dev)
    for grad_on, needs_grad, builds in ((True, True, 1), (False, True, 0),
                                        (True, False, 0)):
        handed.clear()
        before = gather.CSR_BUILDS["row_csr"]
        x = x0.clone().requires_grad_(needs_grad)
        with torch.set_grad_enabled(grad_on):
            out = m(x)
        if grad_on:
            out.sum().backward()
        torch.cuda.synchronize()
        assert gather.CSR_BUILDS["row_csr"] == before + builds
        assert len(handed) == 9 * dg * (2 if grad_on else 1)
        for rows, idx, csr in handed:
            if not builds:
                assert csr is None
                continue
            want_perm, want_ptr = gather.row_csr(idx, rows)
            assert torch.equal(csr[0], want_perm)
            assert torch.equal(csr[1], want_ptr)


def test_dcn_train_step_kernels_match_plain(dev):
    """One triplet step of the X-101-32x8d-FPN-DCN YAML narrowed (canvas
    128x192, stem 8, 4 groups x 2, res2 16, FPN 16, MLP head 32, depth 101)
    through the kernels against the same step through the plain versions;
    its launches: 270 gathers a backbone pass forward and 270 recomputed in
    the backward, 270 scatter-adds a pass, 3 passes; NMS a level a RPN pass
    (5 x 2); ROIAlign forward a box-head pass (2) and backward a level a
    pass (4 x 2)."""
    from da_detect_tpu_torch.layers import DeformConv2d

    cfg = entry.dcn_train_cfg((128, 192), dtype="float32")
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.NUM_GROUPS, r.WIDTH_PER_GROUP = 8, 4, 2
    r.RES2_OUT_CHANNELS = 16
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
    cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 32
    cfg.TPU.MAX_GT_BOXES = 8
    _, (state, args) = entry.train_entry(device="cuda", cfg=cfg)
    model = state.model
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                m.conv_offset.weight.normal_(0.0, 0.01)
    results = []
    for impl in ("cuda", "plain"):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(3)
        kernels.LAUNCHES.clear()
        losses, _ = model.train_forward(*args[:2], state.da_state, *args[2:],
                                        deterministic=True, generator=gen,
                                        impl=impl)
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        results.append(({k: v.item() for k, v in losses.items()},
                        {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.requires_grad}))
        if impl == "cuda":
            assert launches == {"row_gather": 3 * 540,
                                "row_scatter_add": 3 * 270, "nms": 10,
                                "roi_align_fwd": 2, "roi_align_bwd": 8}
        else:
            assert not any(launches.values())
    (lk, gk), (lp, gp) = results
    assert set(lk) == set(lp)
    for k in lp:
        assert lk[k] == pytest.approx(lp[k], rel=1e-4), (k, lk, lp)
    floor = 1e-6 * max(float(g.abs().max()) for g in gp.values())
    for n, g in gp.items():
        torch.testing.assert_close(gk[n], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + floor)


# ------------------------------------------------------------- bfloat16


def bf16_ulp(x: float) -> float:
    """One bfloat16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _ulps_within(got, want32, ulps=1.0, floor=0.0):
    """Every value of ``got`` (bfloat16) within ``ulps`` bfloat16 ulps of
    the magnitude of its float32 reference ``want32``, plus ``floor``."""
    g, w = got.float(), want32.float()
    mag = w.abs().clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bad = (g - w).abs() > ulps * ulp + floor
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} values past {ulps} ulp: worst "
        f"{float(((g - w).abs() / ulp).max()):.2f} ulp")


@pytest.mark.parametrize("b,r,h,w,c,p,sr,cap", [
    (2, 11, 10, 16, 128, 7, 2, 8), (1, 37, 38, 76, 64, 14, 0, 8),
    (1, 9, 38, 76, 8, 14, 0, 4), (2, 5, 7, 9, 16, 7, 0, 8),
    (1, 256, 38, 76, 1024, 14, 0, 8)])
def test_roi_align_bf16_kernel_matches_plain(dev, b, r, h, w, c, p, sr, cap):
    """A bfloat16 map pooled through the bfloat16 kernel: the output is
    bfloat16, within one ulp of each value of the float32 plain version on
    the same (bfloat16-valued) map, and within 4 ulps of the largest
    |output| of the bfloat16 plain version."""
    feats = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(r)
                        ).to(dev, torch.bfloat16).permute(0, 3, 1, 2)
    rois = _rois(r, b, r, h, w, 2000.0).to(dev)
    kw = dict(spatial_scale=1.0 / 16, output_size=p, sampling_ratio=sr,
              max_samples=cap)
    before = kernels.LAUNCHES["roi_align_fwd"]
    got = roi_align_cuda.roi_align(feats, rois, **kw)
    assert kernels.LAUNCHES["roi_align_fwd"] == before + 1
    assert got.dtype == torch.bfloat16
    _ulps_within(got, roi_align.roi_align(feats.float(), rois, **kw),
                 floor=1e-6)
    want = roi_align.roi_align(feats, rois, **kw)
    assert want.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=4 * bf16_ulp(float(want.float().abs().max())))


@pytest.mark.parametrize("b,r,c,sr,empty_level", [
    (1, 1000, 256, 2, None), (2, 300, 64, 0, 1), (2, 0, 64, 2, None)])
def test_roi_align_levels_bf16_kernel_matches_plain(dev, b, r, c, sr,
                                                   empty_level):
    """The level-aware launch over P2-P5 in bfloat16, against the plain
    every-level-then-mask form in float32 (one ulp a value) and in bfloat16
    (4 ulps of the largest |output|)."""
    maps, rois, levels = _fpn_inputs(7, b, r, c, dev, empty_level)
    maps = [m.to(torch.bfloat16) for m in maps]
    kw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=sr,
              max_samples=8)
    got = roi_align_cuda.roi_align_levels_forward(maps, rois, levels, **kw)
    assert got.dtype == torch.bfloat16
    if not got.numel():
        return
    _ulps_within(got, roi_align.roi_align_levels([m.float() for m in maps],
                                                 rois, levels, **kw),
                 floor=1e-6)
    want = roi_align.roi_align_levels(maps, rois, levels, **kw)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=4 * bf16_ulp(float(want.float().abs().max())))


@pytest.mark.parametrize("case", [k for k, v in BWD_CASES.items()
                                  if v[1] % 8 == 0])
def test_roi_align_backward_bf16_kernel_matches_plain(dev, case):
    """The bfloat16 backward: dF comes back bfloat16 (channels-last),
    within one ulp of each value of the float32 plain adjoint of the same
    gradient plus 1e-5 of its largest |dF| (float32 sums in another
    order), and within 4 ulps of the largest |dF| of the bfloat16 plain
    adjoint (autograd of the bfloat16 plain forward)."""
    gen = torch.Generator().manual_seed(11)
    b, c, h, w, p, sr, scale, rois = BWD_CASES[case]
    if isinstance(rois, tuple):
        rois = _rois(3, *rois, h, w, 900.0) if rois[1] else torch.zeros(
            rois[0], 0, 4)
    else:
        rois = torch.tensor([rois], dtype=torch.float32)
    rois = rois.to(dev)
    kw = dict(height=h, width=w, spatial_scale=scale, output_size=p,
              sampling_ratio=sr, max_samples=8)
    g = torch.randn(b, rois.shape[1], c, p, p, generator=gen).to(
        dev, torch.bfloat16)
    before = kernels.LAUNCHES["roi_align_bwd"]
    got = roi_align_cuda.roi_align_backward(g, rois, **kw)
    assert kernels.LAUNCHES["roi_align_bwd"] == before + (case != "empty")
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    want32 = roi_align.roi_align_grad(g.float(), rois, **kw)
    if case == "empty":
        assert not got.any()
        return
    top = float(want32.abs().max())
    assert top > 0
    _ulps_within(got, want32, floor=1e-5 * top)
    want = roi_align.roi_align_grad(g, rois, **kw)
    assert want.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=4 * bf16_ulp(float(want.float().abs().max())))


def test_roi_align_bf16_autograd_and_strided_grad(dev):
    """The pooler's route in bfloat16: the forward kernel, then the
    backward kernel on the bfloat16 gradient autograd hands over, read in
    place when it is an R slice of a channels-last buffer."""
    gen = torch.Generator().manual_seed(12)
    feats = torch.randn(1, 38, 76, 64, generator=gen).to(
        dev, torch.bfloat16).permute(0, 3, 1, 2).requires_grad_()
    rois = _rois(4, 1, 40, 38, 76, 900.0).to(dev)
    kw = dict(spatial_scale=1.0 / 16, output_size=14, sampling_ratio=0,
              max_samples=8)
    full = torch.randn(1, 42, 14, 14, 64, generator=gen).to(
        dev, torch.bfloat16)
    g = full.permute(0, 1, 4, 2, 3)[:, 1:41]
    assert not roi_align_cuda.grad_view(g)[1]
    out = roi_align_cuda.roi_align(feats, rois, **kw)
    (got,) = torch.autograd.grad(out, feats, g)
    assert got.dtype == torch.bfloat16
    want32 = roi_align.roi_align_grad(g.float(), rois, height=38, width=76,
                                      **kw)
    _ulps_within(got, want32, floor=1e-5 * float(want32.abs().max()))


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_row_scatter_add_bf16_kernel_bit_for_bit(dev, case):
    """bfloat16 gradient rows into a bfloat16 destination, in place
    (strided or not) and into a fresh output: bit for bit the kernel's
    order in plain PyTorch (summed in float32, each value rounded once),
    equal to its own second run, and one launch a call unless empty."""
    wide, dst, grad, idx = _scatter_inputs(case, dev)
    wide = wide.to(torch.bfloat16)
    dst = wide[:, 8:8 + dst.shape[1]] if dst.shape[1] != wide.shape[1] \
        else wide
    grad = grad.to(torch.bfloat16)
    s = dst.shape[0]
    start = dst.cpu()
    outside = wide.cpu()
    ordered, _ = _cpu_order(start, grad, idx)
    before = kernels.LAUNCHES["row_scatter_add"]
    assert gather_cuda.row_scatter_add_(dst, grad, idx) is dst
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_scatter_add"] == before + (case != "empty")
    assert dst.dtype == torch.bfloat16
    assert torch.equal(dst.cpu(), ordered)
    if dst is not wide:
        outside[:, 8:8 + dst.shape[1]] = ordered
        assert torch.equal(wide.cpu(), outside)
    fresh, _ = _cpu_order(torch.zeros(dst.shape, dtype=torch.bfloat16), grad,
                          idx)
    csr = gather.row_csr(idx, s)
    first = gather_cuda.row_scatter_add(grad, idx, s, csr)
    second = gather_cuda.row_scatter_add(grad, idx, s)
    assert first.dtype == torch.bfloat16
    assert torch.equal(first.cpu(), fresh)
    assert torch.equal(first, second)


@pytest.mark.parametrize("gather_mode,kernel", [("four", "row_gather"),
                                                ("quad", "row_gather_bulk")])
def test_deform_conv_bf16_kernels_match_plain(dev, gather_mode, kernel):
    """The res4-like deformable conv in bfloat16 through the kernels: the
    bfloat16 gather variants forward and recomputed, the bfloat16
    scatter-add backward; the output (float32) equal to the plain run's
    (the gathers are copies); dweight and conv_offset's gradients (float32,
    from the same gathered rows) within 1e-5 of each leaf's largest |g|;
    dx (bfloat16: nine taps' scatter-adds, each rounded once, summed by
    autograd in bfloat16, where the plain run's CUDA index_add_ adds in
    another order) within 4 bfloat16 ulps of its largest |g|."""
    from da_detect_tpu_torch.layers import DeformConv2d

    torch.manual_seed(0)
    m = DeformConv2d(256, 256, 3, stride=2, groups=32,
                     gather_mode=gather_mode, dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        m.conv_offset.weight.normal_(0.0, 0.05)
    x0 = torch.randn(1, 256, 19, 38, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    cot = torch.randn(1, 256, 10, 19, device=dev)
    outs, grads = [], []
    for impl in ("cuda", "plain"):
        x = x0.clone().requires_grad_()
        m.zero_grad(set_to_none=True)
        before = dict(kernels.LAUNCHES)
        out = m(x, impl=impl)
        assert out.dtype == torch.float32
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        if impl == "cuda":
            assert kernels.LAUNCHES[kernel] - before.get(kernel, 0) == 18
            assert kernels.LAUNCHES["row_scatter_add"] - before.get(
                "row_scatter_add", 0) == 9
        outs.append(out.detach())
        grads.append({"x": x.grad, **{n: p.grad for n, p
                                      in m.named_parameters()}})
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    got, want = grads
    assert got["x"].dtype == torch.bfloat16
    assert float(got["x"].float().abs().max()) > 0
    for name, w in want.items():
        top = float(w.float().abs().max())
        tol = 4 * bf16_ulp(top) if name == "x" else 1e-5 * top
        torch.testing.assert_close(got[name].float(), w.float(), rtol=0,
                                   atol=tol, msg=name)


def _bf16_step_pair(dev, cfg, aligned, offsets_std=None):
    """One bfloat16 train step through the kernels and through the plain
    versions, same weights and draws, and the step of an f32 copy of the
    model (the same float32 parameters) through the plain versions:
    (losses, grads) of each. ``offsets_std``: the deformable convs' offset
    predictors drawn at that std."""
    from da_detect_tpu_torch.layers import DeformConv2d
    from da_detect_tpu_torch.models import build_detection_model

    _, (state, args) = entry.train_entry(device="cuda", cfg=cfg,
                                         aligned=aligned)
    model = state.model
    if offsets_std:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, DeformConv2d):
                    m.conv_offset.weight.normal_(0.0, offsets_std)
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    ref = build_detection_model(cfg32)
    ref.load_state_dict(model.state_dict())
    ref = entry.prepare_model(ref, dev)
    results = []
    for m, impl in ((model, "cuda"), (model, "plain"), (ref, "plain")):
        m.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(3)
        losses, _ = m.train_forward(*args[:2], state.da_state, *args[2:],
                                    aligned=aligned, deterministic=True,
                                    generator=gen, impl=impl)
        sum(losses.values()).backward()
        results.append(({k: v.item() for k, v in losses.items()},
                        {n: p.grad.clone() for n, p in m.named_parameters()
                         if p.requires_grad}))
    return results


def _assert_bf16_steps_match(results):
    """Kernel-run against plain-run bf16 step, relative to what bfloat16
    itself does (the plain f32 step): each loss within one bf16 ulp of its
    value or twice |plain - f32|; each gradient leaf, in L2, within twice
    ||plain - f32|| plus one bf16 ulp of ||plain||."""
    (lk, gk), (lp, gp), (lr, gr) = results
    assert set(lk) == set(lp) == set(lr)
    for k in lp:
        bound = max(bf16_ulp(abs(lp[k])), 2 * abs(lp[k] - lr[k]))
        assert abs(lk[k] - lp[k]) <= bound, (k, lk[k], lp[k], lr[k])
    for n, g in gp.items():
        assert g.dtype == gk[n].dtype == torch.float32, n
        bound = 2 * float((g - gr[n]).norm()) + bf16_ulp(float(g.norm()))
        assert float((gk[n] - g).norm()) <= bound, n


def test_train_step_bf16_kernels_match_plain(dev):
    """The narrowed flagship's aligned triplet step in bfloat16 (float32
    parameters and gradients), through the kernels against the plain
    versions."""
    cfg = entry.train_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    _assert_bf16_steps_match(_bf16_step_pair(dev, cfg, aligned=True))


def test_dcn_train_step_bf16_kernels_match_plain(dev):
    """The narrowed X-101-32x8d-FPN-DCN triplet step (as in
    test_dcn_train_step_kernels_match_plain) in bfloat16, through the
    kernels against the plain versions."""
    cfg = entry.dcn_train_cfg((128, 192))
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.NUM_GROUPS, r.WIDTH_PER_GROUP = 8, 4, 2
    r.RES2_OUT_CHANNELS = 16
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
    cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 32
    cfg.TPU.MAX_GT_BOXES = 8
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    _assert_bf16_steps_match(_bf16_step_pair(dev, cfg, aligned=False,
                                             offsets_std=0.01))


# ------------------------------------------------- data transport and TTA

def _tiny_triple_cfg(root, monkeypatch):
    """A port cfg over a synthetic 120x160 triple written under ``root`` and
    named in the port's catalog (undone with ``monkeypatch``): one triple a
    step, uint8 pixels, 2 batches prefetched."""
    from da_detect_tpu_torch.config import get_cfg
    from da_detect_tpu_torch.config.catalog import DatasetCatalog
    from da_detect_tpu_torch.data.synthetic import write_triplet_datasets

    dirs = write_triplet_datasets(str(root))
    original = DatasetCatalog.get

    def get(name):
        if not name.startswith("synth_"):
            return original(name)
        img_dir, ann = dirs[name[len("synth_"):]]
        return {"factory": "COCODataset",
                "args": {"root": img_dir, "ann_file": ann}}

    monkeypatch.setattr(DatasetCatalog, "get", staticmethod(get))
    cfg = get_cfg()
    cfg.merge_from_list([
        "DATASETS.SOURCE_TRAIN", ("synth_clean",),
        "DATASETS.TARGET_TRAIN", ("synth_foggy",),
        "DATASETS.TARGET_TRAIN_negative", ("synth_rainy",),
        "INPUT.MIN_SIZE_TRAIN", (96, 120), "INPUT.MAX_SIZE_TRAIN", 160,
        "DATALOADER.SIZE_DIVISIBILITY", 32, "DATALOADER.NUM_WORKERS", 0,
        "DATALOADER.STAGE_CACHE", False, "SOLVER.IMS_PER_BATCH", 2,
        "TPU.MAX_GT_BOXES", 6, "TPU.PREFETCH", 2])
    return cfg


def test_packed_transport_survives_a_slow_consumer(dev, tmp_path,
                                                   monkeypatch):
    """Two epochs of triples through the packed transport on the card,
    each batch read late by its consumer's stream (a device sleep queued
    before the read, then a host sleep) while the producer runs ahead: every
    tensor equals the CPU loader's bit for bit. A pinned buffer reused
    before its copy completes, or a device buffer handed back to the
    allocator while the consumer's stream still reads it, would show."""
    from da_detect_tpu_torch.data import make_data_loader_da

    cfg = _tiny_triple_cfg(tmp_path, monkeypatch)
    steps = 16  # 8 images, 1 triple a step: two epochs
    want = []
    loader = make_data_loader_da(cfg, device="cpu", seed=3)
    for _ in range(steps):
        want.append(next(loader))
    loader.close()
    loader = make_data_loader_da(cfg, device=dev, seed=3, packed=True)
    got = []
    for _ in range(steps):
        batch = next(loader)
        torch.cuda._sleep(20_000_000)
        got.append([{f: getattr(x, f).clone() for f in vars(x)
                     if getattr(x, f) is not None}  # Targets.masks
                    for x in batch])
        del batch
        time.sleep(0.02)
    stats = loader.stats
    loader.close()
    torch.cuda.synchronize()
    assert stats["bytes"] > 0 and stats["batches"] >= steps
    for step, (g, w) in enumerate(zip(got, want)):
        for gx, wx in zip(g, w):
            for f, t in gx.items():
                assert t.device.type == "cuda"
                assert torch.equal(t.cpu(), getattr(wx, f)), (step, f)


def test_tta_merge_kernel_matches_plain(dev):
    """The TTA merge's NMS site: one kernel launch an image over [classes,
    N], the same indices in the same order as the plain version."""
    from da_detect_tpu_torch.engine.bbox_aug import merge_per_class

    for seed in range(4):
        rng = np.random.RandomState(seed)
        n = 800  # 8 passes x 100 detections
        c = rng.uniform(20, 1000, (n // 10, 2))[rng.randint(0, n // 10, n)]
        c = c + rng.normal(0, 6, (n, 2))
        wh = rng.uniform(10, 120, (n, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
        scores = np.round(rng.uniform(0.05, 1.0, n), 2).astype(np.float32)
        labels = rng.randint(1, 9, n)
        before = kernels.LAUNCHES["nms"]
        got = merge_per_class(boxes, scores, labels, 0.3, 100, device=dev,
                              impl="cuda")
        assert kernels.LAUNCHES["nms"] == before + 1
        want = merge_per_class(boxes, scores, labels, 0.3, 100,
                               device=torch.device("cpu"), impl="plain")
        np.testing.assert_array_equal(got, want)


def test_gn_sanity_model_runs_f32_roi_align_in_bf16(dev, tmp_path,
                                                    monkeypatch):
    """The sanity gate's GN model (``tools/sanity_check.py``, the ablation's
    triplet-DA arm) in bfloat16 on a loader batch of its synthetic data:
    its GN body hands the pooler a float32 C4 map, so the step launches the
    float32 ROIAlign forward and backward kernels (2 each, and 2 NMS) inside
    the bfloat16 model; kernel-run against plain-run as the bf16 steps
    above. The kernel-run step twice gives the same losses and gradients
    bit for bit: the learning gate trains on one trajectory."""
    from da_detect_tpu_torch.data import make_data_loader_da
    from da_detect_tpu_torch.engine.trainer import create_train_state
    from da_detect_tpu_torch.models import build_detection_model
    from da_detect_tpu_torch.tools import sanity_check

    root = sanity_check.build_synthetic(str(tmp_path), 4, seed=3,
                                        fog=(0.8, 10.0), invert=True)
    monkeypatch.setenv("DA_DETECT_DATA_DIR", root)
    cfg = sanity_check.sanity_cfg(True, 200)
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    loader = make_data_loader_da(cfg, device=dev, aligned=True, seed=0)
    args = next(loader)
    loader.close()
    model = entry.prepare_model(build_detection_model(cfg, seed=0), dev)
    state = create_train_state(cfg, model, 0, "cosine")
    seen = []
    fwd = roi_align_cuda.roi_align_forward
    bwd = roi_align_cuda.roi_align_backward

    def fwd_rec(features, rois, **kw):
        seen.append(("fwd", features.dtype))
        return fwd(features, rois, **kw)

    def bwd_rec(grad, rois, **kw):
        seen.append(("bwd", grad.dtype))
        return bwd(grad, rois, **kw)

    monkeypatch.setattr(roi_align_cuda, "roi_align_forward", fwd_rec)
    monkeypatch.setattr(roi_align_cuda, "roi_align_backward", bwd_rec)
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    ref = build_detection_model(cfg32)
    ref.load_state_dict(model.state_dict())
    ref = entry.prepare_model(ref, dev)
    results = []
    for m, impl in ((model, "cuda"), (model, "cuda"), (model, "plain"),
                    (ref, "plain")):
        m.zero_grad(set_to_none=True)
        before = dict(kernels.LAUNCHES)
        gen = torch.Generator(device=dev).manual_seed(3)
        losses, _ = m.train_forward(*args[:2], state.da_state, *args[2:],
                                    aligned=True, deterministic=True,
                                    generator=gen, impl=impl)
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0) for k, v in
                    kernels.LAUNCHES.items() if v != before.get(k, 0)}
        assert launched == ({"nms": 2, "roi_align_fwd": 2,
                             "roi_align_bwd": 2} if impl == "cuda" else {})
        results.append(({k: v.item() for k, v in losses.items()},
                        {n: p.grad.clone() for n, p in m.named_parameters()
                         if p.requires_grad}))
    assert seen == ([("fwd", torch.float32)] * 2
                    + [("bwd", torch.float32)] * 2) * 2
    assert model.backbone.body.stem.conv1.compute_dtype == torch.bfloat16
    (losses, grads), (losses2, grads2) = results[:2]
    assert losses == losses2
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)
    _assert_bf16_steps_match(results[1:])


# ---------------------------------------------------------------- DDP

def test_ddp_world1_nccl_step_equals_unwrapped(dev, tmp_path):
    """The train step through DDP at world size 1 (NCCL) against the
    unwrapped step from the same seed, dropout on: 3 steps' losses,
    DAState and parameters bit for bit (cuDNN deterministic), the kernels
    launched as the unwrapped step launches them."""
    from da_detect_tpu_torch import parallel
    from da_detect_tpu_torch.engine.trainer import make_train_step

    cfg = entry.train_cfg()
    step, (state, args) = entry.train_entry(device=str(dev), cfg=cfg)
    _, (d_state, _) = entry.train_entry(device=str(dev), cfg=cfg)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    parallel.init_distributed(dev, init_method=f"file://{tmp_path}/store",
                              rank=0, world_size=1)
    try:
        assert torch.distributed.get_backend() == "nccl"
        d_step = make_train_step(
            d_state.model, d_state.optimizer, aligned=True,
            forward=parallel.wrap_train_forward(d_state.model, "da_triplet"))
        step = make_train_step(state.model, state.optimizer, aligned=True)
        for _ in range(3):
            before = dict(kernels.LAUNCHES)
            state, want = step(state, *args)
            torch.cuda.synchronize()
            mid = dict(kernels.LAUNCHES)
            d_state, got = d_step(d_state, *args)
            torch.cuda.synchronize()
            assert {k: mid[k] - before.get(k, 0) for k in mid} == {
                k: v - mid[k] for k, v in kernels.LAUNCHES.items()}
            assert {k: v.item() for k, v in got.items()} == {
                k: v.item() for k, v in want.items()}
            for f in ("margin_img", "last_triplet_img", "last_triplet_ins"):
                assert torch.equal(getattr(d_state.da_state, f),
                                   getattr(state.da_state, f)), f
            for (n, p), q in zip(state.model.named_parameters(),
                                 d_state.model.parameters()):
                assert torch.equal(p, q), n
    finally:
        parallel.shutdown()
        torch.backends.cudnn.deterministic = deterministic


def test_dryrun_multichip_one_card(dev, capsys):
    out = entry.dryrun_multichip(1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("dryrun_multichip(1): dp ok over 1 ranks "
                                "(nccl)")
    assert out["backend"] == "nccl" and out["param_bound_used"] <= 1.0


# ---------------------------------------------------------------- Keypoint

@pytest.mark.parametrize("kind", ["mask_c4", "keypoint"])
def test_float32_predictors_bf16_on_the_card(dev, kind):
    """The bfloat16 model's C4 mask predictor and keypoint predictor round
    their input to bfloat16 and compute in float32 (TF32 off), as the JAX
    package's do: float32 logits on the card equal to the CPU's to 1e-5."""
    from da_detect_tpu_torch.models import keypoint_head, mask_head

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(41)
    if kind == "mask_c4":
        mod = mask_head.MaskRCNNC4Predictor(256, 9, 256,
                                            dtype=torch.bfloat16)
        x = torch.randn(2, 50, 256, 14, 14, generator=gen)
    else:
        mod = keypoint_head.KeypointRCNNPredictor(512, 17,
                                                  dtype=torch.bfloat16)
        x = torch.randn(1, 100, 512, 14, 14, generator=gen)
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        want = mod(x)
        got = mod.to(dev)(x.to(dev))
    assert got.dtype == torch.float32
    assert got.shape[-1] == (28 if kind == "mask_c4" else 52)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


KP_SHAPES = ((200, 336), (100, 168), (50, 84), (25, 42))


@pytest.mark.parametrize("b,r", [(1, 100), (2, 512)])
def test_keypoint_pooler_on_the_card(dev, b, r):
    """The keypoint pooler's site (800x1344: P2-P5 at 256 channels, P 14,
    sampling 2; 100 detections of a request, 512 ROIs on each of 2 training
    images): one forward launch against the plain pooler (rtol = atol =
    1e-5), then a backward launch a level, dF within 1e-5 of the largest
    |dF| of the plain adjoint."""
    gen = torch.Generator().manual_seed(42)
    maps = [torch.randn(b, h, w, 256, generator=gen).to(dev).permute(
        0, 3, 1, 2) for h, w in KP_SHAPES]
    rng = np.random.RandomState(43)
    side = np.exp(rng.uniform(np.log(8), np.log(800), (b, r, 2)))
    xy = rng.uniform(-20, (1344, 800), (b, r, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).astype(
        np.float32)).to(dev)
    kw = dict(scales=FPN_SCALES, output_size=14, sampling_ratio=2)
    g = torch.randn(b, r, 256, 14, 14, generator=gen).to(dev)
    grads = []
    for impl in ("cuda", "plain"):
        leaves = [m.detach().clone().requires_grad_() for m in maps]
        before = dict(kernels.LAUNCHES)
        out = poolers.pool_rois(leaves, rois, **kw, impl=impl)
        grads.append((out.detach(), torch.autograd.grad((out * g).sum(),
                                                        leaves)))
        torch.cuda.synchronize()
        ran = {k: kernels.LAUNCHES.get(k, 0) - before.get(k, 0)
               for k in ("roi_align_fwd", "roi_align_bwd")}
        assert ran == ({"roi_align_fwd": 1, "roi_align_bwd": 4}
                       if impl == "cuda" else dict.fromkeys(ran, 0))
    (out_k, dk), (out_p, dp) = grads
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-5)
    for got, want in zip(dk, dp):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def _narrow_keypoint_cfg():
    cfg = entry.keypoint_cfg(dtype="float32")
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 64
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (64,) * 8
    cfg.TPU.IMAGE_SHAPE = (256, 384)
    cfg.TPU.MAX_GT_BOXES = 8
    return cfg


def test_keypoint_step_kernels_match_plain(dev, monkeypatch):
    """One source-only step of the narrowed Keypoint R-CNN (2 images of 512
    ROIs, GT keypoints) through the kernels against the same step through
    the plain versions: the losses (``loss_kp`` included) rtol 1e-4; NMS 5
    (the RPN's levels), ROIAlign forward 2 (the box and keypoint poolers)
    and backward 8 (a level each). The two runs' pooled features differ by
    float32 rounding, and a ReLU input within rounding of 0 in the box MLP
    or the eight keypoint convs then takes the other side and moves single
    gradient elements past any fixed bound (seen on the card). So the
    gradients are held against a third run: the plain step whose poolers
    give the forward kernel's own values (each within 1e-5 of the plain
    pooler) while their backward stays the plain autograd; every leaf of the
    kernel run within 1e-3 of its largest |g| (plus 1e-6 of the model's
    largest) of that run's: the ROIAlign backward kernels against the plain
    adjoint inside a step."""
    from da_detect_tpu_torch.models import box_head, keypoint_head

    step, (state, args) = entry.source_train_entry(
        device=str(dev), cfg=_narrow_keypoint_cfg())
    model = state.model

    def run(impl, launches):
        model.zero_grad(set_to_none=True)
        before = dict(kernels.LAUNCHES)
        gen = torch.Generator(device=dev).manual_seed(3)
        losses, _ = model.train_forward(*args, state.da_state,
                                        deterministic=True, generator=gen,
                                        impl=impl)
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        ran = {k: kernels.LAUNCHES.get(k, 0) - before.get(k, 0)
               for k in ("nms", "roi_align_fwd", "roi_align_bwd")}
        assert ran == launches, (impl, ran)
        return ({k: v.item() for k, v in losses.items()},
                {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.requires_grad})

    lk, gk = run("cuda", {"nms": 5, "roi_align_fwd": 2, "roi_align_bwd": 8})
    lp, _ = run("plain", {"nms": 0, "roi_align_fwd": 0, "roi_align_bwd": 0})
    assert set(lk) == set(lp) and lp["loss_kp"] > 0
    for k in lp:
        assert lk[k] == pytest.approx(lp[k], rel=1e-4), (k, lk, lp)
    pooled_err = []

    def kernel_values(pool):
        def pool_as_kernel(features, rois, **kw):
            kw.pop("impl")
            plain = pool(features, rois, **kw, impl="plain")
            with torch.no_grad():
                kern = pool(features, rois, **kw, impl="cuda")
            pooled_err.append(float((kern - plain).abs().max()))
            return kern + (plain - plain.detach())
        return pool_as_kernel

    for mod in (box_head, keypoint_head):
        monkeypatch.setattr(mod, "pool_rois", kernel_values(mod.pool_rois))
    lq, gq = run("plain", {"nms": 0, "roi_align_fwd": 2, "roi_align_bwd": 0})
    assert len(pooled_err) == 2 and max(pooled_err) <= 1e-5
    # the same forward values (cuDNN's transposed conv in the keypoint
    # predictor may sum in another order on each run)
    for k in lk:
        assert lq[k] == pytest.approx(lk[k], rel=1e-6), (k, lq, lk)
    floor = 1e-6 * max(float(g.abs().max()) for g in gq.values())
    for n, g in gq.items():
        torch.testing.assert_close(gk[n], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + floor)


def test_coco_demo_on_the_card(dev):
    """``COCODemo`` on the card (the narrowed keypoint YAML): a request
    launches NMS 6 and ROIAlign forward 2, its prediction equals the same
    demo's plain run (the same detections, boxes within 1e-2 px, scores
    within 1e-4, keypoints within 1e-2 px), and the overlay keeps the
    image's shape."""
    from da_detect_tpu_torch.demo import COCODemo

    cfg = _narrow_keypoint_cfg()
    cfg.MODEL.ROI_HEADS.NMS = 0.9
    cfg.MODEL.WEIGHT = ""
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 240, 384
    img = (np.random.RandomState(44).rand(240, 320, 3) * 255).astype(
        np.uint8)
    preds = []
    for impl in ("cuda", "plain"):
        demo = COCODemo(cfg, confidence_threshold=0.0)
        demo.model.impl = impl
        before = dict(kernels.LAUNCHES)
        preds.append(demo.compute_prediction(img))
        torch.cuda.synchronize()
        ran = {k: kernels.LAUNCHES.get(k, 0) - before.get(k, 0)
               for k in ("nms", "roi_align_fwd")}
        assert ran == ({"nms": 6, "roi_align_fwd": 2} if impl == "cuda"
                       else dict.fromkeys(ran, 0))
    (bk, sk, lk, kk), (bp, sp, lp, kp) = preds
    assert len(bk) == len(bp) > 0 and (lk == lp).all()
    np.testing.assert_allclose(bk, bp, rtol=0, atol=1e-2)
    np.testing.assert_allclose(sk, sp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(kk[..., :2], kp[..., :2], rtol=0, atol=1e-2)
    assert demo.run_on_opencv_image(img).shape == img.shape


# -- serving: the kernels' operators and a CUDA-graph ``aot`` artifact ------
def _operator_cases(dev):
    boxes, valid = (t.to(dev) for t in _boxes(7, 2, 700))
    feats = torch.randn(1, 38, 76, 64, generator=torch.Generator()
                        .manual_seed(1)).to(dev).permute(0, 3, 1, 2)
    rois = _rois(2, 1, 50, 38, 76, 400.0).to(dev)
    maps, lrois, levels = _fpn_inputs(3, 1, 200, 64, dev)
    table = torch.randn(500, 64, generator=torch.Generator()
                        .manual_seed(4)).to(dev)
    idx = torch.randint(-5, 505, (900,), generator=torch.Generator()
                        .manual_seed(5), dtype=torch.int32).to(dev)
    ops = torch.ops.da_detect
    kw = dict(spatial_scale=1 / 16, output_size=7, sampling_ratio=2,
              max_samples=8)
    lkw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=2,
               max_samples=8)
    return {
        "nms_keep": (
            "nms", lambda: ops.nms_keep(boxes, valid, 0.7, 100),
            lambda: nms_cuda.nms_mask_sorted(boxes, valid, 0.7, 100),
            lambda: nms.nms_mask_sorted(boxes, valid, 0.7, 100), 0),
        "roi_align": (
            "roi_align_fwd", lambda: ops.roi_align(feats, rois, 1 / 16, 7, 2,
                                                   8),
            lambda: roi_align_cuda.roi_align_forward(feats, rois, **kw),
            lambda: roi_align.roi_align(feats, rois, **kw), 1e-5),
        "roi_align_levels": (
            "roi_align_fwd",
            lambda: ops.roi_align_levels(maps, lrois, levels,
                                         list(FPN_SCALES), 7, 2, 8),
            lambda: roi_align_cuda.roi_align_levels_forward(
                maps, lrois, levels, **lkw),
            lambda: roi_align.roi_align_levels(maps, lrois, levels, **lkw),
            1e-5),
        "row_gather": (
            "row_gather", lambda: ops.row_gather(table, idx),
            lambda: gather_cuda.row_gather(table, idx),
            lambda: gather.row_gather(table, idx), 0),
        "row_gather_bulk": (
            "row_gather_bulk", lambda: ops.row_gather_bulk(table, idx),
            lambda: gather_cuda.row_gather_bulk(table, idx),
            lambda: gather.row_gather(table, idx), 0),
    }


@pytest.mark.parametrize("case", ["nms_keep", "roi_align", "roi_align_levels",
                                  "row_gather", "row_gather_bulk"])
def test_operator_is_its_kernel(dev, case):
    """Each operator on CUDA tensors launches its kernel once: bit for bit
    its wrapper's kernel output, and its plain version's within the
    kernel's own tolerance (exact for NMS and the gathers)."""
    kernel, op, wrapper, plain, tol = _operator_cases(dev)[case]
    before = kernels.LAUNCHES[kernel]
    got = op()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernel] == before + 1
    want = wrapper()
    assert got.stride() == want.stride()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, plain(), rtol=tol, atol=tol)


def _replay_launches(run) -> dict:
    """Device kernels by name in a profile of ``run()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = {"nms": "nms_walk_kernel", "roi_align_fwd": "roi_align_fwd_kernel"}
    return {k: sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and name in e.key)
            for k, name in names.items()}


def test_aot_artifact_replays_the_eager_forward(dev, tmp_path):
    """The bfloat16 flagship at 320x640 as an ``aot`` artifact: its load
    runs the program twice and captures it once (kernels.LAUNCHES counts
    those three forwards, a replay none), its request equals the eager
    forward's bit for bit, a profile of a replay shows the eager request's
    launches (NMS 2, ROIAlign 1), and an edited device kind is refused."""
    import json
    import zipfile

    from da_detect_tpu_torch.engine.serving import (META_FILE,
                                                    export_serving,
                                                    load_serving)

    fn, (model, batch) = entry.entry(device="cuda", seed=0)
    with torch.no_grad():
        model.rpn["head"].cls_logits.weight.mul_(30.0)
        model.roi_heads["box"]["predictor"].cls_score.weight.mul_(30.0)
    cfg = entry.flagship_cfg()
    path = str(tmp_path / "flagship_aot.pt2")
    meta = export_serving(cfg, model, model.state_dict(), path, fmt="aot")
    assert meta["platform"] == "gpu" and meta["device_kind"] == \
        torch.cuda.get_device_name(0)
    before = dict(kernels.LAUNCHES)
    serving = load_serving(path)
    torch.cuda.synchronize()
    per = {"nms": 2, "roi_align_fwd": 1}
    assert {k: kernels.LAUNCHES[k] - before.get(k, 0) for k in per} == {
        k: 3 * n for k, n in per.items()}
    want = fn(model, batch)
    before = dict(kernels.LAUNCHES)
    got = serving(model.state_dict(), batch)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before.get(k, 0) for k in per} == \
        dict.fromkeys(per, 0)
    assert int(want.valid.sum()) > 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _replay_launches(
        lambda: serving(model.state_dict(), batch)) == per
    assert _replay_launches(lambda: fn(model, batch)) == per
    edited = str(tmp_path / "edited.pt2")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(edited, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(f"extra/{META_FILE}"):
                data = json.dumps({**json.loads(data),
                                   "device_kind": "GPU v99"}).encode()
            zout.writestr(item, data)
    with pytest.raises(RuntimeError, match="GPU v99"):
        load_serving(edited)
