"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one (which need not have JAX, so tests/conftest.py is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

NMS keep masks must agree exactly; ROIAlign to rtol = atol = 1e-5 (float32
sums in another order); the ROIAlign backward within 1e-5 of the largest
|dF| (its atomics add in an order that changes from run to run); one train
step through the kernels against the same step through the plain versions:
losses rtol 1e-4, gradients within 1e-3 of each leaf's largest |g|. The two
row gathers are copies and must equal the plain version bit for bit; a
deformable convolution through them agrees with its plain run to 1e-5.
"""

import numpy as np
import pytest
import torch

from da_detect_tpu_torch import entry, kernels
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
                                        (2, 6000, 0.7)])
def test_nms_kernel_matches_plain(dev, b, n, thresh):
    boxes, valid = (t.to(dev) for t in _boxes(n, b, n))
    before = kernels.LAUNCHES["nms"]
    got = nms_cuda.nms_mask_sorted(boxes, valid, thresh)
    want = nms.nms_mask_sorted(boxes, valid, thresh)
    assert kernels.LAUNCHES["nms"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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


@pytest.mark.parametrize("case", ["slice", "p7_s2_r11", "off_map_s0",
                                  "off_map_s2", "empty"])
def test_roi_align_backward_kernel_matches_plain(dev, case):
    """At the train step's shapes ([1,1024,38,76], R = 256, P = 14) and on
    the edge cases: ROIs off the map, degenerate and inverted, and none."""
    gen = torch.Generator().manual_seed(11)
    b, c, h, w, p, sr = 1, 1024, 38, 76, 14, 0
    if case == "p7_s2_r11":
        b, c, h, w, p, sr = 2, 128, 10, 16, 7, 2
    elif case.startswith("off_map"):
        c, sr = 64, int(case[-1])
    rois = _rois(3, b, 256 if case == "slice" else 11, h, w, 900.0)
    if case.startswith("off_map"):
        rois = torch.tensor([OFF_MAP], dtype=torch.float32)
    elif case == "empty":
        rois = torch.zeros(1, 0, 4)
    rois = rois.to(dev)
    kw = dict(spatial_scale=1.0 / 16, output_size=p, sampling_ratio=sr,
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
