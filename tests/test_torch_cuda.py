"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one (which need not have JAX, so tests/conftest.py is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

NMS keep masks must agree exactly; ROIAlign to rtol = atol = 1e-5 (float32
sums in another order).
"""

import numpy as np
import pytest
import torch

from da_detect_tpu_torch import kernels
from da_detect_tpu_torch.ops import nms, nms_cuda, roi_align, roi_align_cuda

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
