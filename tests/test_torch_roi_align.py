"""The port's ROIAlign (da_detect_tpu_torch/ops/roi_align.py and the CPU
branch of the kernel wrapper ops/roi_align_cuda.py) against the JAX
package's Pallas kernel (interpret mode) and its einsum roi_align_image,
forward and backward (d features, against jax.grad of both). Tolerance
rtol = atol = 1e-5: the same float32 sums in another order. The plain
version's gradient is also checked numerically in float64 (gradcheck)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.ops import roi_align as jra
from da_detect_tpu.ops import roi_align_pallas as rap
from da_detect_tpu_torch.ops import roi_align as tra
from da_detect_tpu_torch.ops import roi_align_cuda
from tests.torch_harness import nhwc_to_torch

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    interpret = rap.INTERPRET
    rap.INTERPRET = True
    yield
    rap.INTERPRET = interpret
    torch.set_num_threads(threads)


def _random_case(seed, b=2, r=11, h=10, w=16, c=128):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, h, w, c).astype(np.float32)
    x1 = rng.uniform(0, w * 16 - 24, (b, r))
    y1 = rng.uniform(0, h * 16 - 24, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(4, 80, (b, r)),
                     y1 + rng.uniform(4, 80, (b, r))], -1).astype(np.float32)
    return feats, rois


def _port(feats, rois, fn=tra.roi_align, **kw):
    """Port ROIAlign on NHWC numpy input -> [B, R, P, P, C] numpy."""
    out = fn(nhwc_to_torch(feats), torch.from_numpy(rois), **kw)
    return out.permute(0, 1, 3, 4, 2).numpy()


def _einsum(feats, rois, **kw):
    return np.asarray(jax.vmap(lambda f, r: jra.roi_align_image(f, r, **kw))(
        jnp.asarray(feats), jnp.asarray(rois)))


@pytest.mark.parametrize("p,sampling_ratio", [(7, 2), (14, 0)])
def test_roi_align_matches_pallas_kernel(p, sampling_ratio):
    """R = 11, not a multiple of the kernel's ROI block."""
    feats, rois = _random_case(0)
    kw = dict(spatial_scale=1.0 / 16, output_size=p,
              sampling_ratio=sampling_ratio, max_samples=4)
    want = np.asarray(rap.roi_align_pallas(jnp.asarray(feats),
                                           jnp.asarray(rois), **kw))
    np.testing.assert_allclose(_port(feats, rois, **kw), want, **TOL)
    np.testing.assert_allclose(
        _port(feats, rois, fn=roi_align_cuda.roi_align, **kw), want, **TOL)
    np.testing.assert_allclose(_port(feats, rois, **kw),
                               _einsum(feats, rois, **kw), **TOL)


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_out_of_bounds_rois(sampling_ratio):
    """ROIs partly and wholly outside the map, degenerate and inverted: the
    -1/size rule, the edge clamp and the >= 1 size clamp."""
    feats, _ = _random_case(1, b=1, c=16)
    rois = np.asarray([[[-40.0, -30.0, 60.0, 50.0],       # past top-left
                        [200.0, 120.0, 300.0, 200.0],     # past bottom-right
                        [-100.0, -100.0, -50.0, -50.0],   # wholly outside
                        [1e4, 1e4, 2e4, 2e4],
                        [30.0, 40.0, 30.0, 40.0],         # zero size
                        [80.0, 90.0, 20.0, 10.0],         # inverted
                        [-16.0, 0.0, 256.0, 160.0]]],     # covers the map
                      np.float32)
    kw = dict(spatial_scale=1.0 / 16, output_size=7,
              sampling_ratio=sampling_ratio, max_samples=8)
    got = _port(feats, rois, **kw)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, _einsum(feats, rois, **kw), **TOL)
    np.testing.assert_allclose(
        _port(feats, rois, fn=roi_align_cuda.roi_align, **kw), got, **TOL)


@pytest.mark.parametrize("max_samples", [8, 4])
def test_roi_align_wide_roi_sample_cap(max_samples):
    """Canvas-wide proposals on the C4 map of a 608x1216 canvas need
    ceil(76/14) = 6 samples a bin: uncapped at max_samples 8, capped to 4
    uniformly spaced samples at max_samples 4."""
    rng = np.random.RandomState(3)
    feats = rng.randn(1, 38, 76, 8).astype(np.float32)
    rois = np.asarray([[[2.0, 2.0, 1210.0, 600.0],
                        [0.0, 100.0, 1216.0, 180.0],
                        [30.0, 40.0, 200.0, 300.0]]], np.float32)
    kw = dict(spatial_scale=1.0 / 16, output_size=14, sampling_ratio=0,
              max_samples=max_samples)
    np.testing.assert_allclose(_port(feats, rois, **kw),
                               _einsum(feats, rois, **kw), **TOL)


def test_roi_align_image_matches_jax():
    feats, rois = _random_case(4, b=1, r=5, h=12, w=9, c=8)
    kw = dict(spatial_scale=1.0 / 16, output_size=7, sampling_ratio=0)
    want = np.asarray(jra.roi_align_image(jnp.asarray(feats[0]),
                                          jnp.asarray(rois[0]), **kw))
    got = tra.roi_align_image(nhwc_to_torch(feats)[0],
                              torch.from_numpy(rois[0]), **kw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


OOB_ROIS = np.asarray([[[-40.0, -30.0, 60.0, 50.0], [200.0, 120.0, 300.0, 200.0],
                        [-100.0, -100.0, -50.0, -50.0], [1e4, 1e4, 2e4, 2e4],
                        [30.0, 40.0, 30.0, 40.0], [80.0, 90.0, 20.0, 10.0],
                        [-16.0, 0.0, 256.0, 160.0]]], np.float32)


def _port_grads(feats, rois, g, **kw):
    """d features [B, H, W, C] of sum(roi_align * g) (g [B, R, P, P, C]) by
    three routes: autograd of the plain version, autograd of the kernel
    wrapper (the plain version on the CPU), and the backward kernel's
    wrapper called directly (its plain branch, ``roi_align_grad``)."""
    gt = torch.from_numpy(g).permute(0, 1, 4, 2, 3)
    rt = torch.from_numpy(rois)
    out = []
    for fn in (tra.roi_align, roi_align_cuda.roi_align):
        f = nhwc_to_torch(feats).requires_grad_()
        (fn(f, rt, **kw) * gt).sum().backward()
        out.append(f.grad.permute(0, 2, 3, 1).numpy())
    direct = roi_align_cuda.roi_align_backward(
        gt, rt, height=feats.shape[1], width=feats.shape[2], **kw)
    out.append(direct.permute(0, 2, 3, 1).numpy())
    return out


def _jax_grad(fn, feats, rois, g):
    return np.asarray(jax.grad(lambda f: jnp.sum(fn(f) * g))(
        jnp.asarray(feats)))


@pytest.mark.parametrize("p,sampling_ratio", [(7, 2), (14, 0)])
def test_roi_align_backward_matches_jax(p, sampling_ratio):
    """R = 11, not a multiple of the Pallas kernel's ROI block."""
    feats, rois = _random_case(5)
    kw = dict(spatial_scale=1.0 / 16, output_size=p,
              sampling_ratio=sampling_ratio, max_samples=4)
    g = np.random.RandomState(6).randn(2, 11, p, p, 128).astype(np.float32)
    want_pallas = _jax_grad(lambda f: rap.roi_align_pallas(
        f, jnp.asarray(rois), **kw), feats, rois, g)
    want_einsum = _jax_grad(lambda f: jax.vmap(
        lambda fi, ri: jra.roi_align_image(fi, ri, **kw))(
            f, jnp.asarray(rois)), feats, rois, g)
    np.testing.assert_allclose(want_pallas, want_einsum, **TOL)
    for got in _port_grads(feats, rois, g, **kw):
        np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_backward_out_of_bounds_rois(sampling_ratio):
    """ROIs off the map, degenerate and inverted scatter nothing outside
    [-1, size] and clamp at the edges, as the forward reads."""
    feats, _ = _random_case(7, b=1, c=16)
    kw = dict(spatial_scale=1.0 / 16, output_size=7,
              sampling_ratio=sampling_ratio, max_samples=8)
    g = np.random.RandomState(8).randn(1, 7, 7, 7, 16).astype(np.float32)
    want = _jax_grad(lambda f: jax.vmap(
        lambda fi, ri: jra.roi_align_image(fi, ri, **kw))(
            f, jnp.asarray(OOB_ROIS)), feats, OOB_ROIS, g)
    for got in _port_grads(feats, OOB_ROIS, g, **kw):
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, **TOL)


def test_roi_align_backward_empty_rois():
    feats, _ = _random_case(9, b=1, c=8)
    kw = dict(spatial_scale=1.0 / 16, output_size=7, sampling_ratio=2)
    rois = np.zeros((1, 0, 4), np.float32)
    g = np.zeros((1, 0, 7, 7, 8), np.float32)
    for got in _port_grads(feats, rois, g, **kw):
        assert got.shape == feats.shape and not got.any()


@pytest.mark.parametrize("fn", [tra.roi_align, roi_align_cuda.roi_align],
                         ids=["plain", "autograd_function"])
def test_roi_align_gradcheck_float64(fn):
    """The analytic gradient against finite differences in float64 (the
    forward is linear in the features, so the check is exact up to
    rounding)."""
    rng = np.random.RandomState(10)
    feats = torch.from_numpy(rng.randn(1, 3, 6, 7)).requires_grad_()
    rois = torch.from_numpy(np.concatenate(
        [_random_case(11, b=1, r=3, h=6, w=7, c=3)[1], OOB_ROIS[:, [0, 4]]],
        axis=1))
    for sr in (0, 2):
        assert torch.autograd.gradcheck(
            lambda f: fn(f, rois, spatial_scale=1.0 / 16, output_size=3,
                         sampling_ratio=sr, max_samples=4), (feats,))


@pytest.mark.parametrize("h,w,p,samples", [
    (38, 76, 14, 8),     # C4 at 608x1216, the train step's pooler
    (152, 304, 7, 2),    # FPN P2 at 608x1216
    (10, 16, 7, 2),      # a map narrower than a tile
    (800, 8, 14, 8),     # tall: Ay alone passes the 48 KB target
])
def test_bwd_tiling_sizes_shared_memory(h, w, p, samples):
    """The backward kernel's column tile and shared memory: at least one
    column and at most the map's width, within the 48 KB target whenever
    one column fits in it, and the bytes of roi_align_bwd.cu's layout."""
    cols, smem = roi_align_cuda.bwd_tiling(h, w, p, samples)
    per_col = 4 * p * roi_align_cuda.BWD_CHANNELS + 4 * p + 8
    fixed = 32 * p * samples + h * (4 * p + 8) \
        + 4 * p * p * roi_align_cuda.BWD_CHANNELS
    assert 1 <= cols <= w and smem == fixed + cols * per_col
    if fixed + per_col <= roi_align_cuda.BWD_SMEM_TARGET:
        assert smem <= roi_align_cuda.BWD_SMEM_TARGET
        assert cols == w or smem + per_col > roi_align_cuda.BWD_SMEM_TARGET
    else:
        assert cols == 1 and smem <= roi_align_cuda.SMEM_MAX
    if (h, w) == (38, 76):
        assert (cols, smem) == (9, 47808)


def test_bwd_tiling_refuses_a_map_too_tall():
    with pytest.raises(ValueError, match="shared memory"):
        roi_align_cuda.bwd_tiling(5000, 8, 14, 8)


@pytest.mark.parametrize("h,w,p,samples", [
    (38, 76, 14, 8),     # C4 at 608x1216, the eval and train poolers
    (152, 304, 7, 2),    # FPN P2 at 608x1216
    (19, 38, 7, 2),      # FPN P5
    (10, 16, 7, 2),      # a map smaller than the target's tile
])
def test_fwd_tiling_sizes_shared_memory(h, w, p, samples):
    """The forward kernel's tile: at least one pixel and at most the map's,
    within the 48 KB target, and the bytes of roi_align_fwd.cu's layout
    (two buffers of 32-channel pixels, both axes' samples, the bins'
    spans)."""
    tile, smem = roi_align_cuda.fwd_tiling(h, w, p, samples)
    per_pixel = 2 * 4 * roi_align_cuda.BWD_CHANNELS
    fixed = 32 * p * samples + 16 * p
    assert 1 <= tile <= h * w and smem == fixed + tile * per_pixel
    assert smem <= roi_align_cuda.FWD_SMEM_TARGET
    assert tile == h * w or smem + per_pixel > roi_align_cuda.FWD_SMEM_TARGET
    if (h, w) == (38, 76):
        assert (tile, smem) == (177, 49120)


@pytest.mark.parametrize("c,r,b", [
    (1024, 1000, 1),     # C4 eval
    (1024, 256, 1),      # a train step's pooler
    (256, 1000, 1),      # the DCN pooler
    (256, 300, 2),
    (12, 200, 1),        # one partial slice
    (1024, 5, 1),        # few ROIs: a slice a block
])
def test_fwd_slices_spread_channels_over_blocks(c, r, b):
    """The forward kernel's slices a block: every slice in some block, no
    block without one, and at least FWD_BLOCKS_TARGET blocks a launch where
    the slices allow it."""
    n = -(-c // roi_align_cuda.BWD_CHANNELS)
    slices = roi_align_cuda.fwd_slices(c, r, b)
    runs = -(-n // slices)
    assert 1 <= slices <= n and (runs - 1) * slices < n <= runs * slices
    assert runs * r * b >= min(roi_align_cuda.FWD_BLOCKS_TARGET, n * r * b)
    if (c, r) == (1024, 1000):
        assert (slices, runs) == (11, 3)


def test_fwd_tiling_refuses_too_many_samples():
    with pytest.raises(ValueError, match="shared memory"):
        roi_align_cuda.fwd_tiling(38, 76, 128, 64)


def test_levels_wrappers_refuse_other_devices():
    meta = dict(device="meta")
    kw = dict(scales=(0.25, 0.125), output_size=2)
    args = ([torch.empty(1, 4, 5, 5, **meta), torch.empty(1, 4, 3, 3, **meta)],
            torch.empty(1, 3, 4, **meta),
            torch.zeros(1, 3, dtype=torch.int64, **meta))
    for fn in (roi_align_cuda.roi_align_levels,
               roi_align_cuda.roi_align_levels_forward):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args, **kw)


def test_grad_view_reads_channels_last_in_place():
    """The backward kernel reads autograd's channels-last gradient (and an
    R slice of it) in place; other layouts are copied to [B, R, P, P, C]."""
    base = torch.randn(2, 5, 7, 7, 64)                  # [B, R, P, P, C]
    cl = base.permute(0, 1, 4, 2, 3)                    # [B, R, C, P, P]
    for grad in (cl, cl[:, 1:4]):
        g, copied = roi_align_cuda.grad_view(grad)
        assert not copied and g.data_ptr() == grad.data_ptr()
        assert torch.equal(g, grad.permute(0, 1, 3, 4, 2))
    nchw = cl.contiguous()
    g, copied = roi_align_cuda.grad_view(nchw)
    assert copied and g.is_contiguous()
    assert torch.equal(g, base)
