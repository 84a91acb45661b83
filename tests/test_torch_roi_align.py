"""The port's ROIAlign (da_detect_tpu_torch/ops/roi_align.py and the CPU
branch of the kernel wrapper ops/roi_align_cuda.py) against the JAX
package's Pallas kernel (interpret mode) and its einsum roi_align_image.
Tolerance rtol = atol = 1e-5: the same float32 sums in another order."""

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
