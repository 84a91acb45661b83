"""The port's DeformConv2d against the JAX package's, on bridged weights and
the same input, in the cases of tests/test_deform_conv.py: DCNv1 and DCNv2,
stride 1 and 2, dilation, deformable groups 1 and 2, grouped (ResNeXt)
kernels of width <= 16 (JAX's block-diagonal dense lowering) and > 16 (its
grouped contraction), each in both gather modes ("four", and "quad", which
falls back to "four" with deformable groups, as in JAX).

The numpy weights draw every conv kernel, ``conv_offset`` included (scaled
by 2.5), so the samples leave the grid, take fractional corner weights and
fall off the map. Tolerance rtol = atol = 1e-5: the corner sums run in the
same order, the contraction over taps and channels in another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.layers import deform_conv as jdc
from da_detect_tpu_torch.layers import DeformConv2d
from da_detect_tpu_torch.layers import deform_conv as pdc
from tests.torch_harness import (module_state, nhwc_to_torch,
                                 random_variables, torch_to_nhwc)

CASES = {
    # name: (h, w, c, f, stride, dilation, dg, groups, modulated)
    "v1": (7, 6, 4, 5, 1, 1, 1, 1, False),
    "v2": (7, 6, 4, 5, 1, 1, 1, 1, True),
    "v1_s2_d2_dg2": (9, 8, 4, 5, 2, 2, 2, 1, False),
    "v2_s2_d2_dg2": (9, 8, 4, 5, 2, 2, 2, 1, True),
    "grouped_w2_dense": (6, 7, 8, 8, 1, 1, 1, 4, True),
    "grouped_w20": (5, 6, 40, 20, 2, 1, 1, 2, False),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(case, gather_mode, seed=0, offset_scale=2.5):
    h, w, c, f, stride, dil, dg, groups, modulated = CASES[case]
    x = np.random.RandomState(seed).randn(2, h, w, c).astype(np.float32)
    jm = jdc.DeformConv2d(features=f, kernel_size=3, strides=stride,
                          dilation=dil, feature_group_count=groups,
                          deformable_groups=dg, modulated=modulated,
                          gather_mode=gather_mode)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_variables(
        shapes, seed=seed + 1, scales={"conv_offset/kernel": offset_scale})
    pm = DeformConv2d(c, f, 3, stride=stride, dilation=dil, groups=groups,
                      deformable_groups=dg, modulated=modulated,
                      gather_mode=gather_mode)
    pm.load_state_dict(module_state(variables, "backbone/conv2",
                                    "backbone.conv2."), strict=True)
    return jm, variables, pm, x


@pytest.mark.parametrize("gather_mode", ["four", "quad"])
@pytest.mark.parametrize("case", list(CASES))
def test_deform_conv_matches_jax(case, gather_mode):
    jm, variables, pm, x = _pair(case, gather_mode)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    xt = nhwc_to_torch(x)
    with torch.no_grad():
        got = pm(xt, impl="plain")
        via_wrappers = pm(xt, impl="cuda")
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(torch_to_nhwc(got), want, rtol=1e-5,
                               atol=1e-5)
    # impl="cuda" on CPU tensors: the kernel wrappers' plain branches
    torch.testing.assert_close(via_wrappers, got, rtol=0, atol=0)


@pytest.mark.parametrize("gather_mode", ["four", "quad"])
def test_zero_offsets_equal_plain_conv(gather_mode):
    """With the zero-initialised offset predictor a deformable conv is a
    plain grouped 3x3 conv (every sample on the grid, corner weights
    (1, 0, 0, 0)); rtol = atol = 1e-5 (another summation order)."""
    torch.manual_seed(0)
    m = DeformConv2d(8, 6, 3, stride=2, groups=2, gather_mode=gather_mode)
    x = torch.randn(2, 8, 9, 7).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = m(x, impl="plain")
        want = torch.nn.functional.conv2d(x, m.weight, stride=2, padding=1,
                                          groups=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sampling_helpers_match_jax():
    """Corner indices exactly, weights to 1e-7: coordinates on and off the
    map, on the grid and between it."""
    rng = np.random.RandomState(4)
    ys = np.concatenate([rng.uniform(-3, 10, 300),
                         np.arange(-2, 9, dtype=np.float64)]).astype(
        np.float32)
    xs = np.concatenate([rng.uniform(-3, 9, 300),
                         np.arange(-2, 9, dtype=np.float64)]).astype(
        np.float32)
    for jfn, pfn in ((jdc._corner_indices, pdc._corner_indices),
                     (jdc._quad_slot_weights, pdc._quad_slot_weights)):
        j_idx, j_wts = jfn(jnp.asarray(ys), jnp.asarray(xs), 7, 6)
        p_idx, p_wts = pfn(torch.from_numpy(ys), torch.from_numpy(xs), 7, 6)
        assert p_idx.dtype == torch.int32
        np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(p_wts.numpy(), np.asarray(j_wts),
                                   rtol=0, atol=1e-7)


def test_offset_channel_order():
    """conv_offset's channels read as JAX reads them: (group, tap, (dy,
    dx)) offsets, then the mask logits. A bias that moves only tap 0's dy
    of group 1 moves that sample alone."""
    m = DeformConv2d(4, 4, 3, deformable_groups=2, modulated=True)
    nk = 9
    with torch.no_grad():
        m.conv_offset.bias[2 * nk * 1 + 0] = 0.25     # group 1, tap 0, dy
        m.conv_offset.bias[2 * 2 * nk + nk + 3] = 1.0  # mask of g1, tap 3
    ys, xs, mask = m._sample_grid(torch.zeros(1, 4, 5, 5))
    base_ys, base_xs, _ = DeformConv2d(4, 4, 3, deformable_groups=2,
                                       modulated=True)._sample_grid(
        torch.zeros(1, 4, 5, 5))
    moved = (ys - base_ys) != 0
    assert moved[..., 1, 0].all() and int(moved.sum()) == 25
    assert torch.equal(xs, base_xs)
    assert torch.allclose(mask[..., 1, 3], torch.sigmoid(torch.tensor(1.0)))
    assert int((mask != 0.5).sum()) == 25
