"""The port's FPN pieces against the JAX package's, on the same numpy
inputs and weights: the FPN with LastLevelMaxPool (odd map sizes), the
multi-level anchors, the multi-level eval proposal selection, the level
assignment and multi-level ROI pooling, and the FPN2MLP extractor with the
FPN predictor (fc6 bridged through the (H, W, C) -> (C, H, W) permutation).

Tolerances: anchors, level assignment and proposal validity exactly; FPN
outputs, pooled features and head outputs rtol = atol = 1e-5 (float32
sums in another order); proposal boxes atol 1e-4 (pixels), scores 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.models import anchors as janchors
from da_detect_tpu.models import box_head as jbox
from da_detect_tpu.models import poolers as jpoolers
from da_detect_tpu.models import rpn as jrpn
from da_detect_tpu.models.backbone.fpn import FPN as JFPN
from da_detect_tpu_torch.entry import dcn_cfg
from da_detect_tpu_torch.models import anchors as panchors
from da_detect_tpu_torch.models import box_head as pbox
from da_detect_tpu_torch.models import poolers as ppoolers
from da_detect_tpu_torch.models import rpn as prpn
from da_detect_tpu_torch.models.backbone.fpn import FPN as PFPN
from da_detect_tpu_torch.ops import roi_align as proi
from da_detect_tpu_torch.ops import roi_align_cuda
from da_detect_tpu_torch.utils.weights import jax_state_dict
from tests.torch_harness import (module_state, nhwc_to_torch,
                                 random_variables, torch_to_nhwc)

SCALES = (0.25, 0.125, 0.0625, 0.03125)
POOLER = dict(scales=SCALES, output_size=7, sampling_ratio=2, max_samples=8)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feature_maps(seed, hws, channels):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, h, w, c).astype(np.float32)
            for (h, w), c in zip(hws, channels)]


def test_fpn_matches_jax():
    """C2..C5 of odd sizes: the top-down path upsamples 2x and crops."""
    feats = _feature_maps(0, [(15, 25), (8, 13), (4, 7), (2, 4)],
                          [8, 16, 32, 64])
    jm = JFPN(out_channels=16)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), [jnp.asarray(f)
                                                for f in feats]))
    variables = random_variables(shapes, seed=1)
    want = jm.apply(variables, [jnp.asarray(f) for f in feats])
    pm = PFPN([8, 16, 32, 64], 16)
    pm.load_state_dict(module_state(variables, "backbone/fpn",
                                    "backbone.fpn."), strict=True)
    with torch.no_grad():
        got = pm([nhwc_to_torch(f) for f in feats])
    assert [tuple(g.shape[2:]) for g in got] == [
        (15, 25), (8, 13), (4, 7), (2, 4), (1, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(torch_to_nhwc(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_multi_level_anchors_match_jax():
    """The DCN config's anchors at 608x1216: one size a stride, exactly."""
    cfg = dcn_cfg()
    shapes = [(152, 304), (76, 152), (38, 76), (19, 38), (10, 19)]
    got = panchors.make_anchor_generator(cfg).anchors_for_shapes(shapes)
    rpn = cfg.MODEL.RPN
    want = janchors.AnchorGenerator(
        rpn.ANCHOR_SIZES, rpn.ASPECT_RATIOS,
        rpn.ANCHOR_STRIDE).anchors_for_shapes(shapes)
    assert [a.shape[0] for a in got] == [138624, 34656, 8664, 2166, 570]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="one size per stride"):
        panchors.AnchorGenerator((32, 64), (0.5, 1.0, 2.0), (4, 8, 16))


def test_multi_level_eval_proposals_match_jax():
    """Five levels at canvas 64x96, 3 anchors a cell, 2 images; per level
    top 40 -> NMS 0.7 -> 30, then the top 50 of the 150."""
    hws = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    strides = (4, 8, 16, 32, 64)
    gen = panchors.AnchorGenerator((32, 64, 128, 256, 512), (0.5, 1.0, 2.0),
                                   strides)
    anchors = gen.anchors_for_shapes(hws)
    rng = np.random.RandomState(5)
    logits = [(3 * rng.randn(2, h, w, 3)).astype(np.float32) for h, w in hws]
    deltas = [(0.3 * rng.randn(2, h, w, 12)).astype(np.float32)
              for h, w in hws]
    sizes = np.array([[64, 96], [60, 90]], np.float32)
    kw = dict(pre_nms_top_n=40, post_nms_top_n=30, fpn_post_nms_top_n=50,
              nms_thresh=0.7, min_size=0, is_train=False)
    want = jrpn.select_proposals(
        [jnp.asarray(a) for a in anchors], [jnp.asarray(l) for l in logits],
        [jnp.asarray(d) for d in deltas], jnp.asarray(sizes),
        use_pallas=False, approx_topk=False, **kw)
    for impl in ("plain", "cuda"):
        got = prpn.select_proposals(
            [torch.from_numpy(a) for a in anchors],
            [nhwc_to_torch(l) for l in logits],
            [nhwc_to_torch(d) for d in deltas], torch.from_numpy(sizes),
            impl=impl, **kw)
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        assert int(got.valid.sum()) >= 60
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=0,
                                   atol=1e-6)
    with pytest.raises(NotImplementedError, match="training"):
        prpn.select_proposals(
            [torch.from_numpy(a) for a in anchors],
            [nhwc_to_torch(l) for l in logits],
            [nhwc_to_torch(d) for d in deltas], torch.from_numpy(sizes),
            impl="plain", **{**kw, "is_train": True})


def _rois(seed, b, r):
    """ROIs from 4 to 700 pixels a side, so every level gets some."""
    rng = np.random.RandomState(seed)
    side = np.exp(rng.uniform(np.log(4), np.log(700), (b, r, 2)))
    x1 = rng.uniform(-20, 100, (b, r))
    y1 = rng.uniform(-20, 60, (b, r))
    return np.stack([x1, y1, x1 + side[..., 0], y1 + side[..., 1]],
                    -1).astype(np.float32)


def _pyramid(seed, c):
    return _feature_maps(seed, [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)],
                         [c] * 5)


def test_level_assignment_and_pooling_match_jax():
    rois = _rois(6, 2, 60)
    want_lvl = np.asarray(jpoolers.assign_levels(jnp.asarray(rois), 2, 5))
    got_lvl = ppoolers.assign_levels(torch.from_numpy(rois), 2, 5)
    np.testing.assert_array_equal(got_lvl.numpy(), want_lvl)
    assert set(np.unique(want_lvl)) == {0, 1, 2, 3}
    feats = [np.concatenate([f, -f]) for f in _pyramid(7, 8)]  # 2 images
    want = jpoolers.pool_rois([jnp.asarray(f) for f in feats],
                              jnp.asarray(rois), **POOLER)
    for impl in ("plain", "cuda"):
        got = ppoolers.pool_rois([nhwc_to_torch(f) for f in feats],
                                 torch.from_numpy(rois), **POOLER, impl=impl)
        assert got.shape == (2, 60, 8, 7, 7)
        np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


def _levels_case(seed):
    """Two images whose ROIs fall on P2, P3 and P5 and none on P4, the maps
    the JAX pooler reads and its own level assignment."""
    rois = _rois(seed, 2, 40)
    lvl = np.asarray(jpoolers.assign_levels(jnp.asarray(rois), 2, 5))
    keep = (lvl != 2).all(axis=0)                  # P4 empty in both images
    rois = np.ascontiguousarray(rois[:, keep])
    feats = [np.concatenate([f, 0.5 * f[..., ::-1]]) for f in _pyramid(seed, 8)]
    return feats, rois


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_levels_matches_jax_pool_rois(sampling_ratio):
    """The multi-level ROIAlign's plain version (every level, then a mask)
    and the kernel wrapper's CPU branch against JAX's pool_rois, with a
    level that gets no ROI; a level outside the maps gives zeros."""
    feats, rois = _levels_case(12)
    kw = dict(POOLER, sampling_ratio=sampling_ratio)
    want = np.asarray(jpoolers.pool_rois([jnp.asarray(f) for f in feats],
                                         jnp.asarray(rois), **kw))
    levels = ppoolers.assign_levels(torch.from_numpy(rois), 2, 5)
    assert set(levels.unique().tolist()) == {0, 1, 3}
    maps = [nhwc_to_torch(f) for f in feats[:4]]
    for fn in (proi.roi_align_levels, roi_align_cuda.roi_align_levels,
               roi_align_cuda.roi_align_levels_forward):
        got = fn(maps, torch.from_numpy(rois), levels, scales=SCALES,
                 output_size=7, sampling_ratio=sampling_ratio, max_samples=8)
        np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
    off = levels.clone()
    off[0, :5] = 4
    got = proi.roi_align_levels(maps, torch.from_numpy(rois), off,
                                scales=SCALES, output_size=7,
                                sampling_ratio=sampling_ratio)
    assert not got[0, :5].any()


def test_roi_align_levels_gradient_matches_jax():
    """d maps of the level-aware autograd route (its CPU branch: autograd of
    the plain form) against jax.grad of JAX's pool_rois."""
    feats, rois = _levels_case(13)
    g = np.random.RandomState(14).randn(2, rois.shape[1], 7, 7, 8).astype(
        np.float32)
    want = jax.grad(lambda fs: jnp.sum(jpoolers.pool_rois(
        fs, jnp.asarray(rois), **POOLER) * g))(
            [jnp.asarray(f) for f in feats[:4]])
    maps = [nhwc_to_torch(f).requires_grad_() for f in feats[:4]]
    levels = ppoolers.assign_levels(torch.from_numpy(rois), 2, 5)
    out = roi_align_cuda.roi_align_levels(maps, torch.from_numpy(rois),
                                          levels, **POOLER)
    (out.permute(0, 1, 3, 4, 2) * torch.from_numpy(g)).sum().backward()
    for m, w in zip(maps, want):
        np.testing.assert_allclose(torch_to_nhwc(m.grad), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    assert not maps[2].grad.any()                  # P4 pooled no ROI


def test_fpn_mlp_head_and_predictor_match_jax():
    """fc6 reads the pooled map in (C, H, W) order on the port's side and
    (H, W, C) on JAX's: the bridge permutes its kernel's input rows."""
    feats = _pyramid(8, 16)
    rois = _rois(9, 1, 30)
    jext = jbox.FPN2MLPFeatureExtractor(pooler=POOLER, mlp_dim=32)
    jpred = jbox.FPNPredictor(num_classes=9)
    jf = [jnp.asarray(f) for f in feats]
    ext_shapes = jax.eval_shape(
        lambda: jext.init(jax.random.PRNGKey(0), jf, jnp.asarray(rois)))
    ext_vars = random_variables(ext_shapes, seed=10)
    x = jext.apply(ext_vars, jf, jnp.asarray(rois))
    pred_shapes = jax.eval_shape(
        lambda: jpred.init(jax.random.PRNGKey(0), x))
    pred_vars = random_variables(pred_shapes, seed=11)
    want_logits, want_deltas = jpred.apply(pred_vars, x)

    ext = pbox.FPN2MLPFeatureExtractor(POOLER, 16, 32)
    state = jax_state_dict({"params": {"feature_extractor":
                                       ext_vars["params"]}},
                           fc6_chw=(16, 7, 7))
    ext.load_state_dict({k[len("roi_heads.box.feature_extractor."):]: v
                         for k, v in state.items()}, strict=True)
    pred = pbox.FPNPredictor(32, 9)
    pred.load_state_dict(module_state(pred_vars, "predictor",
                                      "roi_heads.box.predictor."),
                         strict=True)
    with torch.no_grad():
        got_x = ext([nhwc_to_torch(f) for f in feats],
                    torch.from_numpy(rois), impl="plain")
        got_logits, got_deltas = pred(got_x)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_deltas.numpy(), np.asarray(want_deltas),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="pooled"):
        jax_state_dict({"params": {"feature_extractor": ext_vars["params"]}})
