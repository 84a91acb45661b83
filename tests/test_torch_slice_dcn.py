"""The whole eval forward of the X-101-32x8d-FPN-DCN triplet-DA YAML: the
JAX package's GeneralizedRCNN with numpy variables against the port's
build_detection_model + load_jax_variables, on the same batch of 2 images,
in both DCN gather modes ("four", the default, and "quad").

Config: the YAML at canvas 64x96, depth 101 and its 30 deformable convs
kept, widths narrowed (stem 8, 4 groups x 2, res2 16, FPN 16, MLP head
32), RPN 64 -> 32 a level and 48 across levels, float32, and
TPU.APPROX_TOPK off (``approx_max_k`` is TPU-only; the port's top-k is
exact). The numpy variables draw every conv kernel (std 1/sqrt(fan_in)),
``conv_offset`` included, so the deformable samples move off the grid, by
about a pixel with its kernels scaled by 0.1. The RPN score layer is scaled
by 30, as in tests/test_torch_slice.py, so that objectness sorts apart by
far more than float32 noise; the FPN predictor's class logits are already
spread (median |logit| ~7) and stay as drawn. The two box-delta layers are
scaled down (RPN 0.03, predictor 0.1) towards the JAX package's own init
(normal 0.01 and 0.001).

Why the scales: this 101-layer random network is sensitive. Offsets of
~10 px (conv_offset unscaled) amplify float32 rounding through res4's 23
deformable layers to 1e-5 of the features (5e-7 at ~1 px, as without DCN);
large box deltas turn that into proposal shifts that re-sample ROIAlign;
and class logits of ~250 (x 30) put 1e-4 of rounding into the logits.

Tolerances, as in tests/test_torch_slice.py: detection validity, labels and
order exactly; boxes atol 1e-3 (pixels); scores atol 1e-5 (probabilities).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu_torch import kernels
from da_detect_tpu_torch.entry import DCN_YAML, dcn_cfg, make_batch, \
    prepare_model
from da_detect_tpu_torch.layers import DeformConv2d
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.torch_harness import random_variables, torch_to_nhwc

SCALES = {"rpn_head/cls_logits/kernel": 30.0,
          "rpn_head/bbox_pred/kernel": 0.03,
          "predictor/bbox_pred/kernel": 0.1,
          "conv_offset/kernel": 0.1}


def _narrow(cfg, gather_mode):
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.NUM_GROUPS, r.WIDTH_PER_GROUP = 8, 4, 2
    r.RES2_OUT_CHANNELS = 16
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
    cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 32
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOP_N_TEST = 32
    cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 48
    cfg.TPU.IMAGE_SHAPE = (64, 96)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.TPU.DCN_GATHER = gather_mode
    return cfg


def _cfgs(gather_mode):
    jcfg = j_get_cfg()
    jcfg.merge_from_file(DCN_YAML)
    return _narrow(jcfg, gather_mode), _narrow(dcn_cfg(), gather_mode)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    """One set of numpy variables (shared by both gather modes: the modes
    have the same parameters) and the JAX batch."""
    jcfg, _ = _cfgs("four")
    jbatch, _ = graft._batch(jcfg, 2, seed=0)
    shapes = jax.eval_shape(lambda: j_build(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jbatch))
    return random_variables(shapes, seed=1, scales=SCALES), jbatch


@pytest.mark.parametrize("gather_mode", ["four", "quad"])
def test_dcn_eval_forward_matches_jax(jax_side, gather_mode):
    variables, jbatch = jax_side
    jcfg, pcfg = _cfgs(gather_mode)
    want = jax.device_get(jax.jit(j_build(jcfg).apply)(variables, jbatch))

    model = build_detection_model(pcfg)
    dcn = [m for m in model.modules() if isinstance(m, DeformConv2d)]
    assert len(dcn) == 30 and all(m.gather_mode == gather_mode for m in dcn)
    load_jax_variables(model, variables)
    assert all(bool(m.conv_offset.weight.any()) for m in dcn)
    model = prepare_model(model, torch.device("cpu"))
    batch, _ = make_batch(pcfg, 2, seed=0)
    np.testing.assert_array_equal(torch_to_nhwc(batch.images),
                                  np.asarray(jbatch.images))
    assert model.default_impl() == "plain"
    got = model(batch)

    valid = np.asarray(want.valid)
    assert valid.sum(axis=1).min() >= 8
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)

    # impl="cuda" on CPU tensors runs the kernel wrappers' plain branches
    # and launches nothing
    before = dict(kernels.LAUNCHES)
    via_wrappers = model(batch, impl="cuda")
    assert dict(kernels.LAUNCHES) == before
    for a, b in zip(via_wrappers, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dcn_training_is_refused():
    _, pcfg = _cfgs("four")
    model = build_detection_model(pcfg)
    batch, targets = make_batch(pcfg, 1, seed=0)
    with pytest.raises(NotImplementedError, match="FPN/DCN training"):
        model.train_forward(batch, targets, None)
