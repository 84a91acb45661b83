"""The whole eval forward: the JAX package's GeneralizedRCNN with numpy
variables against the port's build_detection_model + load_jax_variables, on
the same batch (make_batch draws what __graft_entry__._batch draws).

Config: the flagship model at canvas 64x96 with 64 -> 16 proposals,
narrowed to stem 16 / width 8 / res2 32, float32. The RPN and predictor
score layers are scaled up in the numpy variables of both models, so that
scores sort apart by far more than float32 noise.

Tolerances: detection validity, labels and order exactly; boxes atol 1e-3
(pixels); scores atol 1e-5 (probabilities). The backbones agree to ~1e-6
relative; box decoding scales that to well under 1e-3 pixels.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu_torch.entry import make_batch, prepare_model
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.torch_harness import random_variables, tiny_cfgs, torch_to_nhwc

SCORE_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
                "predictor/cls_score/kernel": 30.0}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("rpn_only", [False, True])
def test_eval_forward_matches_jax(rpn_only):
    jcfg, pcfg = tiny_cfgs()
    jcfg.MODEL.RPN_ONLY = pcfg.MODEL.RPN_ONLY = rpn_only
    jmodel = j_build(jcfg)
    jbatch, _ = graft._batch(jcfg, 2, seed=0)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch))
    variables = random_variables(shapes, seed=1, scales=SCORE_SCALES)
    want = jax.device_get(jax.jit(jmodel.apply)(variables, jbatch))

    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
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
    via_wrappers = model(batch, impl="cuda")
    for a, b in zip(via_wrappers, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
