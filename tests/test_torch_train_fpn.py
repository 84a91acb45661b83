"""One triplet-DA training step of the FPN models against the JAX package's,
on the same numpy weights and batches: the X-101-32x8d-FPN-DCN YAML in both
DCN gather modes, and the R-50-FPN triplet YAML. Then ``load_jax_train_state``
on the FPN-DCN model's JAX ``TrainState``.

Config: each YAML at canvas 64x96, narrowed as tests/test_torch_slice_dcn.py
narrows it (``tests.torch_harness.fpn_train_cfgs``: stem 8, res2 16, FPN 16,
MLP head 32; the DCN body at 4 groups x 2, the R-50 body width 8), float32,
``TPU.APPROX_TOPK`` off, and the YAMLs' DA settings (image triplet,
AdvGRL, instance triplet weight 0, no alignment). Training budgets: 64 -> 32
proposals a level and 48 across the batch, 8 GT boxes, RPN batch 4096 and
ROI batch 128 at positive fraction 0.5, above every candidate pool (1536
anchors; 48 + 8 proposals), so both samplers take every candidate whatever
their random priorities, and ``deterministic=True`` turns the DA dropout
off: torch cannot replay JAX's random draws. The numpy variables draw every conv
kernel, ``conv_offset`` included (x 0.1: samples move about a pixel off the
grid, so the offsets' gradients are live), with the score and box-delta
layers scaled as tests/test_torch_slice_dcn.py scales them.

Depth: the DCN step runs the YAML's body at depth 50 ("R-50-FPN" with its
32x8d grouping narrowed to 4x2 and its STAGE_WITH_DCN (False, True, True,
True): 13 deformable convs), because JAX's gradient of the 101-layer body
takes over a minute to compile on the CPU; the 101-layer forward is held
against JAX in tests/test_torch_slice_dcn.py, and the port's blocks are one
module whatever the depth. JAX's two gather modes compute one function, so
its gradient is taken once, in the YAML's "four" mode, and each port mode
is held against it.

Tolerances, as tests/test_torch_train.py: losses rtol 1e-4; every trainable
gradient within 1e-3 of its leaf's largest |g|, with a floor of 1e-6 of the
model's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.engine.trainer import TrainState as JTrainState
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.solver.optim import make_optimizer as j_make_optimizer
from da_detect_tpu_torch import entry, kernels
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.layers import DeformConv2d
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.utils.weights import (load_jax_train_state,
                                               load_jax_variables)
from tests.torch_harness import (assert_grads_match, assert_losses_match,
                                 fpn_train_cfgs, jax_step_one,
                                 jax_train_variables, port_step_one,
                                 triplet_batches)

R50_FPN_YAML = entry.DCN_YAML.replace(
    "X_101_32x8d_FPN_dcn", "R_50_FPN")
LOSSES = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg", "loss_da_image", "loss_da_instance",
          "triplet_loss_image"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_model(pcfg, variables):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = entry.prepare_model(model, torch.device("cpu"))
    return model, create_train_state(pcfg, model, 0, "cosine")


@pytest.fixture(scope="module")
def dcn_reference():
    """One set of numpy variables for both gather modes (they have the same
    parameters), the batches, and JAX's step on them."""
    jcfg, pcfg = fpn_train_cfgs(entry.DCN_YAML, depth50=True)
    jmodel = j_build(jcfg)
    jargs, pargs = triplet_batches(jcfg, pcfg)
    variables = jax_train_variables(jmodel, jargs)
    want = jax_step_one(jcfg, jmodel, variables, jargs, aligned=False)
    return variables, pargs, want


@pytest.mark.parametrize("gather_mode", ["four", "quad"])
def test_dcn_step_matches_jax(dcn_reference, gather_mode):
    """The FPN-DCN triplet step, narrowed: losses and every trainable
    gradient, the deformable convs' offset predictors included;
    impl="cuda" on CPU tensors (the wrappers' plain branches, no launch)
    gives the plain step bit for bit."""
    variables, pargs, (want_losses, want_grads) = dcn_reference
    _, pcfg = fpn_train_cfgs(entry.DCN_YAML, gather_mode, depth50=True)
    model, state = _port_model(pcfg, variables)
    dcn = [m for m in model.modules() if isinstance(m, DeformConv2d)]
    assert len(dcn) == 13 and all(m.gather_mode == gather_mode for m in dcn)
    losses, grads = port_step_one(model, state, pargs, aligned=False)
    assert set(want_losses) == LOSSES
    assert want_losses["triplet_loss_image"] > 0
    assert_losses_match(losses, want_losses)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert set(grads) == set(want_grads) - frozen
    assert {n.split(".")[2] for n in frozen} == {"stem", "layer1"}
    offsets = [n for n in grads if "conv_offset" in n]
    assert len(offsets) == 26 and all(grads[n].abs().max() > 0
                                      for n in offsets)
    assert_grads_match(grads, want_grads)

    before = dict(kernels.LAUNCHES)
    via_wrappers = port_step_one(model, state, pargs, aligned=False,
                                 impl="cuda")
    assert dict(kernels.LAUNCHES) == before
    assert via_wrappers[0] == losses
    for name, g in grads.items():
        torch.testing.assert_close(via_wrappers[1][name], g, rtol=0, atol=0,
                                   msg=name)


def test_r50_fpn_step_matches_jax():
    """The R-50-FPN triplet YAML, narrowed: losses and gradients."""
    jcfg, pcfg = fpn_train_cfgs(R50_FPN_YAML)
    jmodel = j_build(jcfg)
    jargs, pargs = triplet_batches(jcfg, pcfg)
    variables = jax_train_variables(jmodel, jargs)
    want_losses, want_grads = jax_step_one(jcfg, jmodel, variables, jargs,
                                           aligned=False)
    model, state = _port_model(pcfg, variables)
    assert not any(isinstance(m, DeformConv2d) for m in model.modules())
    losses, grads = port_step_one(model, state, pargs, aligned=False)
    assert set(want_losses) == LOSSES
    assert_losses_match(losses, want_losses)
    assert set(grads) == {n for n, p in model.named_parameters()
                          if p.requires_grad}
    assert_grads_match(grads, want_grads)


def test_load_jax_train_state_fpn_dcn(dcn_reference):
    """A JAX TrainState of the FPN-DCN model into the port's: each SGD
    momentum buffer twice its parameter (so fc6's (H, W, C) -> (C, H, W)
    reorder and the conv_offset leaves are checked against the weights'
    own mapping), the DAState scalars and the step."""
    variables, _, _ = dcn_reference
    jcfg, pcfg = fpn_train_cfgs(entry.DCN_YAML, depth50=True)
    tx, _ = j_make_optimizer(jcfg, variables["params"], "cosine")
    opt_state = tx.init(variables["params"])
    momentum = jax.tree_util.tree_map(lambda p: 2.0 * np.asarray(p),
                                      variables["params"])
    jstate = JTrainState(
        step=jnp.asarray(7, jnp.int32), params=variables["params"],
        frozen=variables["frozen"],
        opt_state=(opt_state[0], type(opt_state[1])(momentum=momentum)),
        da_state=JDAState.create(0.25, 1.5), rng=jax.random.PRNGKey(0))
    model = entry.prepare_model(build_detection_model(pcfg),
                                torch.device("cpu"))
    state = create_train_state(pcfg, model, 0, "cosine")
    load_jax_train_state(state, jstate)
    assert state.step == 7
    assert float(state.da_state.margin_img) == 0.25
    assert float(state.da_state.margin_ins) == 1.5
    buffers = state.optimizer.momentum_buffers()
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert set(buffers) == set(trainable)
    assert sum("conv_offset" in n for n in buffers) == 26
    assert "roi_heads.box.feature_extractor.fc6.weight" in buffers
    for name, p in trainable.items():
        torch.testing.assert_close(buffers[name], 2.0 * p.detach(), rtol=0,
                                   atol=0, msg=name)
