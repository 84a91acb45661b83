"""The port's triplet-DA training step against the JAX package's, on the same
numpy weights and batches.

Config: ``tiny_cfgs()`` (the flagship narrowed for the CPU) with 64 -> 16
training proposals, 8 GT boxes, RPN batch 1024 and ROI batch 64 at positive
fraction 0.5: budgets above every candidate pool (360 anchors, 16 + 8
proposals), so both samplers take every candidate whatever their random
priorities, and ``deterministic=True`` turns the DA dropout off. The RPN and
predictor score layers are scaled x 30 in both models, so that proposal
order is decided by more than float32 noise.

Tolerances: one step's loss dict rtol 1e-4; every trainable gradient within
1e-3 of its leaf's largest |g| (float32 convolutions and reductions summed
in another order, through a res5 head and GRLs), with an absolute floor of
1e-6 of the largest gradient of the whole model for leaves whose terms cancel
to near zero; the image-margin trajectory exactly [-0.5, -0.499, -0.498]
(atol 1e-6); after 3 steps each parameter's change within 1e-2 of its
leaf's largest change, plus one float32 ulp of the weights.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.engine.trainer import TrainState as JTrainState
from da_detect_tpu.engine.trainer import make_train_step as j_make_train_step
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.solver.optim import make_optimizer as j_make_optimizer
from da_detect_tpu_torch import entry
from da_detect_tpu_torch.engine.trainer import (create_train_state, do_train,
                                                make_train_step)
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.utils.checkpoint import Checkpointer
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_train_state,
                                               load_jax_variables)
from tests.torch_harness import (assert_grads_match, assert_losses_match,
                                 jax_step_one, port_step_one,
                                 random_variables, tiny_cfgs)

SCORE_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
                "predictor/cls_score/kernel": 30.0}
MARGINS = [-0.5, -0.499, -0.498]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(share_positive_pool=True):
    jcfg, pcfg = tiny_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list([
            "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
            "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
            "TPU.MAX_GT_BOXES", 8,
            "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 1024,
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
            "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.5,
            "MODEL.DA_HEADS.TRIPLET_MAX_MARGIN", 3.0,
            "MODEL.DA_HEADS.TRIPLET_MARGIN_IMG", -0.5,
            "TPU.SHARE_POSITIVE_POOL", share_positive_pool])
    return jcfg, pcfg


def _jax_batches(jcfg, copy_positive):
    """(source, positive, negative) with the source's targets: the positive
    a pixel copy of the source and the negative the source + 200 (the
    margin trajectory), or three different images (gradients through every
    triplet term)."""
    b_s, t_s = graft._batch(jcfg, 1, seed=0)
    if copy_positive:
        b_p = b_s.replace(is_source=jnp.zeros_like(b_s.is_source))
        b_n = b_p.replace(images=b_s.images + 200.0)
        return b_s, t_s, b_p, t_s, b_n, t_s
    b_p, t_p = graft._batch(jcfg, 1, seed=1, is_source=False)
    b_n, t_n = graft._batch(jcfg, 1, seed=2, is_source=False)
    return b_s, t_s, b_p, t_p, b_n, t_n


def _port_batches(pcfg, copy_positive):
    if copy_positive:
        return entry.triplet_batches(pcfg, 1, seed=0)
    b_s, t_s = entry.make_batch(pcfg, 1, seed=0)
    b_p, t_p = entry.make_batch(pcfg, 1, seed=1, is_source=False)
    b_n, t_n = entry.make_batch(pcfg, 1, seed=2, is_source=False)
    return b_s, t_s, b_p, t_p, b_n, t_n


def _jax_variables(jcfg, jmodel, args):
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, args[0], args[1],
        JDAState.create(), *args[2:], aligned=True,
        method=jmodel.train_forward))
    return random_variables(shapes, seed=1, scales=SCORE_SCALES)


def _port_model(pcfg, variables, schedule_kind="cosine"):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = entry.prepare_model(model, torch.device("cpu"))
    return model, create_train_state(pcfg, model, 0, schedule_kind)


@pytest.fixture(scope="module", params=[
    (False, True), (True, True), (True, False)],
    ids=["triplet", "aligned_shared_pool", "aligned_own_pool"])
def step_one(request):
    aligned, share = request.param
    jcfg, pcfg = _cfgs(share)
    jmodel = j_build(jcfg)
    jargs = _jax_batches(jcfg, copy_positive=False)
    v = _jax_variables(jcfg, jmodel, jargs)
    want = jax_step_one(jcfg, jmodel, v, jargs, aligned)
    model, state = _port_model(pcfg, v)
    pargs = _port_batches(pcfg, copy_positive=False)
    return aligned, want, model, state, pargs


def test_step_one_losses_match_jax(step_one):
    aligned, (want, _), model, state, args = step_one
    got, _ = port_step_one(model, state, args, aligned)
    expected = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                "loss_box_reg", "loss_da_image", "loss_da_instance",
                "loss_da_consistency", "triplet_loss_image"}
    if aligned:
        expected.add("triplet_loss_instance")
    assert set(want) == expected
    assert_losses_match(got, want)
    assert want["triplet_loss_image"] > 0  # its gradients are live


def test_step_one_gradients_match_jax(step_one):
    aligned, (_, want), model, state, args = step_one
    _, got = port_step_one(model, state, args, aligned)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert set(got) == set(want) - frozen
    assert {n.split(".")[2] for n in frozen} == {"stem", "layer1"}
    assert_grads_match(got, want)


def test_kernel_route_on_cpu_tensors_matches_plain(step_one):
    """impl="cuda" on CPU tensors: the NMS and ROIAlign wrappers take their
    plain branches and give the plain step bit for bit, losses and
    gradients (autograd differentiates the same plain ROIAlign)."""
    aligned, _, model, state, args = step_one
    plain = port_step_one(model, state, args, aligned, impl="plain")
    kernel = port_step_one(model, state, args, aligned, impl="cuda")
    assert kernel[0] == plain[0]
    for name, g in plain[1].items():
        torch.testing.assert_close(kernel[1][name], g, rtol=0, atol=0,
                                   msg=name)


def test_three_step_trajectory_matches_jax():
    """The port's make_train_step against the JAX package's, 3 steps of the
    aligned triplet with the cosine schedule from one TrainState carried
    over by load_jax_train_state: the positive a pixel copy of the source,
    so the image hinge is exactly 0 and the margin grows by lr from the
    second step on."""
    jcfg, pcfg = _cfgs()
    jmodel = j_build(jcfg)
    jargs = _jax_batches(jcfg, copy_positive=True)
    v = _jax_variables(jcfg, jmodel, jargs)
    tx, _ = j_make_optimizer(jcfg, v["params"], "cosine")
    jstate = JTrainState(
        step=jnp.zeros([], jnp.int32), params=v["params"], frozen=v["frozen"],
        opt_state=tx.init(v["params"]),
        da_state=JDAState.create(jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG,
                                 jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_INS),
        rng=jax.random.PRNGKey(0))
    jstep = j_make_train_step(jmodel, tx, aligned=True, donate=False,
                              deterministic=True)
    want_margins = []
    st = jstate
    for _ in range(3):
        st, _ = jstep(st, *jargs)
        want_margins.append(float(st.da_state.margin_img))
    want = jax_state_dict({"params": jax.device_get(st.params)})

    model, state = _port_model(pcfg, v)
    load_jax_train_state(state, jstate)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, state.optimizer, aligned=True,
                           deterministic=True)
    args = _port_batches(pcfg, copy_positive=True)
    margins = []
    for _ in range(3):
        state, metrics = step(state, *args)
        margins.append(float(state.da_state.margin_img))
    assert state.step == 3
    assert float(metrics["triplet_loss_image"]) == 0.0
    np.testing.assert_allclose(margins, MARGINS, rtol=0, atol=1e-6)
    np.testing.assert_allclose(want_margins, MARGINS, rtol=0, atol=1e-6)
    moved = 0
    for name, p in model.named_parameters():
        d_got = p.detach() - init[name]
        d_want = want[name] - init[name]
        scale = float(d_want.abs().max())
        ulp = 1.2e-7 * float(init[name].abs().max())
        err = float((d_got - d_want).abs().max())
        assert err <= 1e-2 * scale + ulp, (
            f"{name}: change differs by {err:.3e}, largest change "
            f"{scale:.3e}")
        moved += scale > ulp
    assert moved > 20


def _train_setup():
    _, pcfg = _cfgs()
    pcfg.SOLVER.MAX_ITER = 10
    step, (state, args) = entry.train_entry(device="cpu", cfg=pcfg,
                                            aligned=True)
    return pcfg, state, args


def test_do_train_checkpoints_and_resumes(tmp_path):
    pcfg, state, args = _train_setup()
    ckpt = Checkpointer(str(tmp_path))
    state = do_train(state, itertools.repeat(args), max_iter=3,
                     checkpointer=ckpt, checkpoint_period=2, log_period=1,
                     aligned=True)
    assert state.step == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "last_checkpoint", "model_0000002.pth", "model_0000003.pth"]
    _, fresh, _ = _train_setup()
    fresh, start = ckpt.resume(fresh)
    assert start == fresh.step == 3
    for (name, a), b in zip(state.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    for f in dataclasses.fields(state.da_state):
        torch.testing.assert_close(getattr(fresh.da_state, f.name),
                                   getattr(state.da_state, f.name))
    momentum = state.optimizer.momentum_buffers()
    for name, buf in fresh.optimizer.momentum_buffers().items():
        torch.testing.assert_close(buf, momentum[name], rtol=0, atol=0)
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())


def test_do_train_stops_on_nonfinite_loss(tmp_path):
    """A loss that turns non-finite after the first (logged) iteration
    raises at the next checkpoint boundary, and is never checkpointed."""
    _, state, args = _train_setup()

    def batches():
        yield args
        with torch.no_grad():
            state.model.roi_heads["box"]["predictor"].cls_score.bias.fill_(
                float("nan"))
        yield from itertools.repeat(args)

    with pytest.raises(FloatingPointError, match="non-finite loss at 1"):
        do_train(state, batches(), max_iter=4,
                 checkpointer=Checkpointer(str(tmp_path)),
                 checkpoint_period=2, log_period=3)
    assert not any(tmp_path.iterdir())
