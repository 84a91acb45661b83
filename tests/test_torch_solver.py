"""The port's solver against the JAX package's: the learning-rate schedules
(warmup-multistep and warmup-cosine, each with the bias group's own
schedule) and one Detectron-SGD update of every parameter kind, started from
a JAX TrainState carried over by ``load_jax_train_state``.

Tolerances: learning rates rtol 1e-6 (the JAX schedules compute in float32,
the port's in Python floats); updated parameters rtol 1e-6 / atol 1e-7 (the
same float32 update arithmetic, with a learning rate that is a float32 in JAX
and a double here: about one float32 ulp of the weights); momentum rtol 1e-6
/ atol 1e-7 (XLA may fuse ``momentum * m + d`` into one FMA, which rounds
once where PyTorch rounds twice: one ulp of the O(1) terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.engine.trainer import TrainState as JTrainState
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.solver.optim import make_optimizer as j_make_optimizer
from da_detect_tpu.solver.schedules import make_lr_scheduler
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.solver.optim import make_optimizer
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_train_state)
from tests.torch_harness import random_variables, tiny_cfgs

SOLVER = ["SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 4,
          "SOLVER.WARMUP_FACTOR", 0.25, "SOLVER.STEPS", (6, 9),
          "SOLVER.MAX_ITER", 12, "SOLVER.WARMUP_LR", 0.002,
          "SOLVER.LR_MIN", 0.0005, "SOLVER.BIAS_LR_FACTOR", 2,
          "SOLVER.WEIGHT_DECAY_BIAS", 0.001]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(method="linear"):
    jcfg, pcfg = tiny_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list(SOLVER + ["SOLVER.WARMUP_METHOD", method])
    return jcfg, pcfg


@pytest.mark.parametrize("kind,method", [("multistep", "linear"),
                                         ("multistep", "constant"),
                                         ("cosine", "linear")])
def test_schedules_match_jax(kind, method):
    """Warmup, the decay steps or the cosine, and the bias group: a scaled
    base with the shared warmup floor and minimum (not a factor times the
    weight schedule)."""
    jcfg, pcfg = _cfgs(method)
    opt = make_optimizer(pcfg, build_detection_model(pcfg), kind)
    j_w = make_lr_scheduler(jcfg, kind)
    j_b = make_lr_scheduler(jcfg, kind, base_scale=2.0)
    for it in (0, 1, 3, 4, 5, 6, 8, 9, 11, 12):
        lr_w, lr_b = opt.lrs(it)
        np.testing.assert_allclose(lr_w, float(j_w(it)), rtol=1e-6)
        np.testing.assert_allclose(lr_b, float(j_b(it)), rtol=1e-6)
    if kind == "cosine":
        # at iteration 0 the bias group starts from the shared floor
        assert opt.lrs(0) == (pytest.approx(0.002), pytest.approx(0.002))


@pytest.fixture(scope="module")
def jax_variables():
    jcfg, _ = tiny_cfgs()
    model = j_build(jcfg)
    b, t = graft._batch(jcfg, 1)
    da = JDAState.create()
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, b, t, da, b, t, b, t,
        method=model.train_forward))
    return random_variables(shapes, seed=3)


@pytest.mark.parametrize("kind,step", [("cosine", 1), ("cosine", 7),
                                       ("multistep", 6)])
def test_one_sgd_update_matches_jax(jax_variables, kind, step):
    """From one JAX TrainState (random momentum, step mid-run) and one set of
    gradients: weights take lr and decay, biases 2x lr and their own decay,
    the frozen stem and res2 stay put, and the momentum of each matches."""
    jcfg, pcfg = _cfgs()
    v = jax_variables
    rng = np.random.RandomState(step)

    def rand_tree(scale):
        return jax.tree.map(
            lambda x: (scale * rng.randn(*x.shape)).astype(np.float32),
            v["params"])

    grads, momentum = rand_tree(1.0), rand_tree(0.1)
    tx, _ = j_make_optimizer(jcfg, v["params"], kind)
    jstate = JTrainState(
        step=jnp.int32(step), params=v["params"], frozen=v["frozen"],
        opt_state=(jnp.int32(step), tx.init(v["params"])[1]._replace(
            momentum=momentum)),
        da_state=JDAState.create(-0.5, 1.0), rng=jax.random.PRNGKey(0))
    updates, new_opt = tx.update(grads, jstate.opt_state, v["params"])
    want = jax_state_dict({"params": optax.apply_updates(v["params"],
                                                         updates)})
    want_m = jax_state_dict({"params": new_opt[1].momentum})

    model = build_detection_model(pcfg)
    state = create_train_state(pcfg, model, schedule_kind=kind)
    load_jax_train_state(state, jstate)
    assert state.step == step
    assert float(state.da_state.margin_img) == -0.5
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    port_grads = jax_state_dict({"params": grads})
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = port_grads[name].clone()
    state.optimizer.step(state.step)

    kinds = set()
    for name, p in model.named_parameters():
        if not p.requires_grad:
            kinds.add("frozen")
            torch.testing.assert_close(p.detach(), before[name], rtol=0,
                                       atol=0)
            continue
        kinds.add("bias" if name.endswith("bias") else "weight")
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(
            state.optimizer.momentum_buffers()[name].numpy(),
            want_m[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    assert kinds == {"frozen", "bias", "weight"}
