"""The flagship's triplet-DA train step in bfloat16, as a whole: one step
of the narrowed flagship (aligned and not) against the JAX package's
bfloat16 step on the same numpy weights and batches, and a census of what
each layer is fed. The FPN-DCN model's forward and step are in
tests/test_torch_bf16_dcn.py.

Configs, budgets and draws as tests/test_torch_train.py,
tests/test_torch_slice_dcn.py and tests/test_torch_train_fpn.py (every
candidate sampled, dropout off, ``TPU.APPROX_TOPK`` off), with
``TPU.COMPUTE_DTYPE "bfloat16"`` on both sides.

Selections. In the flagship's step no selection flips. In the FPN-DCN
model the RPN logits agree to a few bfloat16 ulps, and with random weights
many anchors score within an ulp of each other, so the port's own top-k and
NMS keep other boxes than JAX's (a large share of the eval forward's
proposals, a few of the train step's): those tests take JAX's proposals
(``JaxProposals``), as the float32 harness takes JAX's random draws, and
hold the port's selection itself to JAX's on JAX's RPN outputs.

Tolerances. Modules and stages: in bfloat16 ulps of the reference's largest
magnitude (``bf16_ulp``: 2 ** (floor(log2 m) - 7) at magnitude m), stated
at each check. Whole steps: bfloat16 rounding through dozens of layers
moves a step's gradients by tens of ulps in JAX itself (JAX's bfloat16
against its float32 step on the same weights, most in the DA instance
head's cancelling sums and the FPN-DCN body), and the port's bfloat16
step lands about as far from JAX's: so each loss, DAState field and gradient leaf is held within
twice JAX's own bfloat16-to-float32 distance, plus one bfloat16 ulp
(``_assert_step``). A port that stayed in float32 is caught by
tests/test_torch_bf16.py::test_port_really_rounds_in_bf16 and the
censuses.
"""

import pytest
import torch

from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu_torch.layers import Conv2d, Linear
from tests.test_torch_train import (_cfgs, _jax_batches, _jax_variables,
                                    _port_batches, _port_model)
from tests.torch_harness import bf16_ulp, jax_step_one, port_step_one

BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set_dtype(dtype, *cfgs):
    for cfg in cfgs:
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfg.TPU.APPROX_TOPK = False
    return cfgs


def _assert_step(got, want, want_f32):
    """One step against JAX's bfloat16 step, relative to JAX's own float32
    step on the same weights (``want_f32``): each loss and DAState field
    within one bfloat16 ulp of its value or twice JAX's own
    bfloat16-to-float32 distance, whichever is larger; each gradient leaf
    within twice JAX's bfloat16-to-float32 distance of that leaf plus one
    bfloat16 ulp of its size, in L2 norm."""
    for got_d, want_d, f32_d in zip(got[::2], want[::2], want_f32[::2]):
        assert set(got_d) == set(want_d)
        for k, w in want_d.items():
            tol = max(bf16_ulp(abs(w)), 2 * abs(f32_d[k] - w))
            assert abs(got_d[k] - w) <= tol, (k, got_d[k], w, f32_d[k])
    grads, want_g, f32_g = got[1], want[1], want_f32[1]
    assert set(grads) <= set(want_g)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        w = want_g[name]
        err = float((g - w).norm())
        tol = 2 * float((f32_g[name] - w).norm()) + 2.0 ** -8 * float(
            w.norm())
        assert err <= tol, (name, err, tol)


@pytest.fixture(scope="module", params=[False, True],
                ids=["triplet", "aligned"])
def flagship_step(request):
    """The narrowed flagship's step (``test_torch_train._cfgs``, the shared
    positive pool, three different images): JAX in bfloat16 and float32,
    the port in bfloat16, on one set of numpy variables."""
    aligned = request.param
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, pcfg = _set_dtype(dtype, *_cfgs(True))
        jmodel = j_build(jcfg)
        jargs = _jax_batches(jcfg, copy_positive=False)
        variables = _jax_variables(jcfg, jmodel, jargs)
        out[dtype] = jax_step_one(jcfg, jmodel, variables, jargs, aligned,
                                  with_state=True)
    model, state = _port_model(pcfg, variables)
    pargs = _port_batches(pcfg, copy_positive=False)
    got = port_step_one(model, state, pargs, aligned, with_state=True)
    return dict(aligned=aligned, got=got, want=out["bfloat16"],
                want_f32=out["float32"], model=model, state=state,
                args=pargs)


def test_triplet_step_bf16_matches_jax(flagship_step):
    """Losses, the new DAState and every trainable gradient of one step,
    aligned or not; the parameters and their gradients stay float32."""
    got, want = flagship_step["got"], flagship_step["want"]
    expected = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                "loss_box_reg", "loss_da_image", "loss_da_instance",
                "loss_da_consistency", "triplet_loss_image"}
    if flagship_step["aligned"]:
        expected.add("triplet_loss_instance")
    assert set(want[0]) == expected
    _assert_step(got, want, flagship_step["want_f32"])
    model = flagship_step["model"]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_train_step_census(flagship_step):
    """A census of forward pre-hooks over the step: every convolution and
    linear layer, the DA heads' included, is fed bfloat16, and the total
    loss is float32."""
    model, state = flagship_step["model"], flagship_step["state"]
    args, aligned = flagship_step["args"], flagship_step["aligned"]
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: seen.setdefault(name, set()).add(a[0].dtype))
        for name, m in model.named_modules()
        if isinstance(m, (Conv2d, Linear))]
    losses, _ = model.train_forward(args[0], args[1], state.da_state,
                                    *args[2:], aligned=aligned,
                                    deterministic=True,
                                    generator=state.generator)
    for h in hooks:
        h.remove()
    assert len(seen) == sum(isinstance(m, (Conv2d, Linear))
                            for m in model.modules())
    assert all(d == {BF16} for d in seen.values()), {
        n: d for n, d in seen.items() if d != {BF16}}
    assert all(v.dtype == torch.float32 for v in losses.values())
