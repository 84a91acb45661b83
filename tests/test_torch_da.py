"""The port's training ops and domain-adaptation heads against the JAX
package's, on the same numpy inputs and weights.

Tolerances: losses rtol 1e-5 / atol 1e-6 (the same float32 arithmetic in
another summation order); input and weight gradients of the DA module within
1e-4 of each leaf's largest |g| (a weight leaf whose terms cancel to ~1e-8,
such as conv2_da's bias summed over both domains, within 1e-8 absolute:
float32 rounding of O(1) terms); matcher matches, sampler masks and index
lists, AdvGRL weights and margins exactly. The sampler is handed JAX's own
uniform draws as its priorities, since PyTorch cannot reproduce JAX's
streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.models import da as jda
from da_detect_tpu.ops import grl as jgrl
from da_detect_tpu.ops import losses as jlosses
from da_detect_tpu.ops import matcher as jmatcher
from da_detect_tpu.ops import sampler as jsampler
from da_detect_tpu_torch.models import da as tda
from da_detect_tpu_torch.ops import grl as tgrl
from da_detect_tpu_torch.ops import losses as tlosses
from da_detect_tpu_torch.ops import matcher as tmatcher
from da_detect_tpu_torch.ops import sampler as tsampler
from tests.torch_harness import module_state, random_variables

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_to_leaf_max(got, want, rel=GRAD_REL, atol=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale + atol, (
        f"{what}: max |diff| {err:.3e} vs max |g| {scale:.3e}")


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_smooth_l1_and_bce(weighted, reduction):
    rng = np.random.RandomState(0)
    a, b = (rng.randn(6, 8).astype(np.float32) for _ in range(2))
    w = (rng.rand(6, 8) > 0.4).astype(np.float32) if weighted else None
    t = (rng.rand(6, 8) > 0.5).astype(np.float32)
    tw = None if w is None else torch.from_numpy(w)
    for jfn, tfn, args in (
            (jlosses.smooth_l1_loss, tlosses.smooth_l1_loss, (a, b)),
            (jlosses.bce_with_logits, tlosses.bce_with_logits, (3 * a, t))):
        want = jfn(*map(jnp.asarray, args), weights=w, reduction=reduction,
                   **({"beta": 1.0 / 9} if jfn is jlosses.smooth_l1_loss
                      else {}))
        got = tfn(*map(torch.from_numpy, args), weights=tw,
                  reduction=reduction,
                  **({"beta": 1.0 / 9} if tfn is tlosses.smooth_l1_loss
                     else {}))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_bce_weighted_mean_divides_by_weight_sum():
    """Not F.binary_cross_entropy_with_logits(weight=...), which divides by
    the element count; all-zero weights give 0, not NaN."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(10).astype(np.float32))
    t = torch.from_numpy((rng.rand(10) > 0.5).astype(np.float32))
    w = torch.zeros(10)
    w[:3] = 1.0
    got = tlosses.bce_with_logits(x, t, weights=w)
    per = tlosses.bce_with_logits(x, t, reduction="none")
    torch.testing.assert_close(got, per[:3].mean())
    assert float(tlosses.bce_with_logits(x, t, weights=torch.zeros(10))) == 0


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_cross_entropy(weighted):
    rng = np.random.RandomState(2)
    logits = (3 * rng.randn(12, 9)).astype(np.float32)
    labels = rng.randint(0, 9, 12)
    w = (rng.rand(12) > 0.3).astype(np.float32) if weighted else None
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), w)
    got = tlosses.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize("margin", [1.0, -0.5, 0.3])
def test_triplet_margin_loss_nchw_against_nhwc(margin):
    """The image triplet reduces W: NHWC axis 2 in JAX, NCHW's last axis
    here; eps sits inside |x - y + eps|."""
    rng = np.random.RandomState(3)
    a, p, n = (rng.randn(2, 5, 7, 4).astype(np.float32) for _ in range(3))
    p = a + 0.1 * p
    want = jlosses.triplet_margin_loss(*map(jnp.asarray, (a, p, n)),
                                       jnp.float32(margin), axis=2)
    got = tlosses.triplet_margin_loss(
        *(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (a, p, n)),
        torch.tensor(margin), dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


# ------------------------------------------------------------------ matcher

@pytest.mark.parametrize("low_quality", [False, True])
def test_matcher_matches_jax(low_quality):
    """Quantized IoUs (ties between GTs and between predictions), a padded
    GT column, a valid GT overlapping nothing, and an image with no valid
    GT."""
    rng = np.random.RandomState(4)
    iou = (np.round(rng.rand(3, 40, 6) * 10) / 10).astype(np.float32)
    iou[:, :, 2] = 0.0                       # overlaps nothing
    valid = np.ones((3, 6), bool)
    valid[0, 5] = False
    valid[2] = False
    want = jmatcher.match_proposals(jnp.asarray(iou), jnp.asarray(valid),
                                    0.7, 0.3, low_quality)
    got = tmatcher.match_proposals(torch.from_numpy(iou),
                                   torch.from_numpy(valid), 0.7, 0.3,
                                   low_quality)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[2] == -1).all()


# ------------------------------------------------------------------ GRL

@pytest.mark.parametrize("weight", [-0.1, 0.1, "tensor"])
def test_grl_gradient(weight):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4).astype(np.float32)
    g = rng.randn(3, 4).astype(np.float32)
    w = -2.75 if weight == "tensor" else weight
    _, vjp = jax.vjp(lambda y: jgrl.gradient_scalar(y, w), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.tensor(w, requires_grad=True) if weight == "tensor" else w
    out = tgrl.gradient_scalar(xt, wt)
    torch.testing.assert_close(out, xt, rtol=0, atol=0)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6)
    if weight == "tensor":
        assert wt.grad is None  # the weight takes no gradient


# ------------------------------------------------------------------ sampler

def _jax_priorities(key, shape):
    kp, kn = jax.random.split(key)
    return (jax.random.uniform(kp, shape), jax.random.uniform(kn, shape))


@pytest.mark.parametrize("batch,n,pos_rate,size,frac", [
    (1, 300, 0.3, 64, 0.25),     # positives capped
    (2, 500, 0.02, 64, 0.25),    # few positives: negatives fill
    (3, 40, 0.5, 128, 0.5),      # budget above the pool: all sampled
    (2, 2000, 0.1, 256, 0.5)])
def test_balanced_sample_with_jax_draws(batch, n, pos_rate, size, frac):
    rng = np.random.RandomState(n)
    u = rng.rand(batch, n)
    labels = np.where(u < pos_rate, rng.randint(1, 5, (batch, n)),
                      np.where(u < 0.8, 0, -1)).astype(np.int32)
    key = jax.random.PRNGKey(n)
    want_p, want_n = jsampler.balanced_sample(key, jnp.asarray(labels), size,
                                              frac)
    prio = tuple(torch.from_numpy(np.array(p))
                 for p in _jax_priorities(key, labels.shape))
    got_p, got_n = tsampler.balanced_sample(torch.from_numpy(labels), size,
                                            frac, priorities=prio)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    for b in range(batch):
        want = jsampler.selection_to_indices(want_p[b], want_n[b], size)
        got = tsampler.selection_to_indices(got_p[b], got_n[b], size)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sampler_cumulative_cap_on_tied_priorities():
    """Tied priorities at the threshold: the cumulative count keeps exactly
    ``count`` selected, the first ones in index order."""
    labels = torch.ones(1, 10, dtype=torch.int64)
    prio = torch.full((1, 10), 0.5)
    pos, neg = tsampler.balanced_sample(labels, 8, 0.5,
                                        priorities=(prio, prio))
    assert pos.tolist() == [[True] * 4 + [False] * 6]
    assert not neg.any()
    gen = torch.Generator().manual_seed(0)
    pos, _ = tsampler.balanced_sample(labels, 8, 0.5, generator=gen)
    assert int(pos.sum()) == 4


# ------------------------------------------------------------------ DA heads

def test_adv_grl_weights_and_margin_match_jax():
    losses = np.asarray([0.0, 1e-9, 0.01, 0.3, 0.62877, 0.62877065, 0.6288,
                         0.6752516, 0.68, 0.69937071, 0.7, 2.0], np.float32)
    for jfn, tfn in ((jda.adv_grl_weight, tda.adv_grl_weight),
                     (jda.adv_grl_weight_optimized,
                      tda.adv_grl_weight_optimized)):
        for v in losses:
            want = jfn(jnp.float32(v), 0.1, 0.1, 30.0)
            got = tfn(torch.tensor(v), 0.1, 0.1, 30.0)
            assert got.dim() == 0
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{tfn.__name__}({v})")
    for margin, last, max_margin in ((1.0, 0.0, 3.0), (1.0, 0.25, 3.0),
                                     (1.0, 0.0, 1.0), (3.0, 0.0, 3.0),
                                     (-0.5, 0.0, 3.0), (2.999, 0.0, 3.0)):
        want = jda._updated_margin(jnp.float32(margin), jnp.float32(last),
                                   0.001, max_margin)
        got = tda._updated_margin(torch.tensor(margin), torch.tensor(last),
                                  0.001, max_margin)
        assert float(got) == float(want), (margin, last, max_margin)


K, S, C_IMG, C_INS, H, W = 2, 6, 16, 32, 5, 7


def _da_inputs(seed, strong):
    """NHWC numpy inputs of the DA module: interleaved (s0, t0, s1, t1)
    image maps and instance features, the triplet sets and masks. With
    ``strong`` the domains differ in channel 0 (+1 source, -1 target)."""
    rng = np.random.RandomState(seed)
    img = rng.randn(2 * K, H, W, C_IMG).astype(np.float32)
    ins = rng.randn(2 * K, S, 7, 7, C_INS).astype(np.float32)
    is_source = np.arange(2 * K) % 2 == 0
    if strong:
        sign = np.where(is_source, 1.0, -1.0).astype(np.float32)
        img[..., 0] = sign[:, None, None]
        ins[..., 0] = sign[:, None, None, None]
    valid = rng.rand(2 * K, S) > 0.25
    dom = valid & is_source[:, None]
    ins_set = tuple(rng.randn(K, S, 7, 7, C_INS).astype(np.float32)
                    for _ in range(3))
    img_set = tuple(rng.randn(K, H, W, C_IMG).astype(np.float32)
                    for _ in range(3))
    return img, ins, dom, valid, ins_set, img_set, is_source


def _classifier_weights(v, k):
    """Heads that read channel 0 only: logit = k * x0 (image) and
    0.8 k * mean(x0) (instance: the consistency loss's |image - instance|
    stays off its kink at 0). k = 10 makes the domain classifiers win (low
    probe loss: the boosted AdvGRL branch), k = -0.1 makes them lose (above
    the optimized band: the damped branch)."""
    p = jax.tree.map(np.array, v["params"])
    img, ins = p["imghead"], p["inshead"]
    for layer in (img["conv1_da"], img["conv2_da"], ins["fc1_da"],
                  ins["fc2_da"], ins["fc3_da"]):
        layer["kernel"][:] = 0.0
        layer["bias"][:] = 0.0
    img["conv1_da"]["kernel"][0, 0, 0, :2] = (1.0, -1.0)
    img["conv2_da"]["kernel"][0, 0, :2, 0] = (k, -k)
    ins["fc1_da"]["kernel"][0, :2] = (1.0, -1.0)
    ins["fc2_da"]["kernel"][[0, 1], [0, 1]] = 1.0
    ins["fc3_da"]["kernel"][:2, 0] = (0.8 * k, -0.8 * k)
    return {"params": p}


@pytest.mark.parametrize("optimized,k", [(False, None), (False, 10.0),
                                         (True, None), (True, 10.0),
                                         (True, -0.1)])
def test_da_module_losses_and_gradients(optimized, k):
    """Every loss of the triplet DA module (image and aligned instance
    triplets, AdvGRL image and instance losses, consistency), the new
    DAState and the gradients of every input and weight, across the AdvGRL
    branches: plain, boosted, and the optimized band's middle and damped
    ends."""
    kw = dict(img_weight=1.0, ins_weight=1.0, cst_weight=0.1,
              triplet_img_weight=1.0, triplet_ins_weight=1.0,
              use_adv_grl=True, adv_grl_optimized=optimized,
              triplet_max_margin=3.0)
    jmod = jda.DomainAdaptationModule(**kw)
    tmod = tda.DomainAdaptationModule(C_IMG, C_INS, **kw)
    img, ins, dom, valid, ins_set, img_set, is_source = _da_inputs(
        7, strong=k is not None)
    state = jda.DAState.create(-0.5, 1.0).replace(
        last_triplet_img=jnp.float32(0.0))
    args = (dom, valid)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), [img], ins, *args, ins_set, img_set,
        is_source, state, deterministic=True))
    v = random_variables(shapes, seed=8)
    if k is not None:
        v = _classifier_weights(v, k)
    tmod.load_state_dict(module_state(v, "da_heads", "da_heads."))

    def jloss(v, img, ins, ins_set, img_set):
        losses, new = jmod.apply(v, [img], ins, *args, ins_set, img_set,
                                 is_source, state, deterministic=True)
        return sum(losses.values()), (losses, new)

    (_, (want, want_state)), grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            v, img, ins, ins_set, img_set)

    def nchw(x):
        return torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()

    def bscc(x):  # [B, S, 7, 7, C] -> [B, S, C, 7, 7]
        return torch.from_numpy(x).permute(0, 1, 4, 2, 3).requires_grad_()

    t_img, t_ins = nchw(img), bscc(ins)
    t_ins_set = tuple(bscc(x) for x in ins_set)
    t_img_set = tuple(nchw(x) for x in img_set)
    t_state = tda.DAState(*(torch.tensor(float(getattr(state, f)))
                            for f in ("margin_img", "margin_ins",
                                      "last_triplet_img",
                                      "last_triplet_ins")))
    got, got_state = tmod([t_img], t_ins, torch.from_numpy(dom),
                          torch.from_numpy(valid), t_ins_set, t_img_set,
                          torch.from_numpy(is_source), t_state,
                          deterministic=True)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   err_msg=name, **LOSS_TOL)
    for f in ("margin_img", "margin_ins", "last_triplet_img",
              "last_triplet_ins"):
        np.testing.assert_allclose(float(getattr(got_state, f)),
                                   float(getattr(want_state, f)),
                                   err_msg=f, **LOSS_TOL)
    assert float(got_state.margin_img) == pytest.approx(-0.499, abs=1e-6)

    sum(got.values()).backward()
    _close_to_leaf_max(t_img.grad.permute(0, 2, 3, 1), grads[1], what="img")
    _close_to_leaf_max(t_ins.grad.permute(0, 1, 3, 4, 2), grads[2],
                       what="ins")
    for i in range(3):
        _close_to_leaf_max(t_ins_set[i].grad.permute(0, 1, 3, 4, 2),
                           grads[3][i], what=f"ins_set[{i}]")
        _close_to_leaf_max(t_img_set[i].grad.permute(0, 2, 3, 1),
                           grads[4][i], what=f"img_set[{i}]")
    want_w = module_state({"params": grads[0]["params"]}, "da_heads",
                          "da_heads.")
    for name, p in tmod.named_parameters():
        _close_to_leaf_max(p.grad, want_w[name], atol=1e-8, what=name)


def test_da_ins_dropout_draws_from_generator():
    """deterministic=False: dropout from the explicit generator (same seed,
    same losses; another seed, other losses); deterministic=True: none."""
    torch.manual_seed(0)
    mod = tda.DomainAdaptationModule(C_IMG, C_INS, cst_weight=0.1)
    img, ins, dom, valid, _, _, is_source = _da_inputs(9, strong=False)
    args = ([torch.from_numpy(img).permute(0, 3, 1, 2)],
            torch.from_numpy(ins).permute(0, 1, 4, 2, 3),
            torch.from_numpy(dom), torch.from_numpy(valid), None, None,
            torch.from_numpy(is_source), tda.DAState.create())

    def run(seed, deterministic=False):
        gen = torch.Generator().manual_seed(seed)
        losses, _ = mod(*args, deterministic=deterministic, generator=gen)
        return losses["loss_da_instance"].item()

    assert run(1) == run(1)
    assert run(1) != run(2)
    assert run(1, True) == run(2, True)


def test_da_module_on_fpn_levels():
    """The module as the FPN models call it: the image head and its AdvGRL
    and consistency losses over three levels of other sizes, the image
    triplet on level 0, the instance head on flat MLP features [2k, S, C]
    (``avgpool_ins`` off); the consistency loss on (0.1), as the YAMLs'
    weight 0 would leave it unchecked. Losses, the new margin and every
    input and weight gradient against JAX."""
    kw = dict(img_weight=1.0, ins_weight=1.0, cst_weight=0.1,
              triplet_img_weight=1.0, triplet_ins_weight=0.0,
              use_adv_grl=True, triplet_max_margin=3.0, avgpool_ins=False)
    jmod = jda.DomainAdaptationModule(**kw)
    tmod = tda.DomainAdaptationModule(C_IMG, C_INS, **kw)
    rng = np.random.RandomState(9)
    levels = [rng.randn(2 * K, h, w, C_IMG).astype(np.float32)
              for h, w in ((H, W), (3, 4), (1, 2))]
    ins = rng.randn(2 * K, S, C_INS).astype(np.float32)
    _, _, dom, valid, _, img_set, is_source = _da_inputs(10, strong=False)
    state = jda.DAState.create(-0.5, 1.0)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), levels, ins, dom, valid, None, img_set,
        is_source, state, deterministic=True))
    v = random_variables(shapes, seed=11)
    tmod.load_state_dict(module_state(v, "da_heads", "da_heads."))

    def jloss(v, levels, ins, img_set):
        losses, new = jmod.apply(v, levels, ins, dom, valid, None, img_set,
                                 is_source, state, deterministic=True)
        return sum(losses.values()), (losses, new)

    (_, (want, want_state)), grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(v, levels, ins, img_set)

    def nchw(x):
        return torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()

    t_levels = [nchw(x) for x in levels]
    t_ins = torch.from_numpy(ins).requires_grad_()
    t_img_set = tuple(nchw(x) for x in img_set)
    t_state = tda.DAState.create(-0.5, 1.0)
    got, got_state = tmod(t_levels, t_ins, torch.from_numpy(dom),
                          torch.from_numpy(valid), None, t_img_set,
                          torch.from_numpy(is_source), t_state,
                          deterministic=True)
    assert set(got) == set(want) == {"loss_da_image", "loss_da_instance",
                                     "loss_da_consistency",
                                     "triplet_loss_image"}
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   err_msg=name, **LOSS_TOL)
    np.testing.assert_allclose(float(got_state.margin_img),
                               float(want_state.margin_img), **LOSS_TOL)
    sum(got.values()).backward()
    for i, t in enumerate(t_levels):
        _close_to_leaf_max(t.grad.permute(0, 2, 3, 1), grads[1][i],
                           what=f"level {i}")
    _close_to_leaf_max(t_ins.grad, grads[2], what="ins")
    for i, t in enumerate(t_img_set):
        _close_to_leaf_max(t.grad.permute(0, 2, 3, 1), grads[3][i],
                           what=f"img_set[{i}]")
    want_w = module_state({"params": grads[0]["params"]}, "da_heads",
                          "da_heads.")
    for name, p in tmod.named_parameters():
        _close_to_leaf_max(p.grad, want_w[name], atol=1e-8, what=name)
