"""The port's deraining path (``models/derain.py``, ``ops/ssim.py``,
``tools/train_derain.py``) against the JAX package's, on the same numpy
weights and inputs: the per-pixel filtering, the bilinear resize, ``KPN``
and ``KPNRef`` forwards, ``derain_loss``, ``ssim`` and ``psnr``, one Adam
step against optax, the learning-rate schedule, ``_sample_batch`` bit for
bit, the CLI end to end on the CPU, and the JAX package's learning check
(``tests/test_derain.py::test_kpn_reduces_rain``) on the port.

Shapes: crops that are not multiples of 16 (``nn.avg_pool`` floors an odd
size, so the decoder's resize is not exactly 2x): KPN at 36x44 (enc 36, 18,
9, mid 4), KPNRef at 40x56 (c5 at 2x3, up to 5x7). Weights from
``torch_harness.random_variables`` (kernels std 1/sqrt(fan_in), biases
normal(0.1)).

Tolerances: float32 modules rtol 1e-5 and atol 1e-5 of the output's largest
magnitude (float32 sums in another order); ssim, psnr and derain_loss rtol
1e-5; the Adam step's change of each parameter within 1e-3 of the learning
rate (the first update is lr * g / (|g| + eps), near lr in size); the
schedule rtol 1e-6 (optax computes it in float32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from da_detect_tpu.models import derain as jd
from da_detect_tpu.ops import ssim as jssim
from da_detect_tpu.tools import train_derain as jtrain
from da_detect_tpu_torch.models import derain as pd
from da_detect_tpu_torch.ops import ssim as pssim
from da_detect_tpu_torch.tools import train_derain as ptrain
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.torch_harness import nhwc_to_torch, random_variables, torch_to_nhwc

TOL = dict(rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got: torch.Tensor, want, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(torch_to_nhwc(got.detach()), want,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what, **TOL)


def _images(seed: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _pair(jmod, pmod, x: np.ndarray, seed: int = 2):
    """numpy variables of ``jmod`` on ``x``, loaded into ``pmod``."""
    variables = random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), x)), seed=seed)
    load_jax_variables(pmod, variables)
    return variables


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("ksize", [3, 5])
def test_apply_per_pixel_kernels_matches_jax(ksize):
    x = _images(0, (2, 12, 16, 3))
    k = np.random.RandomState(1).randn(2, 12, 16, ksize * ksize)
    k = np.asarray(jax.nn.softmax(k.astype(np.float32), axis=-1))
    want = jd.apply_per_pixel_kernels(jnp.asarray(x), jnp.asarray(k), ksize)
    got = pd.apply_per_pixel_kernels(nhwc_to_torch(x), nhwc_to_torch(k),
                                     ksize)
    _close(got, want)


@pytest.mark.parametrize("src,dst", [((4, 5), (9, 11)), ((2, 3), (5, 7)),
                                     ((7, 8), (14, 16)), ((3, 3), (7, 6))])
def test_resize_matches_jax_bilinear(src, dst):
    """``_up2`` (F.interpolate, half-pixel) against jax.image.resize
    "bilinear" where the target is not twice the source, at the edges
    too."""
    t = _images(2, (1, *src, 4))
    skip = np.zeros((1, *dst, 4), np.float32)
    want = jd._up2(jnp.asarray(t), jnp.asarray(skip))
    got = pd._up2(nhwc_to_torch(t), nhwc_to_torch(skip))
    _close(got, want)


@pytest.mark.parametrize("rate", [1, 2, 3, 4])
def test_kernel_conv_ref_matches_jax(rate):
    """c-major / tap-minor core layout, zero padding at dilation ``rate``,
    no softmax."""
    x = _images(3, (2, 10, 13, 3))
    core = np.random.RandomState(4).randn(2, 10, 13, 27).astype(np.float32)
    want = jd.kernel_conv_ref(jnp.asarray(x), jnp.asarray(core), 3, rate)
    got = pd.kernel_conv_ref(nhwc_to_torch(x), nhwc_to_torch(core), 3, rate)
    _close(got, want)


def test_derain_loss_matches_jax():
    pred, clean = _images(5, (2, 20, 24, 3)), _images(6, (2, 20, 24, 3))
    want = float(jd.derain_loss(jnp.asarray(pred), jnp.asarray(clean), 0.7))
    got = float(pd.derain_loss(nhwc_to_torch(pred), nhwc_to_torch(clean),
                               0.7))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_psnr_match_jax(size_average):
    a = _images(7, (2, 24, 32, 3))
    b = np.clip(a + np.random.RandomState(8).randn(*a.shape) * 0.05, 0,
                1).astype(np.float32)
    want = np.asarray(jssim.ssim(jnp.asarray(a), jnp.asarray(b),
                                 size_average=size_average))
    got = pssim.ssim(nhwc_to_torch(a), nhwc_to_torch(b),
                     size_average=size_average)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        float(pssim.psnr(nhwc_to_torch(a), nhwc_to_torch(b))),
        float(jssim.psnr(jnp.asarray(a), jnp.asarray(b))), **TOL)


# ---------------------------------------------------------------- nets

def test_kpn_matches_jax():
    """KPN (base 32, 5x5 softmaxed kernels) at 36x44."""
    x = _images(9, (2, 36, 44, 3))
    jmod, pmod = jd.KPN(), pd.KPN()
    variables = _pair(jmod, pmod, x)
    want = jax.jit(jmod.apply)(variables, x)
    with torch.no_grad():
        got = pmod(nhwc_to_torch(x))
    _close(got, want)


def test_kpn_ref_matches_jax():
    """KPNRef (3x3 kernels at rates 1-4, conv_final) at 40x56."""
    x = _images(10, (1, 40, 56, 3))
    jmod, pmod = jd.KPNRef(), pd.KPNRef()
    variables = _pair(jmod, pmod, x, seed=3)
    want = jax.jit(jmod.apply)(variables, x)
    with torch.no_grad():
        got = pmod(nhwc_to_torch(x))
    assert tuple(got.shape) == (1, 3, 40, 56)
    _close(got, want)


def test_adam_step_matches_optax():
    """One training step of the CLI's (``make_train_step``: derain_loss
    plus 0.5 (1 - SSIM), Adam betas 0.5 / 0.999 at the schedule's rate)
    against JAX's ``make_train_step`` with optax: the loss, and each
    parameter's change."""
    lr = 2e-4
    rainy, clean = _images(11, (2, 20, 28, 3)), _images(12, (2, 20, 28, 3))
    jmod, pmod = jd.KPN(base=8), pd.KPN(base=8)
    variables = _pair(jmod, pmod, rainy, seed=4)
    sched = optax.join_schedules(
        [optax.constant_schedule(lr), optax.linear_schedule(lr, 0.0, 5)],
        [5])
    tx = optax.adam(sched, b1=0.5, b2=0.999)
    params = variables["params"]
    jstep = jtrain.make_train_step(jmod, tx, 0.5)
    new, _, jloss = jstep(jax.tree.map(jnp.array, params), tx.init(params),
                          jnp.asarray(rainy), jnp.asarray(clean))
    load_jax_variables(pmod, {"params": jax.tree.map(
        lambda a, b: np.asarray(a) - np.asarray(b), new, params)})
    want = {k: v.clone() for k, v in pmod.state_dict().items()}
    load_jax_variables(pmod, variables)
    before = {k: v.clone() for k, v in pmod.state_dict().items()}
    opt = torch.optim.Adam(pmod.parameters(), lr=lr, betas=(0.5, 0.999))
    step = ptrain.make_train_step(pmod, opt, 0.5,
                                  ptrain.lr_schedule(lr, 10, 5))
    loss = step(nhwc_to_torch(rainy), nhwc_to_torch(clean))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for name, p in pmod.state_dict().items():
        delta = p - before[name]
        assert float(delta.abs().max()) > 0.5 * lr, name
        torch.testing.assert_close(delta, want[name], rtol=0,
                                   atol=1e-3 * lr, msg=name)


@pytest.mark.parametrize("iters,frac", [(10, 0.5), (7, 0.3), (4, 1.0)])
def test_lr_schedule_matches_optax(iters, frac):
    """The rate of each update, counted from the first, around and past
    the decay's start: constant, then linear to 0."""
    lr = 2e-4
    start = int(iters * frac)
    want = optax.join_schedules(
        [optax.constant_schedule(lr),
         optax.linear_schedule(lr, 0.0, iters - start)], [start])
    got = ptrain.lr_schedule(lr, iters, start)
    for count in range(iters + 2):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=str(count))


def test_kpn_reduces_rain():
    """The JAX package's learning check on the port: KPN base 8 on two
    smooth 32x32 images with rain streaks every 4th column, 200 Adam steps
    (lr 1e-3) of derain_loss: the loss halves and the MSE to the clean
    images falls below a fifth of the rain's."""
    rng = np.random.RandomState(2)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    base_img = 0.5 + 0.4 * np.sin(2 * np.pi * (yy + 0.5 * xx))
    clean = np.stack([np.clip(base_img + 0.05 * rng.randn(32, 32), 0, 1)
                      for _ in range(2)], 0).astype(np.float32)
    clean = np.repeat(clean[..., None], 3, axis=-1)
    rain = clean.copy()
    rain[:, :, ::4, :] = np.minimum(rain[:, :, ::4, :] + 0.7, 1.0)
    clean_t, rain_t = nhwc_to_torch(clean), nhwc_to_torch(rain)

    model = pd.KPN(base=8)
    ptrain.init_kpn(model, torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for _ in range(200):
        opt.zero_grad(set_to_none=True)
        loss = pd.derain_loss(model(rain_t), clean_t)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    base_err = float(torch.mean((rain_t - clean_t) ** 2))
    with torch.no_grad():
        final_err = float(torch.mean((model(rain_t) - clean_t) ** 2))
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
    assert final_err < base_err * 0.2, (final_err, base_err)


# ---------------------------------------------------------------- CLI

def _write_images(root, n: int = 4, hw=(80, 96)) -> str:
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = np.zeros((*hw, 3), np.uint8)
        cv2.circle(img, (20 + 10 * i, 40), 14, (40 + 40 * i, 160, 220), -1)
        img = (img.astype(np.float32)
               + rng.randint(0, 60, (*hw, 3))).clip(0, 255)
        cv2.imwrite(os.path.join(root, f"{i}.png"), img.astype(np.uint8))
    return root


@pytest.mark.parametrize("paired", [False, True])
def test_sample_batch_bit_equal_to_jax(tmp_path, paired):
    """``_sample_batch`` from one seed: the same pairs, crops, padding
    (a crop larger than an image's side) and synthesized rain, bit for bit
    (the port's image reader and rain synthesis against JAX's)."""
    clean = _write_images(str(tmp_path / "clean"))
    rainy = _write_images(str(tmp_path / "rainy"), hw=(80, 96)) \
        if paired else None
    jpairs = jtrain._load_pairs(clean, rainy)
    ppairs = ptrain._load_pairs(clean, rainy)
    assert ppairs == jpairs
    for crop in (64, 88):
        want = jtrain._sample_batch(jpairs, crop, 3,
                                    np.random.RandomState(5))
        got = ptrain._sample_batch(ppairs, crop, 3, np.random.RandomState(5))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_train_derain_cli_writes_jax_npz(tmp_path):
    """The CLI on ``--device cpu`` (6 iterations of batch 2 at crop 64):
    its log lines, and ``kpn_final.npz`` with the JAX package's keys and
    shapes; without ``--device`` and without a card it raises."""
    clean = _write_images(str(tmp_path / "clean"))
    out = tmp_path / "out"
    args = ["--clean-dir", clean, "--iters", "6", "--batch", "2", "--crop",
            "64", "--val-period", "6", "--log-period", "3", "--out",
            str(out)]
    summary = ptrain.main(args + ["--device", "cpu"])
    assert np.isfinite(summary["loss"]) and summary["psnr"] > 5
    assert 0 < summary["ssim"] <= 1
    with np.load(out / "kpn_final.npz") as saved:
        got = {k: saved[k].shape for k in saved.files}
    shapes = jax.eval_shape(lambda: jd.KPN().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    want = {jax.tree_util.keystr(p): s.shape for p, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert got == want
    log = (out / "log_rank0.txt").read_text()
    for line in ("3 train pairs, 1 val pairs", "iter 3/6 loss",
                 "iter 6: val PSNR", "saved"):
        assert line in log, line
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ptrain.main(args)
