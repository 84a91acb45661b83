"""The port's row gather (plain version, and the CUDA wrappers' CPU branch)
against the TPU probe kernels of ``scripts/bench_gather_pallas.py`` in
Pallas interpret mode, the probe's own XLA reference
(``tbl.at[idx].get(mode="promise_in_bounds")``) and ``jnp.take(...,
mode="clip")``. A gather is a copy: every comparison is exact, in float32
and bfloat16.

Its adjoint, the scatter-add (plain version and the wrappers' CPU branch),
against ``jax.vjp`` of ``jnp.take(..., mode="clip")`` and the autograd of the
port's own gather: float32 sums in another order, atol 1e-6 of the largest
|row sum|.
"""

import functools
import importlib.util
import os

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu_torch import kernels
from da_detect_tpu_torch.ops import gather, gather_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "bench_gather_pallas",
    os.path.join(REPO, "scripts", "bench_gather_pallas.py"))
PROBE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PROBE)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
PORT_GATHERS = {"plain": gather.row_gather,
                "row_gather": gather_cuda.row_gather,
                "row_gather_bulk": gather_cuda.row_gather_bulk}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    """The probe's pallas_call in interpret mode (it runs on the CPU)."""
    monkeypatch.setattr(PROBE.pl, "pallas_call",
                        functools.partial(PROBE.pl.pallas_call,
                                          interpret=True))


def _inputs(seed, s, c, p, dtype, lo=0, hi=None):
    rng = np.random.RandomState(seed)
    tbl = rng.randn(s, c).astype(np.float32)
    idx = rng.randint(lo, s if hi is None else hi, p).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(tbl).astype(jdt), jnp.asarray(idx),
            torch.from_numpy(tbl).to(tdt), torch.from_numpy(idx))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.dtype in (torch.float32, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["take", "index", "loop", "dma"])
def test_port_matches_probe_kernels(interpret, mode, dtype):
    """In-range indices (the probe kernels' "loop" and "dma" modes do not
    clip): a [40, 128] table, 64 rows in blocks of 16."""
    s, c, p, pb = 40, 128, 64, 16
    jtbl, jidx, tbl, idx = _inputs(1, s, c, p, dtype)
    if mode == "dma":
        probe = PROBE.make_dma_gather(s, c, p, pb, DTYPES[dtype][0])
    else:
        probe = PROBE.make_gather(s, c, p, pb, mode)
    want = probe(jidx, jtbl)
    ref = jtbl.at[jidx].get(mode="promise_in_bounds")
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  np.asarray(ref.astype(jnp.float32)))
    for fn in PORT_GATHERS.values():
        _same(fn(tbl, idx), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [6, 128])
def test_out_of_range_indices_clip(dtype, c):
    """Indices on both sides of [0, S) clamp, as jnp.take(mode="clip");
    C = 6 is not a multiple of 4."""
    jtbl, jidx, tbl, idx = _inputs(2, 30, c, 200, dtype, lo=-20, hi=50)
    assert int(idx.min()) < 0 and int(idx.max()) >= 30
    want = jnp.take(jtbl, jidx, axis=0, mode="clip")
    before = dict(kernels.LAUNCHES)
    for fn in PORT_GATHERS.values():
        _same(fn(tbl, idx), want)
    assert dict(kernels.LAUNCHES) == before  # CPU tensors launch nothing


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_column_slice_of_wider_table(dtype):
    """A deformable group's gather: columns 8..24 of a [50, 48] map, rows
    48 elements apart, gathered without a copy."""
    jtbl, jidx, tbl, idx = _inputs(3, 50, 48, 77, dtype, lo=-3, hi=53)
    want = jnp.take(jtbl[:, 8:24], jidx, axis=0, mode="clip")
    view = tbl[:, 8:24]
    assert view.stride() == (48, 1)
    for fn in PORT_GATHERS.values():
        _same(fn(view, idx), want)


def test_empty_index():
    tbl = torch.randn(5, 8)
    for fn in PORT_GATHERS.values():
        assert fn(tbl, torch.zeros(0, dtype=torch.int32)).shape == (0, 8)


SCATTER_CASES = {
    # name: (S, C, P, lo, hi): indices drawn from [lo, hi)
    "in_range": (40, 128, 64, 0, 40),
    "clamped_c6": (30, 6, 200, -20, 50),        # C % 4 != 0
    "repeated_rows": (5, 16, 300, 0, 5),        # each row ~60 times
    "one_row": (1, 8, 50, -3, 4),
    "empty": (7, 8, 0, 0, 7),
}


def _scatter_inputs(case, seed=11):
    s, c, p, lo, hi = SCATTER_CASES[case]
    rng = np.random.RandomState(seed)
    grad = rng.randn(p, c).astype(np.float32)
    idx = rng.randint(lo, hi, p).astype(np.int32)
    return s, grad, idx


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_add_matches_jax_vjp(case):
    """row_scatter_add is the adjoint of the clipped take: jax.vjp of
    jnp.take(mode="clip"), and autograd of the port's row_gather and of
    both kernel wrappers (their CPU branches launch nothing)."""
    s, grad, idx = _scatter_inputs(case)
    c = grad.shape[1]
    table = np.zeros((s, c), np.float32)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0,
                                        mode="clip"), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(grad))
    g, i = torch.from_numpy(grad), torch.from_numpy(idx)
    before = dict(kernels.LAUNCHES)
    _close(gather.row_scatter_add(g, i, s), want)
    _close(gather_cuda.row_scatter_add(g, i, s), want)
    for fn in PORT_GATHERS.values():
        t = torch.zeros(s, c, requires_grad=True)
        (fn(t, i) * g).sum().backward()
        _close(t.grad, want)
    assert dict(kernels.LAUNCHES) == before


def test_scatter_add_into_column_slice():
    """row_scatter_add_ adds into a caller's [S, C] view in place: columns
    8..24 of a [50, 48] map (rows 48 elements apart), the other columns
    untouched, the old values kept; as jax.vjp of the take of that
    slice."""
    rng = np.random.RandomState(12)
    base = rng.randn(50, 48).astype(np.float32)
    grad = rng.randn(77, 16).astype(np.float32)
    idx = rng.randint(-3, 53, 77).astype(np.int32)
    _, vjp = jax.vjp(lambda t: jnp.take(t[:, 8:24], jnp.asarray(idx), axis=0,
                                        mode="clip"), jnp.asarray(base))
    (want,) = vjp(jnp.asarray(grad))
    for fn in (gather.row_scatter_add_, gather_cuda.row_scatter_add_):
        dst = torch.from_numpy(base.copy())
        view = dst[:, 8:24]
        assert view.stride() == (48, 1)
        assert fn(view, torch.from_numpy(grad), torch.from_numpy(idx)) \
            is view
        _close(dst - torch.from_numpy(base), want)
        np.testing.assert_array_equal(dst[:, :8].numpy(), base[:, :8])
        np.testing.assert_array_equal(dst[:, 24:].numpy(), base[:, 24:])
