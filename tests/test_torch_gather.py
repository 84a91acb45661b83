"""The port's row gather (plain version, and the CUDA wrappers' CPU branch)
against the TPU probe kernels of ``scripts/bench_gather_pallas.py`` in
Pallas interpret mode, the probe's own XLA reference
(``tbl.at[idx].get(mode="promise_in_bounds")``) and ``jnp.take(...,
mode="clip")``. A gather is a copy: every comparison is exact, in float32
and bfloat16.

Its adjoint, the scatter-add (plain version and the wrappers' CPU branch),
against ``jax.vjp`` of ``jnp.take(..., mode="clip")`` and the autograd of the
port's own gather: float32 sums in another order, atol 1e-6 of the largest
|row sum|. The scatter-add kernel's index bookkeeping (``row_csr``: each
destination row's sources, in order) against its invariants, and the sum in
its order (``row_scatter_add_csr_``) against ``jax.vjp`` at that tolerance
and, on the rows it sums in source order (all but the long ones, which it
sums in pieces), against ``index_add_`` bit for bit: the CPU's
``index_add_`` adds in source order too. In bfloat16 the scatter-add sums
in float32 and rounds once (the kernel's numerics): bit for bit the
float32 sum rounded, and within 2 bfloat16 ulps of the JAX adjoint of the
deformable conv's corner gathers (XLA's bfloat16 scatter-add).
"""

import functools
import importlib.util
import os

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.layers import deform_conv as jdc
from da_detect_tpu_torch import kernels
from da_detect_tpu_torch.ops import gather, gather_cuda
from tests.torch_harness import assert_ulps, bf16_numpy

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
@pytest.mark.parametrize("c", [1, 6, 9, 128])
def test_out_of_range_indices_clip(dtype, c):
    """Indices on both sides of [0, S) clamp, as jnp.take(mode="clip");
    C = 1, 6 and 9 (the deform pool's rows) are not multiples of 4, the
    narrow rows that the kernel maps over the flat output."""
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


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_narrow_column_slice_of_wider_table(dtype):
    """A narrow column slice: columns 8..11 of a [50, 48] map (rows of 3
    elements, 48 apart), gathered without a copy; 77 indices, so the flat
    output (231 elements) ends in a ragged run."""
    jtbl, jidx, tbl, idx = _inputs(4, 50, 48, 77, dtype, lo=-3, hi=53)
    want = jnp.take(jtbl[:, 8:11], jidx, axis=0, mode="clip")
    view = tbl[:, 8:11]
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


# the row_csr cases: each SCATTER_CASES input, and 9 taps' segments at once
CSR_CASES = {**{name: (1,) + case for name, case in SCATTER_CASES.items()},
             "nine_taps": (9, 30, 6, 200, -20, 50)}


def _csr_inputs(case, seed=13):
    g, s, _, p, lo, hi = CSR_CASES[case]
    idx = np.random.RandomState(seed).randint(lo, hi, (g, p)).astype(np.int32)
    return s, torch.from_numpy(idx)


@pytest.mark.parametrize("case", list(CSR_CASES))
def test_row_csr_invariants(case):
    """Each segment: row_ptr starts at 0, is monotone and ends at P; perm
    is a permutation of 0..P-1, ascending within a row, and each of a
    row's positions holds an index that clamps to that row; one build a
    call, whatever the number of segments."""
    s, idx = _csr_inputs(case)
    g, p = idx.shape
    before = gather.CSR_BUILDS["row_csr"]
    perm, row_ptr = gather.row_csr(idx, s)
    assert gather.CSR_BUILDS["row_csr"] == before + 1
    assert perm.dtype == row_ptr.dtype == torch.int32
    assert perm.shape == (g, p) and row_ptr.shape == (g, s + 1)
    for t in range(g):
        rp, pm = row_ptr[t].numpy(), perm[t].numpy()
        assert rp[0] == 0 and rp[-1] == p and (np.diff(rp) >= 0).all()
        np.testing.assert_array_equal(np.sort(pm), np.arange(p))
        rows = np.repeat(np.arange(s), np.diff(rp))
        np.testing.assert_array_equal(np.clip(idx[t].numpy(), 0, s - 1)[pm],
                                      rows)
        # stable: ascending positions within a row
        assert (np.diff(pm)[np.diff(rows) == 0] > 0).all()
        # a segment's part of the joint build is that segment's own CSR
        own_perm, own_ptr = gather.row_csr(idx[t], s)
        np.testing.assert_array_equal(own_perm.numpy(), pm)
        np.testing.assert_array_equal(own_ptr.numpy(), rp)


@pytest.mark.parametrize("long_row", [gather.LONG_ROW, 8])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_csr_ordered_sum_matches_jax_and_index_add(case, long_row):
    """The sum in the kernel's order is the adjoint of the clipped take.
    A row of at most ``long_row`` sources adds them in perm order from 0,
    which is how the CPU's index_add_ adds: equal bit for bit. A longer
    row adds its pieces (``long_row`` 8 splits the repeated rows' ~60
    sources and the 50 of one_row): the adjoint at the same tolerance."""
    s, grad, idx = _scatter_inputs(case)
    c = grad.shape[1]
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0,
                                        mode="clip"),
                     jnp.zeros((s, c), jnp.float32))
    (want,) = vjp(jnp.asarray(grad))
    g, i = torch.from_numpy(grad), torch.from_numpy(idx)
    perm, row_ptr = gather.row_csr(i, s)
    got = gather.row_scatter_add_csr_(torch.zeros(s, c), g, perm, row_ptr,
                                      long_row)
    _close(got, want)
    short = (row_ptr[1:] - row_ptr[:-1]) <= long_row
    assert torch.equal(got[short], gather.row_scatter_add(g, i, s)[short])
    if long_row == 8 and case in ("repeated_rows", "one_row"):
        assert not short.any()


def test_csr_ordered_sum_into_column_slice():
    """In place into columns 8..24 of a [50, 48] map: the old values are
    the sums' starting points, as for index_add_ (bit for bit), and the
    other columns stay."""
    rng = np.random.RandomState(14)
    base = torch.from_numpy(rng.randn(50, 48).astype(np.float32))
    grad = torch.from_numpy(rng.randn(77, 16).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-3, 53, 77).astype(np.int32))
    want = base.clone()
    gather.row_scatter_add_(want[:, 8:24], grad, idx)
    got = base.clone()
    assert gather.row_scatter_add_csr_(got[:, 8:24], grad,
                                       *gather.row_csr(idx, 50)) is not None
    assert torch.equal(got, want)


def test_scatter_add_bf16_against_jax_adjoint():
    """The bfloat16 scatter-add (the gathers' adjoint: float32 sums in
    source order, each value rounded once) against the JAX adjoint of
    ``_gather_tap`` in bfloat16 (XLA's scatter-add): within 2 ulps of its
    max; and within half an ulp of each value of the exact (float64) sum,
    which the one rounding guarantees; the kernel wrapper's CPU branch
    and the CSR order equal it bit for bit."""
    rng = np.random.RandomState(3)
    n, c, p = 40, 16, 90
    flat = bf16_numpy(rng.randn(n, c).astype(np.float32))
    idx = rng.randint(0, n, (1, p, 4)).astype(np.int32)
    wts = rng.rand(1, p, 4).astype(np.float32)
    cot = bf16_numpy(rng.randn(1, p, c).astype(np.float32))
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda t: jdc._gather_tap(t, jnp.asarray(idx),
                                               jnp.asarray(wts)),
                     jnp.asarray(flat).astype(bf))
    (want,) = vjp(jnp.asarray(cot).astype(bf))
    assert want.dtype == bf
    # the corner rows' gradients the adjoint sums: w_k * cot, in bfloat16
    rows = (torch.from_numpy(wts[0]).to(torch.bfloat16).T[..., None]
            * torch.from_numpy(cot[0]).to(torch.bfloat16)).reshape(4 * p, c)
    ridx = torch.from_numpy(idx[0].T.reshape(-1).copy())
    got = gather.row_scatter_add(rows, ridx, n)
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, 2, "vs JAX adjoint")
    exact = np.zeros((n, c))
    np.add.at(exact, ridx.numpy(), rows.double().numpy())
    half_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(exact),
                                                   1e-30))) - 8)
    assert np.all(np.abs(got.double().numpy() - exact) <= half_ulp)
    assert torch.equal(gather_cuda.row_scatter_add(rows, ridx, n), got)
    perm, row_ptr = gather.row_csr(ridx, n)
    ordered = gather.row_scatter_add_csr_(
        torch.zeros(n, c, dtype=torch.bfloat16), rows, perm, row_ptr)
    assert torch.equal(ordered, got)


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_add_bf16_rounds_once(case):
    """A bfloat16 scatter-add sums in float32 and rounds each value once:
    the plain version, the kernel wrapper's CPU branch and the kernel's
    order (``row_scatter_add_csr_``) equal the float32 sum of the same
    (bfloat16) rows rounded to bfloat16, bit for bit (the CSR order on
    the rows it sums in source order); in place into a column slice too.
    Not the CPU's bfloat16 ``index_add_``, which rounds after every add."""
    s, grad32, idx = _scatter_inputs(case)
    grad = torch.from_numpy(grad32).to(torch.bfloat16)
    i = torch.from_numpy(idx)
    want = gather.row_scatter_add(grad.float(), i, s).to(torch.bfloat16)
    got = gather.row_scatter_add(grad, i, s)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.equal(gather_cuda.row_scatter_add(grad, i, s), want)
    perm, row_ptr = gather.row_csr(i, s)
    short = (row_ptr[1:] - row_ptr[:-1]) <= gather.LONG_ROW
    ordered = gather.row_scatter_add_csr_(
        torch.zeros(s, grad.shape[1], dtype=torch.bfloat16), grad, perm,
        row_ptr)
    assert torch.equal(ordered[short], want[short])
    wide = torch.ones(s, grad.shape[1] + 5, dtype=torch.bfloat16)
    gather.row_scatter_add_(wide[:, 2:2 + grad.shape[1]], grad, i)
    assert torch.equal(wide[:, 2:2 + grad.shape[1]],
                       (1.0 + gather.row_scatter_add(grad.float(), i, s)
                        ).to(torch.bfloat16))
    assert torch.equal(wide[:, :2], torch.ones(s, 2, dtype=torch.bfloat16))
