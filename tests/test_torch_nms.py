"""The port's NMS (da_detect_tpu_torch/ops/nms.py and the CPU branch of the
kernel wrapper ops/nms_cuda.py) against the JAX package's Pallas kernel (in
interpret mode) and its XLA nms_mask/nms_topk, on the clustered cases of
tests/test_nms.py. Keep masks and indices must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import da_detect_tpu.ops.nms_pallas as NP
from da_detect_tpu.ops import nms as jnms
from da_detect_tpu_torch.ops import nms as tnms
from da_detect_tpu_torch.ops import nms_cuda
from tests.test_nms import make_cluster_boxes, np_greedy_nms


@pytest.fixture(scope="module", autouse=True)
def _setup():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    interpret = NP.INTERPRET
    NP.INTERPRET = True
    yield
    NP.INTERPRET = interpret
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))[None]


@pytest.mark.parametrize("n,seed,thresh", [(700, 31, 0.7), (1100, 32, 0.5)])
def test_sorted_mask_matches_pallas_kernel(n, seed, thresh):
    """Presorted boxes with invalid rows interspersed: the plain version and
    the wrapper's CPU branch equal the Pallas kernel bit for bit."""
    boxes, scores = make_cluster_boxes(n, seed)
    valid = np.random.RandomState(seed).rand(n) > 0.2
    order = np.argsort(-scores, kind="stable")
    bs, vs = boxes[order], valid[order]
    want = np.asarray(NP.nms_mask_pallas_sorted(jnp.asarray(bs),
                                                jnp.asarray(vs), thresh))
    plain = tnms.nms_mask_sorted(_t(bs), _t(vs), thresh)[0].numpy()
    wrapped = nms_cuda.nms_mask_sorted(_t(bs), _t(vs), thresh)[0].numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(wrapped, want)
    # and equals the numpy greedy oracle on the valid subset
    greedy = np_greedy_nms(bs[vs], scores[order][vs], thresh)
    np.testing.assert_array_equal(plain[vs], greedy)
    assert not np.any(plain & ~vs)


@pytest.mark.parametrize("n,seed,thresh", [(33, 0, 0.5), (200, 1, 0.7),
                                           (513, 2, 0.3), (1000, 3, 0.5)])
def test_nms_mask_matches_jax(n, seed, thresh):
    boxes, scores = make_cluster_boxes(n, seed)
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.ones(n, bool), thresh))
    got = tnms.nms_mask(_t(boxes), _t(scores), torch.ones(1, n, dtype=bool),
                        thresh, impl="plain")[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_greedy_nms(boxes, scores, thresh))


def test_nms_mask_batched_equals_per_image():
    """A batch of images gives each image's own keep mask."""
    cases = [make_cluster_boxes(300, s) for s in (41, 42)]
    boxes = torch.from_numpy(np.stack([b for b, _ in cases]))
    scores = torch.from_numpy(np.stack([s for _, s in cases]))
    valid = torch.from_numpy(np.random.RandomState(43).rand(2, 300) > 0.1)
    got = tnms.nms_mask(boxes, scores, valid, 0.6, impl="plain")
    for i in range(2):
        want = np.asarray(jnms.nms_mask(
            jnp.asarray(boxes[i].numpy()), jnp.asarray(scores[i].numpy()),
            jnp.asarray(valid[i].numpy()), 0.6))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("k,presorted", [(50, False), (900, False),
                                         (64, True), (900, True)])
def test_nms_topk_matches_jax(k, presorted, impl):
    """k below and above the survivor count, presorted with invalid rows
    interspersed (the RPN calling pattern) and unsorted (the box head's);
    on CPU tensors impl="cuda" goes through the wrapper's plain branch."""
    n = 400
    boxes, scores = make_cluster_boxes(n, 21)
    valid = np.random.RandomState(22).rand(n) > 0.2
    if presorted:
        order = np.argsort(-scores, kind="stable")
        boxes, scores, valid = boxes[order], scores[order], valid[order]
    idx_j, val_j = jnms.nms_topk(jnp.asarray(boxes), jnp.asarray(scores),
                                 jnp.asarray(valid), 0.5, k,
                                 presorted=presorted)
    idx_t, val_t = tnms.nms_topk(_t(boxes), _t(scores), _t(valid), 0.5, k,
                                 presorted=presorted, impl=impl)
    np.testing.assert_array_equal(val_t[0].numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_j))
    keep = np_greedy_nms(boxes[valid], scores[valid], 0.5)
    assert int(val_t.sum()) == min(k, int(keep.sum()))


def test_nms_topk_class_offset():
    """Per-class NMS through one NMS over class-offset boxes, as the box head
    runs it: equals the JAX package and a per-class greedy loop."""
    n, num_classes = 600, 4
    boxes, scores = make_cluster_boxes(n, 51)
    cls = np.random.RandomState(52).randint(1, num_classes, n)
    unit = boxes.max() + 1.0
    shifted = (boxes + cls[:, None].astype(np.float32) * unit).astype(
        np.float32)
    valid = np.ones(n, bool)
    idx_j, val_j = jnms.nms_topk(jnp.asarray(shifted), jnp.asarray(scores),
                                 jnp.asarray(valid), 0.3, 100)
    idx_t, val_t = tnms.nms_topk(_t(shifted), _t(scores), _t(valid), 0.3, 100,
                                 impl="cuda")
    np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(val_t[0].numpy(), np.asarray(val_j))
    keep = np.zeros(n, bool)
    for c in range(1, num_classes):
        m = cls == c
        keep[np.flatnonzero(m)] = np_greedy_nms(boxes[m], scores[m], 0.3)
    mask = tnms.nms_mask(_t(shifted), _t(scores), _t(valid), 0.3,
                         impl="plain")[0].numpy()
    np.testing.assert_array_equal(mask, keep)


@pytest.mark.parametrize("thresh,want", [(0.1, [1, 3]), (0.5, [1, 3]),
                                         (0.8, [1, 2, 3, 4]),
                                         (0.9, [0, 1, 2, 3, 4])])
def test_nms_caffe2_golden_small(thresh, want):
    data = np.array([[10, 10, 50, 60, 0.5], [11, 12, 48, 60, 0.7],
                     [8, 9, 40, 50, 0.6], [100, 100, 150, 140, 0.9],
                     [99, 110, 155, 139, 0.8]], dtype=np.float32)
    keep = tnms.nms_mask(_t(data[:, :4]), _t(data[:, 4]),
                         torch.ones(1, 5, dtype=bool), thresh,
                         impl="plain")[0].numpy()
    np.testing.assert_array_equal(np.flatnonzero(keep), np.array(want))


@pytest.mark.parametrize("n,seed,thresh,k", [(300, 61, 0.7, 1),
                                             (300, 61, 0.7, 40),
                                             (1100, 62, 0.5, 100),
                                             (1100, 62, 0.5, 2000),
                                             (700, 63, 0.3, 700)])
def test_sorted_mask_max_keep_truncates(n, seed, thresh, k):
    """``max_keep`` = k gives the full mask cut after its k-th kept box in
    score order (k past the survivors: the full mask), per image, through
    the plain version and the wrapper's CPU branch alike."""
    cases = [make_cluster_boxes(n, seed + i) for i in range(2)]
    order = [np.argsort(-s, kind="stable") for _, s in cases]
    bs = torch.from_numpy(np.stack([b[o] for (b, _), o in zip(cases, order)]))
    vs = torch.from_numpy(np.random.RandomState(seed).rand(2, n) > 0.2)
    full = tnms.nms_mask_sorted(bs, vs, thresh)
    want = full & (torch.cumsum(full, dim=1) <= k)
    got = tnms.nms_mask_sorted(bs, vs, thresh, max_keep=k)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        nms_cuda.nms_mask_sorted(bs, vs, thresh, max_keep=k).numpy(),
        want.numpy())
    assert (got.sum(1) == torch.clamp(full.sum(1), max=k)).all()


def test_max_keep_must_be_positive():
    boxes, valid = torch.zeros(1, 3, 4), torch.ones(1, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="max_keep"):
        tnms.nms_mask_sorted(boxes, valid, 0.5, max_keep=0)


@pytest.mark.parametrize("k,presorted", [(1, True), (30, True), (30, False),
                                         (500, True), (500, False)])
def test_nms_topk_through_max_keep_matches_pallas(k, presorted):
    """nms_topk stops the NMS after k kept boxes; its validity and indices
    equal the top k taken from the full keep mask and the JAX package's XLA
    route, and the Pallas route's (interpret mode) on the valid rows (the
    Pallas route orders the padding rows past the survivors otherwise)."""
    n = 400
    boxes, scores = make_cluster_boxes(n, 71)
    valid = np.random.RandomState(72).rand(n) > 0.2
    if presorted:
        order = np.argsort(-scores, kind="stable")
        boxes, scores, valid = boxes[order], scores[order], valid[order]
    jargs = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
             0.5, k)
    idx_p, val_p = NP.nms_topk_pallas(*jargs, presorted=presorted)
    idx_j, val_j = jnms.nms_topk(*jargs, presorted=presorted)
    idx_t, val_t = tnms.nms_topk(_t(boxes), _t(scores), _t(valid), 0.5, k,
                                 presorted=presorted, impl="plain")
    full = tnms.nms_mask(_t(boxes), _t(scores), _t(valid), 0.5,
                         impl="plain", presorted=presorted)
    idx_f, val_f = tnms.topk_survivors(full, _t(scores), k)
    for val_w in (val_p, val_j):
        np.testing.assert_array_equal(val_t[0].numpy(), np.asarray(val_w))
    ok = val_t[0].numpy()
    np.testing.assert_array_equal(idx_t[0].numpy()[ok], np.asarray(idx_p)[ok])
    np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(val_t.numpy(), val_f.numpy())
    np.testing.assert_array_equal(idx_t.numpy(), idx_f.numpy())


def test_nms_mask_max_keep_in_original_order():
    """Unsorted input: the k kept boxes are the k highest-scoring survivors,
    scattered back to their original places."""
    boxes, scores = make_cluster_boxes(500, 81)
    valid = torch.from_numpy(np.random.RandomState(82).rand(1, 500) > 0.1)
    full = tnms.nms_mask(_t(boxes), _t(scores), valid, 0.6, impl="plain")
    got = tnms.nms_mask(_t(boxes), _t(scores), valid, 0.6, impl="plain",
                        max_keep=25)
    top = np.argsort(-np.where(full[0].numpy(), scores, -np.inf),
                     kind="stable")[:25]
    want = np.zeros(500, bool)
    want[top] = True
    np.testing.assert_array_equal(got[0].numpy(), want)
