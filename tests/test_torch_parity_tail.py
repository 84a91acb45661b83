"""The JAX package's last public functions in the port, each against the
JAX function on the same numpy-seeded inputs: ROIPool
(``ops/roi_align.py::roi_pool_image``), gradient reversal
(``ops/grl.py::grad_reverse``), ``data/transforms.py::apply_geometry``,
``utils/metric_logger.py::Timer`` and ``parallel/mesh.py``'s
``data_sharding`` and ``put_batch``.

Tolerances: ROIPool's forward exact (a max picks an input value; both
packages take the same bins); its gradient within 1e-6 of the largest
|gradient| (the gradient lands on each bin's max in both, summed over the
bins in another order) on tie-free features; chunks of ROIs change the
forward in nothing and the gradient's sums' order only (the same bound).
``grad_reverse`` exact (one float32 product). ``apply_geometry``'s boxes exact; its pixels within one
uint8 level, at most ``RESIZE_OFF_BY_ONE`` of them off (the port resizes
with ``F.interpolate``, JAX with ``cv2.resize``; ``test_torch_data.py``'s
bound). ``Timer`` on the same clock readings, exact. The placements:
each rank's rows equal JAX's shard on that device, exact.
"""

import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.data.transforms import apply_geometry as j_apply_geometry
from da_detect_tpu.ops.grl import grad_reverse as j_grad_reverse
from da_detect_tpu.ops.roi_align import roi_pool_image as j_roi_pool
from da_detect_tpu.parallel import data_sharding as j_data_sharding
from da_detect_tpu.parallel import make_mesh as j_make_mesh
from da_detect_tpu.parallel import put_batch as j_put_batch
from da_detect_tpu.utils.metric_logger import Timer as JTimer
from da_detect_tpu_torch import parallel
from da_detect_tpu_torch.data.transforms import apply_geometry
from da_detect_tpu_torch.entry import make_batch
from da_detect_tpu_torch.ops.grl import grad_reverse
from da_detect_tpu_torch.ops import roi_align
from da_detect_tpu_torch.ops.roi_align import roi_pool_image
from da_detect_tpu_torch.utils.metric_logger import Timer
from tests.test_roi_align import make_case
from tests.test_torch_data import RESIZE_OFF_BY_ONE
from tests.torch_harness import tiny_cfgs

SCALE = 1.0 / 16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- ROIPool ---------------------------------------------------------------
def _pool_case(seed, **kw):
    """``make_case``'s inputs (ROIs past the map's edges among them), two
    ROIs more: one wholly outside the map (every bin empty) and one
    narrower than a bin (rounded to a point)."""
    feat, rois = make_case(seed, **kw)
    h, w = feat.shape[:2]
    extra = np.array([[w * 16 + 40, h * 16 + 40, w * 16 + 90, h * 16 + 80],
                      [33.0, 47.0, 34.0, 47.5]], np.float32)
    return feat, np.concatenate([rois, extra])


def _port_pool(feat, rois, p, **kw):
    return roi_pool_image(torch.from_numpy(feat).permute(2, 0, 1),
                          torch.from_numpy(rois), spatial_scale=SCALE,
                          output_size=p, **kw)


@pytest.mark.parametrize("seed,p,hw", [(0, 7, (25, 38)), (1, 7, (25, 38)),
                                       (2, 7, (25, 38)), (3, 3, (25, 38)),
                                       (7, 14, (38, 76))])
def test_roi_pool_image_matches_jax(seed, p, hw):
    feat, rois = _pool_case(seed, h=hw[0], w=hw[1])
    want = np.asarray(j_roi_pool(jnp.asarray(feat), jnp.asarray(rois),
                                 spatial_scale=SCALE, output_size=p))
    got = _port_pool(feat, rois, p)
    assert got.shape == (len(rois), feat.shape[2], p, p)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    # the case holds empty bins (0 in both) and the wholly outside ROI
    assert (want == 0).all(-1).sum() > 0 and (want[-2] == 0).all()


def test_roi_pool_image_chunks_give_the_same_result(monkeypatch):
    feat, rois = _pool_case(4)
    f = torch.from_numpy(feat).permute(2, 0, 1).requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(9).randn(
        len(rois), feat.shape[2], 7, 7).astype(np.float32))
    outs, grads = [], []
    for chunk in (len(rois), 5, 1):
        monkeypatch.setattr(roi_align, "ROI_POOL_CHUNK", chunk)
        out = roi_pool_image(f, torch.from_numpy(rois), spatial_scale=SCALE,
                             output_size=7)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, f, g)[0])
    top = float(grads[0].abs().max())
    for out, grad in zip(outs[1:], grads[1:]):
        assert torch.equal(out, outs[0])
        # the chunks' gradients are summed in another order
        torch.testing.assert_close(grad, grads[0], rtol=0, atol=1e-6 * top)


@pytest.mark.parametrize("seed", [1, 5])
def test_roi_pool_image_gradient_matches_jax(seed):
    """d features against ``jax.grad`` on tie-free features (standard
    normal draws): each bin's gradient lands on its max."""
    feat, rois = _pool_case(seed)
    assert len(np.unique(feat)) == feat.size
    g = np.random.RandomState(seed + 10).randn(
        len(rois), 7, 7, feat.shape[2]).astype(np.float32)
    want = np.asarray(jax.grad(lambda f: jnp.sum(j_roi_pool(
        f, jnp.asarray(rois), spatial_scale=SCALE, output_size=7) * g))(
        jnp.asarray(feat)))
    f = torch.from_numpy(feat).permute(2, 0, 1).requires_grad_(True)
    out = roi_pool_image(f, torch.from_numpy(rois), spatial_scale=SCALE,
                         output_size=7)
    (got,) = torch.autograd.grad(
        out, f, torch.from_numpy(g).permute(0, 3, 1, 2))
    got = got.permute(1, 2, 0).numpy()
    assert np.abs(want).max() > 1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_array_equal(got != 0, want != 0)


# -- gradient reversal (tests/test_grl_losses.py::test_grl_gradient_scaled)
@pytest.mark.parametrize("weight", [0.1, 0.5, 2.0])
def test_grad_reverse_matches_jax(weight):
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    want_y = np.asarray(j_grad_reverse(jnp.asarray(x), weight))
    want = np.asarray(jax.grad(
        lambda y: jnp.sum(j_grad_reverse(y, weight) ** 2))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    y = grad_reverse(t, weight)
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    (got,) = torch.autograd.grad((y ** 2).sum(), t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), 2 * x * -weight, rtol=1e-6)
    # a 0-d tensor weight (AdvGRL's, computed on the device)
    t2 = torch.from_numpy(x).requires_grad_(True)
    (got2,) = torch.autograd.grad(
        grad_reverse(t2, torch.tensor(weight)).sum(), t2)
    want2 = np.asarray(jax.grad(lambda y: jnp.sum(
        j_grad_reverse(y, jnp.asarray(weight))))(jnp.asarray(x)))
    np.testing.assert_array_equal(got2.numpy(), want2)


# -- apply_geometry ----------------------------------------------------------
@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("hw,min_size,max_size", [
    ((120, 160), 96, 128), ((120, 160), 200, 260), ((90, 200), 80, None),
    ((96, 128), 96, 1333)])
def test_apply_geometry_matches_jax(hw, min_size, max_size, hflip):
    rng = np.random.RandomState(sum(hw) + min_size)
    img = cv2.GaussianBlur(rng.randint(0, 255, hw + (3,), np.uint8),
                           (3, 3), 1)
    xy = rng.uniform(0, 0.6, (7, 2)) * hw[::-1]
    boxes = np.concatenate(
        [xy, xy + rng.uniform(0.05, 0.4, (7, 2)) * hw[::-1]], 1).astype(
        np.float32)
    want = j_apply_geometry(img, boxes, min_size=min_size,
                            max_size=max_size, hflip=hflip)
    got = apply_geometry(img, boxes, min_size=min_size, max_size=max_size,
                         hflip=hflip)
    assert got[2] == want[2]
    assert got[0].shape == want[0].shape and got[0].dtype == np.uint8
    assert got[0].flags["C_CONTIGUOUS"]
    assert got[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], want[1])
    diff = np.abs(got[0].astype(int) - want[0])
    assert diff.max() <= 1
    assert (diff > 0).mean() <= RESIZE_OFF_BY_ONE
    # no boxes
    none = apply_geometry(img, np.zeros((0, 4), np.float32),
                          min_size=min_size, max_size=max_size, hflip=hflip)
    jnone = j_apply_geometry(img, np.zeros((0, 4), np.float32),
                             min_size=min_size, max_size=max_size,
                             hflip=hflip)
    assert none[1].shape == jnone[1].shape == (0, 4)
    assert none[1].dtype == jnone[1].dtype


# -- Timer -------------------------------------------------------------------
def test_timer_matches_jax(monkeypatch):
    readings = [1.0, 1.25, 2.0, 2.5, 10.0, 10.125]
    for cls in (JTimer, Timer):
        assert cls().average_time == 0.0
    results = []
    for cls in (JTimer, Timer):
        clock = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t = cls()
        laps = []
        for _ in range(3):
            t.tic()
            laps.append(t.toc())
        results.append((laps, t.total_time, t.calls, t.average_time))
        t.reset()
        assert (t.total_time, t.calls, t.average_time) == (0.0, 0, 0.0)
    assert results[0] == results[1]
    assert results[1] == ([0.25, 0.5, 0.125], 0.875, 3, 0.875 / 3)


# -- data_sharding / put_batch ---------------------------------------------
@pytest.mark.parametrize("spatial,model", [(1, 1), (2, 1), (2, 2)])
def test_put_batch_data_sharding_matches_jax(spatial, model):
    """Rank r's part of (ImageBatch, Targets) under ``data_sharding``
    equals JAX's addressable shard on device r: every leaf over data,
    images whole over space."""
    jcfg, pcfg = tiny_cfgs()
    jtree = graft._batch(jcfg, 8 // (spatial * model), seed=0)
    ptree = make_batch(pcfg, 8 // (spatial * model), seed=0)
    mesh = j_make_mesh(8, spatial=spatial, model=model)
    jb, jt = j_put_batch(jtree, j_data_sharding(mesh))
    for r in range(8):
        pmesh = parallel.make_mesh(8, spatial, model, rank=r)
        b, t = parallel.put_batch(ptree, parallel.data_sharding(pmesh))

        def on(arr):
            return np.asarray(next(s.data for s in arr.addressable_shards
                                   if s.device.id == r))
        assert b.images.shape[0] == 1
        np.testing.assert_array_equal(b.images.permute(0, 2, 3, 1).numpy(),
                                      on(jb.images))
        for f in ("sizes", "orig_sizes", "is_source"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          on(getattr(jb, f)))
        for f in ("boxes", "labels", "valid"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          on(getattr(jt, f)))


def test_put_batch_passes_none_and_dispatches():
    jcfg, pcfg = tiny_cfgs()
    jtree = graft._batch(jcfg, 4, seed=0)
    ptree = make_batch(pcfg, 4, seed=0)
    assert j_put_batch(jtree, None) is jtree
    assert parallel.put_batch(ptree, None) is ptree
    # no mesh, or one data rank: the whole batch
    for mesh in (None, parallel.make_mesh(4, model=4, rank=1)):
        whole = parallel.put_batch(ptree, parallel.data_sharding(mesh))
        assert torch.equal(whole[0].images, ptree[0].images)
    # an object with .put is called
    mesh = parallel.make_mesh(8, spatial=2, rank=3)
    got = parallel.put_batch(ptree, parallel.batch_sharding(mesh))
    want = parallel.shard_batch(ptree, mesh)
    assert torch.equal(got[0].images, want[0].images)
    assert got[0].images.shape[2] == ptree[0].images.shape[2] // 2
    # a device, as jax.device_put takes one
    meta = parallel.put_batch(ptree, torch.device("meta"))
    assert meta[0].images.is_meta and meta[1].boxes.is_meta
    assert meta[0].images.shape == ptree[0].images.shape
    with pytest.raises(TypeError, match="no placement"):
        parallel.put_batch(ptree, 3)


# -- merge_into (utils/c2_loading.py) --------------------------------------
def test_merge_into_matches_jax():
    """Matching leaves copied (cast to the target's dtype), the rest of
    either tree untouched, the applied paths in the same order; a tensor
    leaf (a state_dict's) written in place; a shape mismatch raises."""
    from da_detect_tpu.utils.c2_loading import merge_into as j_merge_into
    from da_detect_tpu_torch.utils.c2_loading import merge_into

    rng = np.random.RandomState(6)

    def tree():
        return {"a": {"kernel": np.zeros((3, 2), np.float32),
                      "bias": np.zeros(2, np.float32)},
                "b": np.zeros(4, np.float16), "keep": np.ones(1)}
    src = {"a": {"kernel": rng.randn(3, 2), "extra": rng.randn(2)},
           "b": rng.randn(4), "c": {"x": rng.randn(1)}}
    want_t, got_t = tree(), tree()
    want = j_merge_into(want_t, src)
    got = merge_into(got_t, src)
    assert got == want == ["a/kernel", "b"]
    for path in (("a", "kernel"), ("a", "bias"), ("b",), ("keep",)):
        w, g = want_t, got_t
        for k in path:
            w, g = w[k], g[k]
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    state = {"w": torch.zeros(3, 2)}
    alias = state["w"]
    assert merge_into(state, {"w": src["a"]["kernel"]}) == ["w"]
    assert state["w"] is alias
    np.testing.assert_array_equal(alias.numpy(),
                                  src["a"]["kernel"].astype(np.float32))
    for fn, t in ((j_merge_into, tree()), (merge_into, tree())):
        with pytest.raises(ValueError, match="shape mismatch at a/kernel"):
            fn(t, {"a": {"kernel": np.zeros((2, 3))}})
