"""The X-101-32x8d-FPN-DCN model in bfloat16 against the JAX package's
bfloat16 model: the narrowed eval forward (depth 101, both gather modes),
stage by stage, and the narrowed triplet-DA train step (depth 50); and
``load_jax_train_state`` from the bfloat16 JAX model.

Configs as tests/test_torch_slice_dcn.py and tests/test_torch_train_fpn.py,
with ``TPU.COMPUTE_DTYPE "bfloat16"`` on both sides. The RPN logits agree to
a few bfloat16 ulps, and with random weights many anchors score within an
ulp of each other, so the port's own top-k and NMS keep other boxes than
JAX's (a large share of the eval forward's proposals, a few of the train
step's): these tests take JAX's proposals (``JaxProposals``), as the float32
harness takes JAX's random draws, and hold the port's selection itself to
JAX's on JAX's RPN outputs. Tolerances: stages in bfloat16 ulps of the
reference's largest magnitude, stated at each check; the step as
tests/test_torch_bf16_train.py holds the flagship's (``_assert_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.engine.trainer import TrainState as JTrainState
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.solver.optim import make_optimizer as j_make_optimizer
from da_detect_tpu_torch import entry
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.layers import Conv2d, DeformConv2d, Linear
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.utils.weights import (load_jax_train_state,
                                               load_jax_variables)
from tests.test_torch_bf16_train import _assert_step, _set_dtype
from tests.test_torch_slice_dcn import SCALES
from tests.test_torch_slice_dcn import _cfgs as slice_dcn_cfgs
from tests.torch_harness import (JaxProposals, as_f32, assert_ulps,
                                 fpn_train_cfgs, jax_step_one,
                                 jax_train_variables, nhwc_to_torch,
                                 port_step_one, random_variables,
                                 torch_to_nhwc, triplet_batches)

BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dcn_eval_cfgs(gather_mode):
    """The X-101-32x8d-FPN-DCN YAML narrowed as in
    tests/test_torch_slice_dcn.py (depth 101), in bfloat16."""
    return _set_dtype("bfloat16", *slice_dcn_cfgs(gather_mode))


@pytest.mark.parametrize("gather_mode", ["four", "quad"])
def test_dcn_eval_forward_bf16_matches_jax(monkeypatch, gather_mode):
    """The 101-layer FPN-DCN forward in bfloat16, in each gather mode (in
    bfloat16 JAX's two modes round the corner sum differently, so each port
    mode is held against its own), stage by stage on JAX's selections:

    - P2-P6 and the RPN logits and deltas of every level within 8 ulps of
      each one's max (101 bfloat16 layers);
    - the port's proposal selection on JAX's own RPN outputs equals JAX's
      proposals (boxes 1e-3 px, scores 1e-6, validity exactly). On its own
      RPN outputs, a few ulps off JAX's, the port keeps other boxes where
      two anchors' scores are that close (random weights put many within
      an ulp: about 40 of JAX's 96 proposals of this forward), so the rest
      of the forward takes JAX's proposals (``JaxProposals``), as the
      float32 harness takes JAX's random draws;
    - on those proposals, the box head's logits and deltas within 8 ulps;
    - the port's post-processing on JAX's box-head outputs gives what
      JAX's post-processing gives on them, detection for detection (same
      label, boxes 1e-3 px, scores 1e-6; order aside). Not JAX's forward's
      own detections: XLA on the CPU feeds its post-processing the float32
      products before their bfloat16 rounding (excess precision across the
      fusion), a bfloat16 ulp of the logits and deltas off (0.02 px, 3e-5
      here), and where two overlapping boxes of a class score that close
      near 1 the per-class NMS keeps the other one, as the RPN's does.

    And the census: every convolution and linear layer is fed bfloat16
    except each deformable block's conv3, which gets the float32 ``bn2`` of
    the deformable conv's float32 output, as in the JAX package."""
    from da_detect_tpu_torch.models import box_head as tbox
    from da_detect_tpu_torch.models import rpn as trpn

    jcfg, pcfg = _dcn_eval_cfgs(gather_mode)
    jbatch, _ = graft._batch(jcfg, 2, seed=0)
    jmodel = j_build(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jbatch))
    variables = random_variables(shapes, seed=1, scales=SCALES)
    props = JaxProposals()
    props.record(monkeypatch)
    want, inter = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, capture_intermediates=True, mutable=["intermediates"]))(
            variables, jbatch))
    inter = inter["intermediates"]
    j_feats = inter["backbone"]["__call__"][0]
    j_logits, j_deltas = inter["rpn_head"]["__call__"][0]
    j_cls, j_box = inter["predictor"]["__call__"][0]
    props.inject(monkeypatch)

    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = entry.prepare_model(model, torch.device("cpu"))
    batch, _ = entry.make_batch(pcfg, 2, seed=0)
    seen, out = {}, {}

    def keep(key):
        def hook(module, args, output):
            out[key] = output
        return hook

    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: seen.setdefault(name, set()).add(a[0].dtype))
        for name, m in model.named_modules()
        if isinstance(m, (Conv2d, Linear, DeformConv2d))]
    hooks += [model.backbone.register_forward_hook(keep("feats")),
              model.rpn["head"].register_forward_hook(keep("rpn")),
              model.roi_heads["box"]["predictor"].register_forward_hook(
                  keep("box"))]
    model(batch)
    for h in hooks:
        h.remove()

    for i, (g, w) in enumerate(zip(out["feats"], j_feats)):
        assert g.dtype == BF16
        assert_ulps(torch_to_nhwc(g.float()), w, 8, f"P{i + 2}")
    for kind, g_levels, w_levels in zip(("logits", "deltas"), out["rpn"],
                                        (j_logits, j_deltas)):
        for g, w in zip(g_levels, w_levels):
            assert_ulps(torch_to_nhwc(g.float()), w, 8, f"RPN {kind}")

    sizes = batch.sizes.float()
    own = trpn.select_proposals(
        model.anchors(out["feats"]),
        [nhwc_to_torch(as_f32(x)) for x in j_logits],
        [nhwc_to_torch(as_f32(x)) for x in j_deltas], sizes,
        **model.rpn_test, impl="plain")
    boxes, scores, valid = props.calls[0]
    np.testing.assert_array_equal(own.valid.numpy(), valid)
    np.testing.assert_allclose(own.boxes.numpy(), boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(own.scores.numpy(), scores, rtol=0,
                               atol=1e-6)
    lacks, total = props.flips()
    assert 0 < total and lacks < total, (lacks, total)

    assert_ulps(out["box"][0], j_cls, 8, "box logits")
    assert_ulps(out["box"][1], j_box, 8, "box deltas")
    dets = tbox.postprocess_detections(
        torch.from_numpy(as_f32(j_cls)), torch.from_numpy(as_f32(j_box)),
        torch.tensor(boxes), torch.tensor(valid), sizes, **model.post_cfg,
        impl="plain")
    from da_detect_tpu.models import box_head as jbox

    post = {k: v for k, v in model.post_cfg.items()}
    want_dets = jax.device_get(jbox.postprocess_detections(
        jnp.asarray(j_cls), jnp.asarray(j_box), jnp.asarray(boxes),
        jnp.asarray(valid), jnp.asarray(sizes.numpy()), **post))
    assert np.asarray(want.valid).sum(axis=1).min() >= 8
    _assert_same_detections(dets, want_dets)

    dcn_blocks = {name.rsplit(".", 1)[0] for name, m in model.named_modules()
                  if isinstance(m, DeformConv2d)}
    assert len(dcn_blocks) == 30
    float32_fed = {name for name, d in seen.items() if d != {BF16}}
    assert float32_fed == {f"{b}.conv3" for b in dcn_blocks}
    assert all(seen[n] == {torch.float32} for n in float32_fed)


def _assert_same_detections(got, want) -> None:
    """Equal valid counts an image, and each valid detection of ``want``
    has its own twin in ``got``: the same label, boxes within 1e-3 px,
    scores within 1e-6 (order aside: the two softmaxes differ by a float32
    ulp, which can swap neighbours)."""
    for b in range(got.valid.shape[0]):
        gv, wv = got.valid[b].numpy(), np.asarray(want.valid[b])
        assert gv.sum() == wv.sum()
        g_boxes, g_scores = got.boxes[b].numpy()[gv], got.scores[b].numpy()[gv]
        g_labels = got.labels[b].numpy()[gv]
        used = np.zeros(len(g_labels), bool)
        for box, score, label in zip(np.asarray(want.boxes[b])[wv],
                                     np.asarray(want.scores[b])[wv],
                                     np.asarray(want.labels[b])[wv]):
            ok = ((g_labels == label) & ~used
                  & (np.abs(g_boxes - box).max(-1) <= 1e-3)
                  & (np.abs(g_scores - score) <= 1e-6))
            assert ok.any(), (b, label, score, box)
            used[np.flatnonzero(ok)[0]] = True


@pytest.fixture(scope="module")
def dcn_step():
    """The FPN-DCN YAML's triplet step at depth 50
    (``fpn_train_cfgs(..., depth50=True)``, 13 deformable convs, "four"
    gathers): JAX in bfloat16 and float32, one set of numpy variables, and
    the bfloat16 step's proposals (``JaxProposals``)."""
    out = {}
    props = JaxProposals()
    for dtype in ("float32", "bfloat16"):
        jcfg, pcfg = _set_dtype(dtype, *fpn_train_cfgs(entry.DCN_YAML,
                                                       depth50=True))
        jmodel = j_build(jcfg)
        jargs, pargs = triplet_batches(jcfg, pcfg)
        variables = jax_train_variables(jmodel, jargs)
        with pytest.MonkeyPatch.context() as mp:
            if dtype == "bfloat16":
                props.record(mp)
            out[dtype] = jax_step_one(jcfg, jmodel, variables, jargs,
                                      aligned=False, with_state=True)
    return jcfg, pcfg, variables, pargs, out, props


def test_dcn_train_step_bf16_matches_jax(monkeypatch, dcn_step):
    """Losses, the new DAState and every trainable gradient, the
    deformable convs' offset predictors included (their gradients live:
    the offsets move samples about a pixel), with JAX's training proposals
    (source and positive target) injected, as in the eval test."""
    _, pcfg, variables, pargs, want, props = dcn_step
    props.inject(monkeypatch)
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = entry.prepare_model(model, torch.device("cpu"))
    state = create_train_state(pcfg, model, 0, "cosine")
    got = port_step_one(model, state, pargs, aligned=False, with_state=True)
    offsets = [n for n in got[1] if "conv_offset" in n]
    assert len(offsets) == 26 and all(got[1][n].abs().max() > 0
                                      for n in offsets)
    _assert_step(got, want["bfloat16"], want["float32"])
    lacks, total = props.flips()
    assert len(props.own) == 2 and 0 < total and lacks < total, (lacks,
                                                                   total)


def test_load_jax_train_state_bf16(dcn_step):
    """A bfloat16 JAX model's TrainState (float32 params, frozen
    statistics and SGD momentum, as Flax keeps them) into the bfloat16
    port model: the weights, the momentum (twice each parameter), the
    DAState and the step land as float32, and the model still computes
    in bfloat16."""
    jcfg, pcfg, variables = dcn_step[:3]
    tx, _ = j_make_optimizer(jcfg, variables["params"], "cosine")
    opt_state = tx.init(variables["params"])
    momentum = jax.tree_util.tree_map(lambda p: 2.0 * np.asarray(p),
                                      variables["params"])
    jstate = JTrainState(
        step=jnp.asarray(3, jnp.int32), params=variables["params"],
        frozen=variables["frozen"],
        opt_state=(opt_state[0], type(opt_state[1])(momentum=momentum)),
        da_state=JDAState.create(0.5, 1.25), rng=jax.random.PRNGKey(0))
    model = entry.prepare_model(build_detection_model(pcfg),
                                torch.device("cpu"))
    state = create_train_state(pcfg, model, 0, "cosine")
    load_jax_train_state(state, jstate)
    assert state.step == 3 and float(state.da_state.margin_img) == 0.5
    buffers = state.optimizer.momentum_buffers()
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert set(buffers) == set(trainable)
    for name, p in trainable.items():
        assert p.dtype == buffers[name].dtype == torch.float32, name
        torch.testing.assert_close(buffers[name], 2.0 * p.detach(), rtol=0,
                                   atol=0, msg=name)
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert model.rpn["head"].conv.compute_dtype == BF16
