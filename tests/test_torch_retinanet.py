"""The port's RetinaNet (``models/retinanet.py``, the P6/P7 FPN, the octave
anchors and the focal loss) against the JAX package's, on the same numpy
weights and inputs.

Config: the RetinaNet R-50-FPN YAML narrowed by ``retina_cfgs`` (canvas
64x96, stem 8, res2 16, FPN 16, 5 classes, 8 GT boxes, PRE_NMS_TOP_N 50
and 20 detections so that both selections select), float32, and
``TPU.APPROX_TOPK`` off on the JAX side: its approximate top-k is TPU-only,
the port's is exact.

Tolerances: float32 rtol 1e-5 and atol 1e-5 of the largest magnitude
(float32 sums in another order), losses rtol 1e-5 (1e-4 for a whole
model's) and gradients within 1e-3 of each leaf's largest |g| plus 1e-6 of
the model's largest (``torch_harness.assert_grads_match``); detections as
twins (same label, box within 1e-3 px, score within 1e-5); the top-k's
indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.models import DAState as JDAState
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models import anchors as janchors
from da_detect_tpu.models import retinanet as jret
from da_detect_tpu.models.backbone.fpn import FPN as JFPN
from da_detect_tpu.ops import losses as jlosses
from da_detect_tpu_torch import entry
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.models import anchors as panchors
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.models import retinanet as pret
from da_detect_tpu_torch.models.backbone.fpn import FPN
from da_detect_tpu_torch.ops import box_ops
from da_detect_tpu_torch.ops.losses import sigmoid_focal_loss
from da_detect_tpu_torch.utils.weights import jax_state_dict, \
    load_jax_variables
from tests.torch_harness import (assert_grads_match, assert_losses_match,
                                 assert_twins, module_state, nhwc_to_torch,
                                 port_step_one, random_variables,
                                 torch_to_nhwc)

import __graft_entry__ as graft

CPU = torch.device("cpu")
RETINA_YAML = "configs/retinanet/retinanet_R-50-FPN_1x.yaml"
INFER = dict(pre_nms_thresh=0.05, pre_nms_top_n=50, nms_thresh=0.4,
             detections_per_img=20)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def retina_cfgs(yaml: str = RETINA_YAML):
    """(JAX cfg, port cfg) of a RetinaNet YAML for the CPU."""
    from da_detect_tpu.config import get_cfg as j_get_cfg

    cfgs = []
    for cfg in (j_get_cfg(), get_cfg()):
        cfg.merge_from_file(yaml)
        r = cfg.MODEL.RESNETS
        r.NUM_GROUPS, r.WIDTH_PER_GROUP = (4, 2) if r.NUM_GROUPS > 1 \
            else (1, 8)
        r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS = 8, 16
        cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
        cfg.merge_from_list([
            "MODEL.RETINANET.NUM_CLASSES", 5,
            "MODEL.RETINANET.PRE_NMS_TOP_N", INFER["pre_nms_top_n"],
            "TEST.DETECTIONS_PER_IMG", INFER["detections_per_img"],
            "TPU.IMAGE_SHAPE", (64, 96), "TPU.MAX_GT_BOXES", 8,
            "TPU.COMPUTE_DTYPE", "float32", "TPU.APPROX_TOPK", False])
        cfgs.append(cfg)
    return tuple(cfgs)


def _close(got, want, what: str = "", rtol: float = 1e-5) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------- pieces

def test_focal_loss_matches_jax():
    """Values and gradients of the focal loss over 7 classes, labels 0
    (background), 1..7 and -1 (ignored: no term), gamma 2, alpha 0.25."""
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 40, 7)).astype(np.float32)
    labels = rng.randint(-1, 8, (2, 40))
    assert (labels == -1).any() and (labels == 0).any()
    weights = rng.rand(2, 40).astype(np.float32)

    def jloss(x):
        return jnp.sum(jlosses.sigmoid_focal_loss(x, jnp.asarray(labels))
                       * weights)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    per = sigmoid_focal_loss(x, torch.from_numpy(labels))
    assert tuple(per.shape) == (2, 40)
    np.testing.assert_array_equal(per.detach().numpy()[labels == -1], 0.0)
    got = (per * torch.from_numpy(weights)).sum()
    got.backward()
    _close(got, want)
    _close(x.grad, jgrad)


def test_octave_anchors_match_jax():
    """``retinanet_octave_sizes`` and the generator's per-level anchors
    (3 octave scales x 3 ratios a cell, strides 8 to 128) equal JAX's."""
    jcfg, pcfg = retina_cfgs()
    assert panchors.retinanet_octave_sizes(pcfg) == \
        janchors.retinanet_octave_sizes(jcfg)
    shapes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    jgen = janchors.make_anchor_generator_retinanet(jcfg)
    pgen = panchors.make_anchor_generator_retinanet(pcfg)
    assert pgen.num_anchors_per_location == 9
    for got, want in zip(pgen.anchors_for_shapes(shapes),
                         jgen.anchors_for_shapes(shapes)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_p6p7_fpn_matches_jax():
    """The FPN over C3-C5 with the P6/P7 top block: P6 a stride-2 3x3 conv
    on C5 (JAX's ``p6p7_in_from_c5``, never unset), P7 the same on
    relu(P6); five maps."""
    rng = np.random.RandomState(2)
    chans, hw = (32, 64, 128), ((8, 12), (4, 6), (2, 3))
    feats = [rng.randn(2, h, w, c).astype(np.float32)
             for c, (h, w) in zip(chans, hw)]
    jmod = JFPN(out_channels=16, top_block="p6p7")
    variables = random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), feats)), seed=3)
    want = jmod.apply(variables, feats)
    pmod = FPN(list(chans), 16, top_block="p6p7")
    pmod.load_state_dict(module_state(variables, "backbone/fpn",
                                      "backbone.fpn."))
    assert pmod.fpn_p6.in_channels == chans[-1]
    got = pmod([nhwc_to_torch(f) for f in feats])
    assert len(got) == len(want) == 5
    assert [tuple(g.shape[2:]) for g in got] == \
        [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(torch_to_nhwc(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=f"P{i + 3}")


def _head_outputs(rng, b=2, k=4, a=9, shapes=((8, 12), (4, 6), (2, 3))):
    """Per level NHWC logits [B, H, W, A*K] and deltas [B, H, W, A*4], and
    the anchors of a 64x96 canvas at strides 8, 16 and 32."""
    gen = panchors.AnchorGenerator(((32, 40, 50), (64, 80, 101),
                                    (128, 161, 203)), (0.5, 1.0, 2.0),
                                   (8, 16, 32))
    anchors = gen.anchors_for_shapes(shapes)
    logits = [(2 * rng.randn(b, h, w, a * k) - 2).astype(np.float32)
              for h, w in shapes]
    regs = [(0.3 * rng.randn(b, h, w, a * 4)).astype(np.float32)
            for h, w in shapes]
    return anchors, logits, regs


def _gt(rng, b=2, g=8, hw=(64, 96)):
    xy = rng.uniform(0, (hw[1] - 20, hw[0] - 20), (b, g, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (b, g, 2))],
                           -1).astype(np.float32)
    return boxes, rng.randint(1, 5, (b, g)), rng.rand(b, g) > 0.3


@pytest.mark.parametrize("straddle", [0, -1])
def test_retinanet_loss_matches_jax(straddle):
    """Both losses and their gradients in the logits and the deltas: the
    matcher at 0.5 / 0.4 with low-quality matches, the straddle mask (0:
    anchors past the image ignored; -1: none), the focal loss over
    ``num_pos + B``, smooth-L1 at beta 0.11 over ``num_pos * 4``."""
    rng = np.random.RandomState(4)
    anchors, logits, regs = _head_outputs(rng)
    boxes, labels, valid = _gt(rng)
    anchors = np.concatenate(anchors)
    cls = np.concatenate([x.reshape(2, -1, 4) for x in logits], 1)
    reg = np.concatenate([x.reshape(2, -1, 4) for x in regs], 1)
    sizes = np.tile([[64.0, 96.0]], (2, 1)).astype(np.float32)

    def jloss(c, r):
        lc, lr = jret.retinanet_loss(
            None, jnp.asarray(anchors), c, r, jnp.asarray(boxes),
            jnp.asarray(labels), jnp.asarray(valid), jnp.ones((2,), bool),
            jnp.asarray(sizes), straddle_thresh=straddle)
        return lc + lr, (lc, lr)

    (_, (want_c, want_r)), (gc, gr) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(cls),
                                             jnp.asarray(reg))
    pc = torch.from_numpy(cls).requires_grad_()
    pr = torch.from_numpy(reg).requires_grad_()
    lc, lr = pret.retinanet_loss(
        torch.from_numpy(anchors), pc, pr, torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(sizes), straddle_thresh=straddle)
    (lc + lr).backward()
    assert float(want_r) > 0
    _close(lc, want_c, "cls")
    _close(lr, want_r, "reg")
    _close(pc.grad, gc, "d cls")
    _close(pr.grad, gr, "d reg")


def _jax_inference(anchors, logits, regs, sizes, **kw):
    return jret.retinanet_inference(
        [jnp.asarray(a) for a in anchors], [jnp.asarray(x) for x in logits],
        [jnp.asarray(x) for x in regs], jnp.asarray(sizes),
        approx_topk=False, **kw)


def _port_inference(anchors, logits, regs, sizes, **kw):
    return pret.retinanet_inference(
        [torch.from_numpy(a) for a in anchors],
        [nhwc_to_torch(x) for x in logits], [nhwc_to_torch(x) for x in regs],
        torch.from_numpy(sizes), impl="plain", **kw)


def test_retinanet_inference_matches_jax():
    """Per-level threshold and top-k (exact: APPROX_TOPK False on the JAX
    side), decoding with weights (10, 10, 5, 5), clipping, one class-offset
    NMS an image at IoU 0.4: the same detections."""
    rng = np.random.RandomState(5)
    anchors, logits, regs = _head_outputs(rng)
    sizes = np.tile([[64.0, 96.0]], (2, 1)).astype(np.float32)
    want = _jax_inference(anchors, logits, regs, sizes, **INFER)
    got = _port_inference(anchors, logits, regs, sizes, **INFER)
    assert int(got.valid.sum()) >= 10
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    assert_twins(got, want)


def test_topk_ties_go_to_the_lower_index():
    """The per-level selection is ``lax.top_k``: on scores with many exact
    ties (and scores under the threshold, at -1) each rank takes the same
    (location, class) as JAX's top-k, the lower flat index first; and an
    inference whose scores all tie (constant logits) keeps the same
    candidates as JAX's, exactly."""
    rng = np.random.RandomState(6)
    anchors, logits, regs = _head_outputs(rng)
    k_cls = logits[0].shape[-1] // 9
    logits = [rng.randint(-8, 3, x.shape).astype(np.float32) / 2
              for x in logits]
    logits[0][1] = 0.5  # a whole image tied
    sizes = np.tile([[64.0, 96.0]], (2, 1)).astype(np.float32)
    t_anchors = [torch.from_numpy(a) for a in anchors]
    t_regs = [nhwc_to_torch(x) for x in regs]
    for top_n in (1, 37, 500):
        boxes, scores, classes, _ = pret.retinanet_candidates(
            t_anchors, [nhwc_to_torch(x) for x in logits], t_regs,
            torch.from_numpy(sizes), pre_nms_thresh=0.05,
            pre_nms_top_n=top_n)
        want_boxes, want_scores, want_classes = [], [], []
        for a, x, r in zip(t_anchors, logits, regs):
            flat = jax.nn.sigmoid(jnp.asarray(x)).reshape(2, -1)
            top, idx = jax.lax.top_k(jnp.where(flat > 0.05, flat, -1.0),
                                     min(top_n, flat.shape[1]))
            idx = torch.from_numpy(np.array(idx)).long()
            loc = idx // k_cls
            rows = torch.from_numpy(r).reshape(2, -1, 4)
            want_boxes.append(box_ops.clip_boxes(
                box_ops.decode_boxes(
                    torch.gather(rows, 1, loc[..., None].expand(-1, -1, 4)),
                    a[loc], pret.REG_WEIGHTS), 64.0, 96.0))
            want_scores.append(np.maximum(np.asarray(top), 0.0))
            want_classes.append(idx % k_cls + 1)
        np.testing.assert_array_equal(classes.numpy(),
                                      torch.cat(want_classes, 1).numpy())
        np.testing.assert_array_equal(boxes.numpy(),
                                      torch.cat(want_boxes, 1).numpy())
        np.testing.assert_allclose(scores.numpy(),
                                   np.concatenate(want_scores, 1), rtol=1e-6)
    anchors, logits, regs = _head_outputs(rng)
    logits = [np.full_like(x, 0.3) for x in logits]
    sizes = np.tile([[64.0, 96.0]], (2, 1)).astype(np.float32)
    kw = dict(INFER, nms_thresh=0.99)
    want = _jax_inference(anchors, logits, regs, sizes, **kw)
    got = _port_inference(anchors, logits, regs, sizes, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------- model

def _model_pair(jcfg, pcfg, seed=0):
    jmodel = j_build(jcfg)
    jb, jt = graft._batch(jcfg, 2, seed=seed)
    variables = random_variables(jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jb)), seed=1)
    assert set(variables) == {"params", "frozen"}
    model = build_detection_model(pcfg)
    assert isinstance(model, pret.RetinaNet)
    load_jax_variables(model, variables)
    return jmodel, variables, entry.prepare_model(model, CPU)


def test_eval_forward_matches_jax():
    """The narrowed RetinaNet's eval forward: as many valid detections an
    image, each JAX detection with a twin among the port's."""
    jcfg, pcfg = retina_cfgs()
    jmodel, variables, model = _model_pair(jcfg, pcfg)
    jb, _ = graft._batch(jcfg, 2, seed=3)
    pb, _ = entry.make_batch(pcfg, 2, seed=3)
    want = jax.jit(jmodel.apply)(variables, jb)
    got = model(pb)
    assert int(got.valid.sum()) >= 10
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  np.asarray(want.valid).sum(1))
    assert_twins(got, want)
    with pytest.raises(ValueError, match="mask head"):
        model(pb, with_masks=True)


def test_train_forward_matches_jax():
    """``train_forward`` on 2 images, applied as the JAX package's own
    RetinaNet test applies it (``model.apply(..., method=train_forward)``):
    both losses and every trainable gradient (the frozen stem and res2
    take none), through the port trainer's keywords."""
    jcfg, pcfg = retina_cfgs()
    jmodel, variables, model = _model_pair(jcfg, pcfg)
    jb, jt = graft._batch(jcfg, 2, seed=0)
    pb, pt = entry.make_batch(pcfg, 2, seed=0)

    def loss_fn(params):
        losses, _ = jmodel.apply(
            {"params": params, "frozen": variables["frozen"]}, jb, jt,
            JDAState.create(), method=jmodel.train_forward)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    want = {k: float(v) for k, v in want.items()}
    state = create_train_state(pcfg, model, 0, "multistep")
    losses, grads = port_step_one(model, state, (pb, pt), aligned=False)
    assert set(want) == {"loss_retina_cls", "loss_retina_reg"}
    assert all(v > 0 for v in want.values())
    assert_losses_match(losses, want)
    # the JAX package masks the frozen stages' updates (solver/optim.py);
    # the port gives them no gradient
    jgrads = jax_state_dict({"params": jgrads})
    frozen = {n for n in jgrads if n.startswith(("backbone.body.stem.",
                                                 "backbone.body.layer1."))}
    assert frozen and set(grads) == set(jgrads) - frozen
    assert_grads_match(grads, {n: jgrads[n] for n in grads})


def test_train_step_runs_through_the_trainer():
    """``entry.source_train_entry`` on the narrowed RetinaNet: two steps
    through ``make_train_step`` (the trainer's keywords taken), finite
    losses, the weights move."""
    _, pcfg = retina_cfgs()
    pcfg.SOLVER.IMS_PER_BATCH = 16      # 2 images a card
    step, (state, args) = entry.source_train_entry(device="cpu", cfg=pcfg)
    before = state.model.rpn["head"].cls_logits.weight.detach().clone()
    for _ in range(2):
        state, metrics = step(state, *args)
    assert set(metrics) == {"loss_retina_cls", "loss_retina_reg",
                            "loss_total"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert not torch.equal(before, state.model.rpn["head"].cls_logits.weight)


def test_retinanet_with_da_raises():
    """RetinaNet has no DA heads: with ``DOMAIN_ADAPTATION_ON`` the build
    raises ValueError, as the JAX package's does."""
    _, pcfg = retina_cfgs()
    pcfg.MODEL.DOMAIN_ADAPTATION_ON = True
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_detection_model(pcfg)


def test_retinanet_init_scales():
    """The head's convs normal(0.01), the class logits' bias the prior
    constant -log(99), the other biases 0, the FPN's P6 kaiming-uniform."""
    cfg = entry.retinanet_cfg(dtype="float32")
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    model = build_detection_model(cfg)
    head = model.rpn["head"]
    for conv in (head.cls_tower0, head.bbox_pred, head.cls_logits):
        assert abs(float(conv.weight.detach().std()) / 0.01 - 1) < 0.05
    assert torch.allclose(head.cls_logits.bias.detach(),
                          torch.full_like(head.cls_logits.bias,
                                          -np.log(99.0)))
    assert float(head.bbox_tower3.bias.detach().abs().max()) == 0.0
    p6 = model.backbone.fpn.fpn_p6.weight.detach()
    bound = (3.0 / p6[0].numel()) ** 0.5
    assert float(p6.abs().max()) <= bound and float(p6.std()) > 0.5 * bound
    assert tuple(cfg.TPU.IMAGE_SHAPE) == (800, 1344)
