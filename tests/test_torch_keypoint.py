"""The port's Keypoint R-CNN (``models/keypoint_head.py``, the detector's
keypoint paths, the loader's keypoint targets and the COCO OKS protocol)
against the JAX package's, on the same numpy weights and inputs.

Config: the keypoint R-CNN R-50-FPN YAML narrowed by
``tests.torch_harness.keypoint_cfgs`` (canvas 64x96, stem 8, res2 16, FPN
16, MLP head 32, the eight keypoint convs at 16; 8 GT boxes; every
proposal and anchor sampled, so both samplers take the same rows whatever
their draws). GT keypoints are the port's ``entry.synthetic_keypoints``
(17 points inside each box, visibility 0, 1 or 2), handed to both
packages.

Tolerances: float32 modules rtol 1e-5 and atol 1e-5 of the output's
largest magnitude (float32 sums in another order); the predictor's
float32 logits in a bfloat16 model the same, on the same bfloat16-rounded
input; the bfloat16 extractor stage by stage, BF16_STAGE_ULPS bfloat16
ulps of the reference's largest magnitude a stage, each stage fed JAX's
previous output; heatmap targets and the loader's keypoint targets
exactly; decoded keypoints: x and y within 1e-3 px, scores within 1e-5; a
step's losses rtol 1e-4 and every gradient within 1e-3 of its leaf's
largest |g| plus 1e-6 of the model's largest (tests/test_torch_train_fpn.py);
the OKS evaluator's numbers exactly (float64, the same arithmetic).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.data_factory as factory
import tests.test_coco_eval as jax_coco_tests
import tests.test_coco_eval_adversarial as adv
from da_detect_tpu.data import build as j_build
from da_detect_tpu.data.datasets import COCODataset as JCOCODataset
from da_detect_tpu.data.evaluation import coco_eval as j_coco_eval
from da_detect_tpu.models import build_detection_model as j_build_model
from da_detect_tpu.models import keypoint_head as jkh
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.models.poolers import pool_rois as j_pool_rois
from da_detect_tpu.models.poolers import pooler_config as j_pooler_config
from da_detect_tpu_torch import entry, parallel
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.data import build
from da_detect_tpu_torch.data.datasets import COCODataset
from da_detect_tpu_torch.data.evaluation import coco_eval
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.models import detector as pdet
from da_detect_tpu_torch.models import keypoint_head as pkh
from da_detect_tpu_torch.models.box_head import Detections, SampledRois
from da_detect_tpu_torch.models.poolers import pool_rois, pooler_config
from da_detect_tpu_torch.tools import test_net, train_net
from da_detect_tpu_torch.utils.weights import jax_state_dict, \
    load_jax_variables
from tests.test_torch_cli import _opts
from tests.test_torch_data import _cfgs, _drain
from tests.torch_harness import (FPN_SCALES, KEYPOINT_YAMLS,
                                 _narrow_fpn_train, assert_grads_match,
                                 assert_losses_match, assert_twins,
                                 assert_ulps, bf16_numpy, cfg_fc6_chw,
                                 keypoint_batches, keypoint_cfgs,
                                 mask_cfgs,
                                 module_state, nhwc_to_torch, port_step_one,
                                 random_variables, write_user_catalog)

CPU = torch.device("cpu")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_STAGE_ULPS = 4
KP_XY_ATOL, KP_SCORE_ATOL = 1e-3, 1e-5
DET_SCORE_ATOL = 1e-4
# the score layers spread (random-init scores sit within float32 noise of
# each other), the box deltas towards the JAX package's init
SCALES = dict(FPN_SCALES, **{"predictor/cls_score/kernel": 30.0})
LOSSES = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg", "loss_kp"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(jmodel, jargs):
    """numpy variables of the JAX model's source-only training init (the
    keypoint head's included)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jargs[0], jargs[1],
        JDAState.create(), method=jmodel.train_forward))
    return random_variables(shapes, seed=1, scales=SCALES)


def _port_model(pcfg, variables):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    return entry.prepare_model(model, CPU)


def _fpn_inputs(rng, cfg, b=2, r=12, c=16):
    """FPN maps (NHWC, 4 levels of the 64x96 canvas) and ROIs over it."""
    h, w = cfg.TPU.IMAGE_SHAPE
    feats = [rng.randn(b, h // s, w // s, c).astype(np.float32)
             for s in (4, 8, 16, 32)]
    xy = rng.uniform(-4, (w - 8, h - 8), (b, r, 2))
    side = rng.uniform(4, 48, (b, r, 2))
    rois = np.concatenate([xy, xy + side], -1).astype(np.float32)
    return feats, rois


def _to_jax_layout(y: torch.Tensor) -> np.ndarray:
    """[B, R, C, H, W] -> [B, R, H, W, C] float32 numpy."""
    return y.detach().float().permute(0, 1, 3, 4, 2).numpy()


# ---------------------------------------------------------------- modules

def test_kps_score_lowres_weight_carry_flips_the_kernel():
    """Flax's ConvTranspose (4x4, stride 2, padding (1, 1), kernel not
    transposed) maps 14 -> 26 and equals torch's ConvTranspose2d(padding
    2) only with the kernel flipped in both spatial axes: the loader's
    carry matches Flax; the same kernel carried without the flip does
    not."""
    from flax import linen as nn

    rng = np.random.RandomState(0)
    x = rng.randn(3, 14, 14, 6).astype(np.float32)
    layer = nn.ConvTranspose(5, (4, 4), strides=(2, 2),
                             padding=((1, 1), (1, 1)))
    kernel = rng.randn(4, 4, 6, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel,
                                              "bias": bias}}, x))
    assert want.shape == (3, 26, 26, 5)
    state = jax_state_dict({"params": {"keypoint_head": {"predictor": {
        "kps_score_lowres": {"kernel": kernel, "bias": bias}}}}})
    prefix = "roi_heads.keypoint.predictor.kps_score_lowres."
    conv = torch.nn.ConvTranspose2d(6, 5, 4, stride=2, padding=2)
    conv.load_state_dict({"weight": state[prefix + "weight"],
                          "bias": state[prefix + "bias"]})
    got = conv(nhwc_to_torch(x)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1)))
    unflipped = conv(nhwc_to_torch(x)).detach().permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - want).max() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keypoint_predictor_matches_jax(dtype):
    """The predictor on 14 x 14 maps: 52 x 52 heatmaps, float32 logits in
    both dtypes (the bfloat16 model's input rounded to bfloat16, then
    float32, as JAX promotes), to float32 tolerance."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 14, 14, 24).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if dtype == "bfloat16":
        x = bf16_numpy(x)
    jmod = jkh.KeypointRCNNPredictor(num_keypoints=17, dtype=jd)
    jx = jnp.asarray(x, jd)
    variables = random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jx)), seed=2)
    want = np.asarray(jmod.apply(variables, jx))
    assert want.dtype == np.float32 and want.shape == (2, 5, 52, 52, 17)
    pmod = pkh.KeypointRCNNPredictor(24, 17, dtype=pd)
    pmod.load_state_dict(module_state(variables, "keypoint_head/predictor",
                                      "roi_heads.keypoint.predictor."))
    got = pmod(torch.from_numpy(x).permute(0, 1, 4, 2, 3).to(pd))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_to_jax_layout(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_keypoint_predictor_gradients_match_jax():
    """The predictor's input and bias gradients (through the fold's and
    the upsample's fixed-order adjoints, ``upsample2x``) against
    ``jax.grad`` of the same weighted sum, float32, within 1e-5 of the
    largest |gradient|; the upsample's values stay ``F.interpolate``'s."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 14, 14, 24).astype(np.float32)
    g = rng.randn(2, 3, 52, 52, 17).astype(np.float32)
    jmod = jkh.KeypointRCNNPredictor(num_keypoints=17, dtype=jnp.float32)
    variables = random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=4)

    def loss(v, xx):
        return jnp.sum(jmod.apply(v, xx) * g)
    want_v, want_x = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    pmod = pkh.KeypointRCNNPredictor(24, 17)
    pmod.load_state_dict(module_state(variables, "keypoint_head/predictor",
                                      "roi_heads.keypoint.predictor."))
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3).requires_grad_(True)
    y = pmod(xt)
    gx, gb = torch.autograd.grad(
        y, [xt, pmod.kps_score_lowres.bias],
        torch.from_numpy(g).permute(0, 1, 4, 2, 3))
    for got, want in (
            (gx.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want_x)),
            (gb.numpy(), np.asarray(
                want_v["params"]["kps_score_lowres"]["bias"]))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    z = torch.from_numpy(g[0]).requires_grad_(True)
    assert torch.equal(pkh.upsample2x(z), F.interpolate(
        z, scale_factor=2, mode="bilinear", align_corners=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keypoint_extractor_matches_jax(dtype):
    """The extractor (pooler and eight 3x3 convs): float32 to 1e-5;
    bfloat16 stage by stage (the pooled map, then each conv fed JAX's
    previous stage through its ReLU), BF16_STAGE_ULPS each."""
    jcfg, pcfg = keypoint_cfgs(dtype)
    rng = np.random.RandomState(4)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    feats, rois = _fpn_inputs(rng, pcfg)
    if dtype == "bfloat16":
        feats = [bf16_numpy(f) for f in feats]
    layers = tuple(pcfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS)
    jmod = jkh.KeypointRCNNFeatureExtractor(
        pooler=j_pooler_config(jcfg, "ROI_KEYPOINT_HEAD"), layers=layers,
        dtype=jd)
    jargs = ([jnp.asarray(f, jd) for f in feats], jnp.asarray(rois))
    variables = random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *jargs)), seed=5)
    pmod = pkh.KeypointRCNNFeatureExtractor(
        pooler_config(pcfg, "ROI_KEYPOINT_HEAD"), 16, layers, dtype=pd)
    pmod.load_state_dict(module_state(
        variables, "keypoint_head/extractor",
        "roi_heads.keypoint.feature_extractor."))
    pfeats = [nhwc_to_torch(f).to(pd) for f in feats]
    want, inter = jmod.apply(variables, *jargs, capture_intermediates=True,
                             mutable=["intermediates"])
    got = pmod(pfeats, torch.from_numpy(rois), impl="plain")
    assert tuple(got.shape) == (2, 12, 16, 14, 14)
    if dtype == "float32":
        want = np.asarray(want)
        np.testing.assert_allclose(_to_jax_layout(got), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
        return
    assert got.dtype == torch.bfloat16
    pooled = j_pool_rois(jargs[0], jargs[1],
                         **j_pooler_config(jcfg, "ROI_KEYPOINT_HEAD"))
    x = pool_rois(pfeats, torch.from_numpy(rois), **pmod.pooler,
                  impl="plain")
    assert_ulps(_to_jax_layout(x), pooled, BF16_STAGE_ULPS, "pooled")
    prev = np.asarray(pooled.reshape((-1,) + pooled.shape[2:])
                      .astype(jnp.float32))
    for i in range(1, pmod.num_layers + 1):
        name = f"conv_fcn{i}"
        ref = np.asarray(inter["intermediates"][name]["__call__"][0]
                         .astype(jnp.float32))
        src = torch.from_numpy(prev.copy()).permute(0, 3, 1, 2)
        out = getattr(pmod, name)(src.to(torch.bfloat16))
        assert_ulps(out.detach().float().permute(0, 2, 3, 1), ref,
                    BF16_STAGE_ULPS, name)
        prev = np.maximum(ref, 0.0)


def _head_pair(jcfg, pcfg, seed):
    """(JAX keypoint head, its numpy variables, the port's head with them)
    at the narrowed widths, on maps of 16 channels."""
    jhead = jkh.make_keypoint_head(jcfg, jnp.float32)
    rng = np.random.RandomState(seed)
    feats, rois = _fpn_inputs(rng, pcfg)
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats],
        jnp.asarray(rois)))
    variables = random_variables(shapes, seed=seed + 1)
    head = pkh.make_keypoint_head(pcfg, 16)
    head.load_state_dict(module_state(variables, "keypoint_head",
                                      "roi_heads.keypoint."))
    return jhead, variables, head, feats, rois


def test_keypoint_head_matches_jax():
    """The whole head (pooler, convs, predictor) in float32: 52 x 52
    logits a keypoint."""
    jcfg, pcfg = keypoint_cfgs()
    jhead, variables, head, feats, rois = _head_pair(jcfg, pcfg, 6)
    want = np.asarray(jhead.apply(variables, [jnp.asarray(f) for f in feats],
                                  jnp.asarray(rois)))
    got = head([nhwc_to_torch(f) for f in feats], torch.from_numpy(rois),
               impl="plain")
    assert tuple(got.shape) == (2, 12, 17, 52, 52)
    np.testing.assert_allclose(_to_jax_layout(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_keypoints_to_heatmap_targets_match_jax():
    """Cells and validity exactly: keypoints inside, off and on the far
    edge of their ROI (out of bounds), invisible ones, degenerate ROIs."""
    rng = np.random.RandomState(7)
    r, k, hm = 64, 17, 52
    lo = rng.uniform(0, 100, (r, 2))
    rois = np.concatenate([lo, lo + rng.uniform(1, 80, (r, 2))],
                          1).astype(np.float32)
    rois[:3, 2:] = rois[:3, :2]                    # zero-size ROIs
    t = rng.uniform(-0.2, 1.2, (r, k, 2))
    xy = rois[:, None, :2] + t * (rois[:, None, 2:] - rois[:, None, :2])
    xy[:, 0] = rois[:, None, 2:][:, 0]             # the far corner
    xy[:, 1, 0] = rois[:, 2]                       # the far x edge
    vis = rng.randint(0, 3, (r, k)).astype(np.float32)
    kps = np.concatenate([xy, vis[..., None]], -1).astype(np.float32)
    wpos, wvalid = jkh.keypoints_to_heatmap_targets(jnp.asarray(kps),
                                                    jnp.asarray(rois), hm)
    pos, valid = pkh.keypoints_to_heatmap_targets(torch.from_numpy(kps),
                                                  torch.from_numpy(rois), hm)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    # the far corner is out of bounds (but in a zero-size ROI's cell 0)
    assert not valid[3:, 0].any() and not valid[3:, 1].any()
    assert not valid[vis == 0].any()
    assert 0.3 < float(valid.float().mean()) < 0.7


def test_keypoint_rcnn_loss_matches_jax():
    """The loss on JAX's own sampled ROIs (its subsample of random
    proposals around the GT): the value and its gradients to the head's
    weights and the FPN maps."""
    from da_detect_tpu.models import box_head as j_box_head

    jcfg, pcfg = keypoint_cfgs()
    (jb, jt), (_, pt) = keypoint_batches(jcfg, pcfg)
    jhead, variables, head, feats, _ = _head_pair(jcfg, pcfg, 8)
    rng = np.random.RandomState(9)
    props = np.concatenate([np.asarray(jt.boxes)
                            + rng.uniform(-6, 6, (2, 8, 4)),
                            _fpn_inputs(rng, pcfg, r=40)[1]],
                           1).astype(np.float32)
    sampled = j_box_head.subsample_proposals(
        jax.random.PRNGKey(0), jnp.asarray(props),
        jnp.ones(props.shape[:2], bool), jt.boxes, jt.labels, jt.valid,
        jnp.ones((2,), bool), fg_iou=0.5, bg_iou=0.5, batch_per_image=32,
        positive_fraction=0.5, reg_weights=(10.0, 10.0, 5.0, 5.0))
    assert int((np.asarray(sampled.labels) > 0).sum()) >= 4
    jfeats = [jnp.asarray(f) for f in feats]

    def jloss(params, fs):
        return jhead.apply({"params": params}, method=lambda mod:
                           jkh.keypoint_rcnn_loss(mod, fs, sampled,
                                                  jt.keypoints, jt))

    want, (wg, wf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        variables["params"], jfeats)
    pfeats = [nhwc_to_torch(f).requires_grad_() for f in feats]
    psampled = SampledRois(*(torch.from_numpy(np.array(x)) for x in sampled))
    psampled = psampled._replace(labels=psampled.labels.long())
    got = pkh.keypoint_rcnn_loss(head, pfeats, psampled, pt.keypoints, pt,
                                 impl="plain")
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = {f"roi_heads.keypoint.{n}": p.grad
             for n, p in head.named_parameters()}
    want_grads = jax_state_dict({"params": {"keypoint_head": wg}})
    # a softmax is blind to a shift of its logits: the heatmap bias's exact
    # gradient is 0, and both sides give rounding noise, held to 1e-5 of
    # the weight's gradient instead
    bias = "roi_heads.keypoint.predictor.kps_score_lowres.bias"
    scale = float(want_grads[bias.replace("bias", "weight")].abs().max())
    for g in (grads.pop(bias), want_grads.pop(bias)):
        assert float(g.abs().max()) <= 1e-5 * scale
    assert_grads_match(grads, want_grads)
    for f, w in zip(pfeats, wf):
        np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_heatmaps_to_keypoints_matches_jax():
    """Decoding: the argmax cell (the first on a tie: the heatmaps are
    quantized so that ties are common), its centre in the ROI, and its
    softmax probability."""
    rng = np.random.RandomState(10)
    r, k, hm = 40, 17, 52
    heat = np.round(rng.randn(r, hm, hm, k) * 2).astype(np.float32)
    lo = rng.uniform(0, 100, (r, 2))
    rois = np.concatenate([lo, lo + rng.uniform(0, 80, (r, 2))],
                          1).astype(np.float32)
    want = np.asarray(jkh.heatmaps_to_keypoints(jnp.asarray(heat),
                                                jnp.asarray(rois)))
    got = pkh.heatmaps_to_keypoints(
        torch.from_numpy(heat).permute(0, 3, 1, 2), torch.from_numpy(rois))
    flat = heat.reshape(r, -1, k)
    assert ((flat == flat.max(1, keepdims=True)).sum(1) > 1).mean() > 0.5
    np.testing.assert_allclose(got[..., :2].numpy(), want[..., :2],
                               rtol=0, atol=KP_XY_ATOL)
    np.testing.assert_allclose(got[..., 2].numpy(), want[..., 2], rtol=0,
                               atol=KP_SCORE_ATOL)


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def jax_model():
    """The narrowed keypoint model's JAX side: cfgs, model, the 2-image
    batches with GT keypoints and the numpy variables. The box head's NMS
    at IoU 0.9 (eval only) keeps enough detections on the small canvas for
    the keypoint head to run over."""
    jcfg, pcfg = keypoint_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.MODEL.ROI_HEADS.NMS = 0.9
    jmodel = j_build_model(jcfg)
    (jb, jt), (pb, pt) = keypoint_batches(jcfg, pcfg)
    return dict(jcfg=jcfg, pcfg=pcfg, jmodel=jmodel, jargs=(jb, jt),
                pargs=(pb, pt), variables=_variables(jmodel, (jb, jt)))


def test_eval_forward_matches_jax(jax_model, monkeypatch):
    """The narrowed YAML's eval forward with keypoints: the port's own
    detections twins of JAX's (boxes within 1e-3 px, scores within
    DET_SCORE_ATOL: the class logits' x 30 spread turns float32 rounding
    of the pooled features into about 1e-5 of a mid-range score);
    then the keypoint head over JAX's detections: keypoints [B, D, 17, 3]
    on the valid slots, x and y within KP_XY_ATOL, scores within
    KP_SCORE_ATOL."""
    jmodel, variables = jax_model["jmodel"], jax_model["variables"]
    jb = jax_model["jargs"][0]
    jdets, jkps = jax.jit(lambda v, b: jmodel.apply(
        v, b, with_keypoints=True))(variables, jb)
    valid = np.asarray(jdets.valid)
    assert valid.sum() >= 4
    model = _port_model(jax_model["pcfg"], variables)
    pb = jax_model["pargs"][0]
    own, _ = model(pb, with_keypoints=True)
    assert_twins(own, jdets, score_atol=DET_SCORE_ATOL)
    dets = Detections(*(torch.from_numpy(np.array(x)) for x in jdets))
    dets = dets._replace(labels=dets.labels.long())
    monkeypatch.setattr(pdet, "postprocess_detections",
                        lambda *a, **k: dets)
    _, kps = model(pb, with_keypoints=True)
    assert kps.dtype == torch.float32
    assert tuple(kps.shape) == valid.shape + (17, 3)
    got, want = kps.numpy()[valid], np.asarray(jkps)[valid]
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=KP_XY_ATOL)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0,
                               atol=KP_SCORE_ATOL)


def test_source_only_step_matches_jax(jax_model):
    """One source-only step of the narrowed keypoint model on 2 images with
    GT keypoints: every loss (``loss_kp`` included) and every trainable
    gradient, the keypoint head's too."""
    jmodel, variables = jax_model["jmodel"], jax_model["variables"]
    jb, jt = jax_model["jargs"]
    jcfg, pcfg = jax_model["jcfg"], jax_model["pcfg"]

    def loss_fn(params):
        losses, _ = jmodel.apply(
            {"params": params, "frozen": variables["frozen"]}, jb, jt,
            JDAState.create(), method=jmodel.train_forward,
            deterministic=True, rngs={"sampling": jax.random.PRNGKey(3)})
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want = {k: float(v) for k, v in want.items()}
    jgrads = jax_state_dict({"params": jgrads}, cfg_fc6_chw(jcfg))
    model = _port_model(pcfg, variables)
    state = create_train_state(pcfg, model, 0, "multistep")
    losses, grads = port_step_one(model, state, jax_model["pargs"],
                                  aligned=False)
    assert set(want) == LOSSES and want["loss_kp"] > 0
    assert_losses_match(losses, want)
    kp_grads = [n for n in grads if n.startswith("roi_heads.keypoint.")]
    assert len(kp_grads) == 18
    assert all(grads[n].abs().max() > 0 for n in kp_grads)
    assert_grads_match(grads, jgrads)


def test_da_step_leaves_the_keypoint_head_out():
    """A triplet-DA step of a ``KEYPOINT_ON`` model on batches without GT
    keypoints (the DA loaders'): no ``loss_kp``, the keypoint head takes
    no gradient, and DDP leaves it out of the reduction in the DA modes
    only."""
    cfg = get_cfg()
    cfg.merge_from_file(entry.DCN_YAML.replace("X_101_32x8d_FPN_dcn",
                                               "R_50_FPN"))
    _narrow_fpn_train(cfg, "four")
    cfg.MODEL.KEYPOINT_ON = True
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (16,) * 8
    model = entry.prepare_model(build_detection_model(cfg), CPU)
    state = create_train_state(cfg, model)
    args = entry.triplet_batches(cfg, 1)
    assert args[1].keypoints is None
    losses, _ = model.train_forward(args[0], args[1], state.da_state,
                                    *args[2:], deterministic=True,
                                    generator=state.generator)
    assert "loss_kp" not in losses
    sum(losses.values()).backward()
    kp = {f"roi_heads.keypoint.{n}": p
          for n, p in model.keypoint_head.named_parameters()}
    assert kp and all(p.grad is None for p in kp.values())
    assert set(kp) <= set(parallel.unused_parameters(model, "da_triplet"))
    assert not set(kp) & set(parallel.unused_parameters(model,
                                                        "source_only"))


@pytest.mark.parametrize("yaml", KEYPOINT_YAMLS)
def test_keypoint_yaml_builds(yaml):
    """Every ``KEYPOINT_ON`` YAML builds (narrowed) with the keypoint head
    its keys name: the pooler at P 14, sampling 2, over P2-P5, eight convs
    and 17 heatmaps of 52 x 52."""
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    assert cfg.MODEL.KEYPOINT_ON
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS = 8, 8, 16
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (16,) * 8
    head = build_detection_model(cfg).keypoint_head
    ext = head.feature_extractor
    assert ext.pooler["output_size"] == 14 and ext.num_layers == 8
    assert ext.pooler["sampling_ratio"] == 2 and len(ext.pooler["scales"]) \
        == 4
    x = torch.zeros(1, 3, 16, 14, 14)
    assert tuple(head.predictor(x).shape) == (1, 3, 17, 52, 52)


def test_keypoint_head_init_is_kaiming_fan_out():
    """The keypoint head's convs drawn normal with std sqrt(2 / Flax's
    fan-out), biases 0: 512 x 9 for conv_fcn*, 16 x 17 for the transposed
    kps_score_lowres (its kernel [4, 4, 512, 17] in Flax)."""
    cfg = entry.keypoint_cfg(dtype="float32")
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS = 8, 8, 16
    head = build_detection_model(cfg).keypoint_head
    convs = pkh.keypoint_layers(head)
    assert [type(c).__name__ for c in convs] == \
        ["Conv2d"] * 8 + ["FoldedConvTranspose2d"]
    for conv, fan_out in zip(convs, [512 * 9] * 8 + [16 * 17]):
        std = float(conv.weight.detach().std())
        assert abs(std / (2.0 / fan_out) ** 0.5 - 1) < 0.05, (conv, std)
        assert float(conv.bias.detach().abs().max()) == 0.0


def test_with_keypoints_needs_a_keypoint_head():
    """``forward(with_keypoints=True)`` on a model without a keypoint head
    raises; with a mask head too, ``with_masks`` takes precedence, as in
    the JAX package."""
    jcfg, pcfg = keypoint_cfgs()
    pcfg.MODEL.KEYPOINT_ON = False
    model = build_detection_model(pcfg)
    batch, _ = entry.make_batch(pcfg, 1)
    with pytest.raises(ValueError, match="keypoint head"):
        model(batch, with_keypoints=True)
    _, pcfg = mask_cfgs()
    pcfg.MODEL.KEYPOINT_ON = True
    pcfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (16,) * 8
    pcfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES = \
        pcfg.MODEL.ROI_MASK_HEAD.POOLER_SCALES
    model = build_detection_model(pcfg)
    batch, _ = entry.make_batch(pcfg, 1)
    dets, probs = model(batch, with_masks=True, with_keypoints=True)
    assert probs.dim() == 4 and tuple(probs.shape[2:]) == (28, 28)


# ---------------------------------------------------------------- loader

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree with every third keypoint invisible and every fifth
    labelled but not visible (v = 1), registered in both catalogs."""
    root = tmp_path_factory.mktemp("kp_tree")
    dirs = factory.make_triplet_datasets(str(root))
    ann = dirs["clean"][1]
    with open(ann) as f:
        coco = json.load(f)
    for a in coco["annotations"]:
        kps = np.asarray(a["keypoints"]).reshape(-1, 3)
        kps[::3] = 0.0
        kps[1::5, 2] = 1.0
        a["keypoints"] = kps.ravel().tolist()
        a["num_keypoints"] = int((kps[:, 2] > 0).sum())
    with open(ann, "w") as f:
        json.dump(coco, f)
    factory.register_tiny_catalog(dirs)
    from tests.torch_harness import register_port_tiny_catalog

    with pytest.MonkeyPatch.context() as mp:
        register_port_tiny_catalog(dirs, mp)
        yield dirs


@pytest.mark.parametrize("hflip", [False, True], ids=["drawn", "flipped"])
def test_loader_keypoint_targets_match_jax(tree, hflip):
    """A train epoch with keypoints (flips drawn at 0.5 from the same seed,
    or every image flipped): every batch's GT keypoints equal the JAX
    loader's bit for bit ([G, 17, 3]: scaled, mirrored with the person-17
    pairs swapped, invisible rows 0, padding 0)."""
    jcfg, pcfg = _cfgs()
    want = list(j_build.make_data_loader(jcfg, is_train=True, seed=5,
                                         infinite=False, with_keypoints=True,
                                         hflip=hflip)[0])
    got = _drain(build.make_data_loader(pcfg, is_train=True, device=CPU,
                                        seed=5, infinite=False,
                                        with_keypoints=True,
                                        hflip=hflip)[0])
    assert len(got) == len(want) > 1
    for (_, gt), (_, wt) in zip(got, want):
        assert gt.keypoints.dtype == torch.float32
        assert tuple(gt.keypoints.shape[-2:]) == (17, 3)
        np.testing.assert_array_equal(gt.keypoints.numpy(),
                                      np.asarray(wt.keypoints))
        kps = gt.keypoints.numpy()
        assert (kps[~gt.valid.numpy()] == 0).all()
        assert (kps[..., 2] == 1).any() and (kps[gt.valid.numpy()][..., 2]
                                             == 0).any()
    plain = _drain(build.make_data_loader(pcfg, is_train=True, device=CPU,
                                          seed=5, infinite=False)[0])
    assert plain[0][1].keypoints is None


# ---------------------------------------------------------------- OKS

class _Both:
    """A CocoEvaluator that runs the port's and the JAX package's on the
    same dataset and predictions, requires them equal, and returns the
    port's."""

    def __init__(self, dataset, iou_type="bbox"):
        self.got = coco_eval.CocoEvaluator(dataset, iou_type)
        self.want = j_coco_eval.CocoEvaluator(dataset, iou_type)

    def evaluate(self, predictions):
        got = self.got.evaluate(predictions)
        assert got == self.want.evaluate(predictions)
        return got


@pytest.fixture(scope="module")
def kp_datasets(tmp_path_factory):
    """``tests/test_coco_eval.py``'s dataset (6 images of the tiny tree):
    (the port's COCODataset, the JAX package's) of the same file."""
    root = tmp_path_factory.mktemp("kp_eval")
    img_dir, ann = factory.make_triplet_datasets(str(root),
                                                 n_images=6)["clean"]
    return (COCODataset(ann, img_dir, False),
            JCOCODataset(ann, img_dir,
                         remove_images_without_annotations=False))


@pytest.mark.parametrize("case", ["test_perfect_keypoints_oks_ap",
                                  "test_jittered_keypoints_oks_degrades"])
def test_oks_cases_through_the_port(case, kp_datasets, monkeypatch):
    """The JAX package's OKS cases on its tiny dataset, each evaluation run
    by the port's evaluator (held to the case's numbers) and equal to the
    JAX package's."""
    monkeypatch.setattr(jax_coco_tests, "CocoEvaluator", _Both)
    getattr(jax_coco_tests, case)(kp_datasets[1])


@pytest.mark.parametrize("case", [
    "test_oks_zero_keypoint_gt_is_ignore_with_box_fallback",
    "test_oks_det_area_comes_from_keypoint_extents"])
def test_adversarial_oks_case_through_the_port(case, monkeypatch):
    """The JAX package's hand-derived OKS cases, through the port's
    evaluator and equal to the JAX package's."""
    def both(dataset, preds, iou_type="bbox"):
        return _Both(dataset, iou_type).evaluate(preds)[0]

    monkeypatch.setattr(adv, "ev", both)
    getattr(adv, case)()


def test_oks_results_on_the_port_dataset_equal_jax(kp_datasets):
    """The port's COCODataset under jittered keypoints and a false positive
    an image: the same OKS numbers as the JAX package's evaluator on its
    own dataset of the same file."""
    pds, jds = kp_datasets
    preds = jax_coco_tests.kp_predictions(jds, jitter=3.0, seed=4)
    rng = np.random.RandomState(5)
    for p in preds.values():
        fp = rng.uniform(0, 100, (1, 17, 3)).astype(np.float32)
        p["keypoints"] = np.concatenate([p["keypoints"], fp])
        p["boxes"] = np.concatenate([p["boxes"], p["boxes"][:1]])
        p["scores"] = np.concatenate([p["scores"], [0.95]])
        p["labels"] = np.concatenate([p["labels"], [1]])
    got = coco_eval.CocoEvaluator(pds, "keypoints").evaluate(preds)
    assert got == j_coco_eval.CocoEvaluator(jds, "keypoints").evaluate(preds)
    assert set(got[0]) == {"AP", "AP50", "AP75", "APm", "APl", "AR20",
                           "ARm", "ARl"}
    assert 0.0 < got[0]["AP"] < got[0]["AP50"] <= 1.0


# ---------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny triple (17 keypoints a box), its names in a user catalog
    JSON under $DA_DETECT_DATA_DIR."""
    root = str(tmp_path_factory.mktemp("tiny_kp_cli"))
    dirs = factory.make_triplet_datasets(root)
    write_user_catalog(dirs, root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DA_DETECT_DATA_DIR", root)
        yield dirs


def test_train_net_keypoint_then_test_net_keypoints(tiny, tmp_path):
    """The keypoint YAML (narrowed: FPN 16, MLP head 32, keypoint convs
    16; random weights, no ImageNet file): ``train_net`` source-only for 2
    steps (its loader carries the GT keypoints, ``loss_kp`` is logged),
    then ``test_net`` reports bbox and keypoints (OKS) AP, and writes
    them."""
    out = tmp_path / "out_kp"
    narrow = ["MODEL.WEIGHT", "", "MODEL.BACKBONE.OUT_CHANNELS", "16",
              "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "32",
              "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", str((16,) * 8),
              "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "64",
              "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "64",
              "TPU.APPROX_TOPK", "False"]
    opts = (["--config-file", KEYPOINT_YAMLS[0], "--device", "cpu"]
            + _opts(out) + narrow)
    state, meters = train_net.main(["--skip-test"] + opts)
    assert state.step == 2 and state.model.keypoint_head is not None
    assert np.isfinite(meters.meters["loss_kp"].global_avg)
    assert meters.meters["loss_kp"].global_avg > 0
    run_dir = out / "run"
    results = test_net.main(["--ckpt", str(run_dir)] + opts)
    res = results["tiny_foggy_cocostyle"]
    assert set(res) == {"bbox", "keypoints"}
    assert {"AP", "AR20", "ARl"} <= set(res["keypoints"])
    assert all(-1.0 <= v <= 1.0 for k, v in res["keypoints"].items()
               if k != "per_category")
    with open(run_dir / "coco_results.json") as f:
        assert "keypoints" in json.load(f)
