"""The port's Mask R-CNN (``models/mask_head.py`` and the detector's mask
paths) against the JAX package's, on the same numpy weights and inputs.

Configs: the Cityscapes R-50-FPN mask YAML, the R-50-C4 mask YAML (the
res5 box extractor shared, ``SHARE_BOX_FEATURE_EXTRACTOR``) and the
GroupNorm R-50-FPN mask YAML, narrowed by ``tests.torch_harness.mask_cfgs``
(canvas 64x96, stem 8, res2 16, FPN 16, MLP head 32, mask convs 16; the GN
model at 32 channels; 8 GT boxes; every proposal and anchor sampled, so
both samplers take the same rows whatever their draws). GT masks are the
port's ``entry.synthetic_masks`` (ellipses in their boxes' frames), handed
to both packages.

Tolerances: float32 modules rtol 1e-5 and atol 1e-5 of the output's
largest magnitude (float32 sums in another order; GroupNorm's variance as
E[x^2] - E[x]^2 in Flax, by Welford's sums here), 1e-5 elsewhere; a
step's losses rtol 1e-4 and every gradient within 1e-3 of its leaf's
largest |g| plus 1e-6 of the model's largest, as
tests/test_torch_train_fpn.py; bfloat16 stage by stage in bfloat16 ulps
of the reference's largest magnitude (``torch_harness.bf16_ulp``):
BF16_STAGE_ULPS a stage, each stage fed JAX's previous output; the C4
predictor's float32 logits in a bfloat16 model at float32 tolerance.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.models import box_head as j_box_head
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models import mask_head as jmh
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.models.poolers import pool_rois as j_pool_rois
from da_detect_tpu.models.poolers import pooler_config as j_pooler_config
from da_detect_tpu_torch import entry, parallel
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.models import detector as pdet
from da_detect_tpu_torch.models import mask_head as pmh
from da_detect_tpu_torch.models.box_head import Detections, SampledRois
from da_detect_tpu_torch.models.poolers import pooler_config
from da_detect_tpu_torch.utils.weights import jax_state_dict, \
    load_jax_variables
from tests.torch_harness import (FPN_SCALES, MASK_C4_YAML, MASK_GN_YAML,
                                 _narrow_fpn_train, assert_grads_match,
                                 assert_losses_match, assert_ulps,
                                 bf16_numpy, cfg_fc6_chw, mask_batches,
                                 mask_cfgs, module_state, nhwc_to_torch,
                                 port_step_one, random_variables)

CPU = torch.device("cpu")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_STAGE_ULPS = 4
# project_gt_masks' bilinear weights come from sample coordinates up to 111
# that XLA and PyTorch round apart by an ulp or two (about 1e-5): 1e-4 in
# the [0, 1] mask values
PROJECT_ATOL = 1e-4
# the score layers spread (random-init scores sit within float32 noise of
# each other), the box deltas towards the JAX package's init
SCALES = dict(FPN_SCALES, **{"predictor/cls_score/kernel": 30.0})
LOSSES = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg", "loss_mask"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _variables(jmodel, jargs):
    """numpy variables of the JAX model's source-only training init (the
    mask head's included)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jargs[0], jargs[1],
        JDAState.create(), method=jmodel.train_forward))
    return random_variables(shapes, seed=1, scales=SCALES)


def _port_model(pcfg, variables):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    return entry.prepare_model(model, CPU)


# ---------------------------------------------------------------- weights

def test_conv5_mask_weight_carry_flips_the_kernel():
    """Flax's ConvTranspose (2x2, stride 2, SAME, kernel not transposed)
    equals torch's ConvTranspose2d only with the kernel flipped in both
    spatial axes: the loader's carry matches Flax; the same kernel carried
    without the flip does not."""
    from flax import linen as nn

    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 7, 6).astype(np.float32)
    layer = nn.ConvTranspose(4, (2, 2), strides=(2, 2))
    kernel = rng.randn(2, 2, 6, 4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel,
                                              "bias": bias}}, x))
    state = jax_state_dict({"params": {"mask_head": {"predictor": {
        "conv5_mask": {"kernel": kernel, "bias": bias}}}}})
    conv = torch.nn.ConvTranspose2d(6, 4, 2, stride=2)
    conv.load_state_dict({
        "weight": state["roi_heads.mask.predictor.conv5_mask.weight"],
        "bias": state["roi_heads.mask.predictor.conv5_mask.bias"]})
    got = conv(nhwc_to_torch(x)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1)))
    unflipped = conv(nhwc_to_torch(x)).detach().permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - want).max() > 0.1


# ---------------------------------------------------------------- modules

def _fpn_inputs(rng, cfg, b=2, r=12, c=16):
    """FPN maps (NHWC, 4 levels of the 64x96 canvas) and ROIs over it."""
    h, w = cfg.TPU.IMAGE_SHAPE
    feats = [rng.randn(b, h // s, w // s, c).astype(np.float32)
             for s in (4, 8, 16, 32)]
    xy = rng.uniform(-4, (w - 8, h - 8), (b, r, 2))
    side = rng.uniform(4, 48, (b, r, 2))
    rois = np.concatenate([xy, xy + side], -1).astype(np.float32)
    return feats, rois


def _module_pair(kind, jcfg, pcfg, dtype):
    """(JAX module, port module, JAX input args, port input args) of one
    mask-head module at the narrowed widths."""
    rng = np.random.RandomState(3)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    h = pcfg.MODEL.ROI_MASK_HEAD
    c = pcfg.MODEL.BACKBONE.OUT_CHANNELS
    if kind.startswith("extractor"):
        feats, rois = _fpn_inputs(rng, pcfg, c=c)
        feats = [bf16_numpy(f) if dtype == "bfloat16" else f for f in feats]
        jmod = jmh.MaskRCNNFPNFeatureExtractor(
            pooler=j_pooler_config(jcfg, "ROI_MASK_HEAD"),
            layers=tuple(h.CONV_LAYERS), use_gn=h.USE_GN, dtype=jd)
        pmod = pmh.MaskRCNNFPNFeatureExtractor(
            pooler_config(pcfg, "ROI_MASK_HEAD"), c,
            layers=tuple(h.CONV_LAYERS), use_gn=h.USE_GN, dtype=pd)
        return (jmod, pmod,
                ([jnp.asarray(f, jd) for f in feats], jnp.asarray(rois)),
                ([nhwc_to_torch(f).to(pd) for f in feats],
                 torch.from_numpy(rois)))
    x = rng.randn(2, 5, 7, 7, 24).astype(np.float32)
    if dtype == "bfloat16":
        x = bf16_numpy(x)
    if kind == "predictor_c4":
        jmod = jmh.MaskRCNNC4Predictor(num_classes=9, dim_reduced=16,
                                       dtype=jd)
        pmod = pmh.MaskRCNNC4Predictor(24, 9, 16, dtype=pd)
    else:
        jmod = jmh.MaskRCNNConv1x1Predictor(num_classes=9, dtype=jd)
        pmod = pmh.MaskRCNNConv1x1Predictor(24, 9, dtype=pd)
    px = torch.from_numpy(x).permute(0, 1, 4, 2, 3).to(pd)
    return jmod, pmod, (jnp.asarray(x, jd),), (px,)


def _to_jax_layout(y: torch.Tensor) -> np.ndarray:
    """[B, R, C, H, W] -> [B, R, H, W, C] float32 numpy."""
    return y.detach().float().permute(0, 1, 3, 4, 2).numpy()


KINDS = ["extractor", "extractor_gn", "predictor_c4", "predictor_1x1"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_mask_module_matches_jax(kind, dtype):
    """Each module on the same weights and inputs: float32 to 1e-5; the C4
    predictor in bfloat16 to 1e-5 too (it rounds its input to bfloat16 and
    computes in float32, as JAX's, whose Flax convs have no dtype: float32
    logits); the other bfloat16 modules stage by stage (the pooled map,
    then each conv and GroupNorm fed JAX's previous stage),
    BF16_STAGE_ULPS each, and the module's output."""
    jcfg, pcfg = mask_cfgs(MASK_GN_YAML if kind == "extractor_gn" else None,
                           dtype)
    jmod, pmod, jargs, pargs = _module_pair(kind, jcfg, pcfg, dtype)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs))
    variables = random_variables(shapes, seed=2)
    pmod.load_state_dict(module_state(variables, "mask_head/extractor",
                                      "roi_heads.mask.feature_extractor.")
                         if kind.startswith("extractor") else
                         module_state(variables, "mask_head/predictor",
                                      "roi_heads.mask.predictor."))
    want, inter = jmod.apply(variables, *jargs, capture_intermediates=True,
                             mutable=["intermediates"])
    got = pmod(*pargs, impl="plain") if kind.startswith("extractor") \
        else pmod(*pargs)
    if dtype == "float32" or kind == "predictor_c4":
        want = np.asarray(want)
        assert want.dtype == np.float32 and got.dtype == torch.float32
        np.testing.assert_allclose(_to_jax_layout(got), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
        return
    # GroupNorm's output, and the 1x1 predictor's (its Flax conv has no
    # dtype and promotes to its float32 kernel), are float32
    assert got.dtype == (torch.float32
                         if kind in ("extractor_gn", "predictor_1x1")
                         else torch.bfloat16)
    assert_ulps(_to_jax_layout(got), want, 2 * BF16_STAGE_ULPS, kind)
    inter = inter["intermediates"]
    if kind.startswith("extractor"):
        pooled = j_pool_rois(jargs[0], jargs[1],
                             **j_pooler_config(jcfg, "ROI_MASK_HEAD"))
        from da_detect_tpu_torch.models.poolers import pool_rois

        x = pool_rois(pargs[0], pargs[1], **pmod.pooler, impl="plain")
        assert_ulps(_to_jax_layout(x), pooled, BF16_STAGE_ULPS, "pooled")
        prev = np.asarray(pooled.reshape((-1,) + pooled.shape[2:])
                          .astype(jnp.float32))
        for i in range(1, pmod.num_layers + 1):
            names = [f"mask_fcn{i}"] + ([f"mask_fcn{i}_gn"] if pmod.use_gn
                                        else [])
            for name in names:
                ref = np.asarray(inter[name]["__call__"][0]
                                 .astype(jnp.float32))
                src = torch.from_numpy(prev.copy()).permute(0, 3, 1, 2)
                out = getattr(pmod, name)(src.to(
                    torch.float32 if name.endswith("_gn")
                    else torch.bfloat16))
                assert_ulps(out.detach().float().permute(0, 2, 3, 1),
                            ref, BF16_STAGE_ULPS, name)
                prev = ref
            prev = np.maximum(prev, 0.0)


def test_project_gt_masks_matches_jax():
    """GT masks resampled into proposal frames: boxes inside, across and
    off the GT box, degenerate GT boxes; values within PROJECT_ATOL and the
    targets (> 0.5) the same."""
    rng = np.random.RandomState(4)
    n, m = 64, entry.MASK_RESOLUTION
    masks = entry.synthetic_masks(rng, 1, n, m)[0]
    gb = np.concatenate([rng.uniform(0, 60, (n, 2)),
                         rng.uniform(60, 120, (n, 2))], 1).astype(np.float32)
    gb[:4, 2:] = gb[:4, :2]                        # zero-size GT boxes
    shift = rng.uniform(-30, 30, (n, 4)).astype(np.float32)
    pb = np.where(rng.rand(n, 1) < 0.3, gb, gb + shift).astype(np.float32)
    want = np.asarray(jmh.project_gt_masks(jnp.asarray(masks),
                                           jnp.asarray(gb), jnp.asarray(pb),
                                           28))
    got = pmh.project_gt_masks(torch.from_numpy(masks), torch.from_numpy(gb),
                               torch.from_numpy(pb), 28).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PROJECT_ATOL)
    np.testing.assert_array_equal(got > 0.5, want > 0.5)
    assert 0 < (want > 0.5).mean() < 1


def test_mask_rcnn_loss_matches_jax():
    """The loss on JAX's own sampled ROIs (its subsample of random
    proposals): the value and its gradients to the head's weights and the
    FPN maps."""
    jcfg, pcfg = mask_cfgs()
    rng = np.random.RandomState(5)
    (jb, jt), (_, pt) = mask_batches(jcfg, pcfg)
    feats, _ = _fpn_inputs(rng, pcfg)
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
    jhead = jmh.make_mask_head(jcfg, jnp.float32)
    jfeats = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), jfeats, sampled.rois))
    variables = random_variables(shapes, seed=6)

    def jloss(params, fs):
        return jhead.apply({"params": params}, method=lambda mod:
                           jmh.mask_rcnn_loss(mod, fs, sampled, jt))

    want, (wg, wf) = jax.value_and_grad(jloss, argnums=(0, 1))(
        variables["params"], jfeats)
    head = pmh.make_mask_head(pcfg, 16, None)
    head.load_state_dict(module_state(variables, "mask_head", "roi_heads."
                                      "mask."))
    pfeats = [nhwc_to_torch(f).requires_grad_() for f in feats]
    psampled = SampledRois(*(torch.from_numpy(np.array(x)) for x in sampled))
    psampled = psampled._replace(labels=psampled.labels.long())
    got = pmh.mask_rcnn_loss(head, pfeats, psampled, pt, impl="plain")
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = {f"roi_heads.mask.{n}": p.grad for n, p in head.named_parameters()}
    assert_grads_match(grads, jax_state_dict({"params": {"mask_head": wg}}))
    for f, w in zip(pfeats, wf):
        np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("yaml", [None, MASK_C4_YAML],
                         ids=["R_50_FPN", "R_50_C4"])
def test_source_only_step_matches_jax(yaml):
    """One source-only step of the narrowed mask model on 2 images with GT
    masks: every loss (``loss_mask`` included) and every trainable
    gradient, the mask head's too."""
    jcfg, pcfg = mask_cfgs(yaml)
    jmodel = j_build(jcfg)
    (jb, jt), (pb, pt) = mask_batches(jcfg, pcfg)
    variables = _variables(jmodel, (jb, jt))

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
    losses, grads = port_step_one(model, state, (pb, pt), aligned=False)
    assert set(want) == LOSSES and want["loss_mask"] > 0
    assert_losses_match(losses, want)
    mask_grads = [n for n in grads if n.startswith("roi_heads.mask.")]
    assert mask_grads and all(grads[n].abs().max() > 0 for n in mask_grads)
    assert_grads_match(grads, jgrads)


def _jax_dets_into_port(jdets, monkeypatch):
    """The port's detector post-processing replaced by JAX's detections."""
    dets = Detections(*(torch.from_numpy(np.array(x)) for x in jdets))
    dets = dets._replace(labels=dets.labels.long())
    monkeypatch.setattr(pdet, "postprocess_detections",
                        lambda *a, **k: dets)


@pytest.mark.parametrize("yaml,dtype", [(None, "float32"),
                                        (None, "bfloat16"),
                                        (MASK_C4_YAML, "float32")],
                         ids=["R_50_FPN", "R_50_FPN_bf16", "R_50_C4"])
def test_eval_mask_probs_on_jax_detections(yaml, dtype, monkeypatch):
    """The eval forward with masks: the head over JAX's own final
    detections (a bfloat16 near-tie may flip a detection), probabilities
    [B, D, 28 or 14, same] compared on the valid slots, float32 to 1e-5,
    bfloat16 within BF16_STAGE_ULPS of 1.0; in float32 the port's own
    detections equal JAX's too."""
    jcfg, pcfg = mask_cfgs(yaml, dtype)
    jmodel = j_build(jcfg)
    (jb, jt), (pb, _) = mask_batches(jcfg, pcfg, seed=7)
    variables = _variables(jmodel, (jb, jt))
    jdets, jprobs = jax.jit(lambda v, b: jmodel.apply(v, b, with_masks=True)
                            )(variables, jb)
    valid = np.asarray(jdets.valid)
    assert valid.sum() >= 4
    model = _port_model(pcfg, variables)
    if dtype == "float32":
        own, _ = model(pb, with_masks=True)
        np.testing.assert_array_equal(own.valid.numpy(), valid)
        np.testing.assert_allclose(own.boxes.numpy(), np.asarray(jdets.boxes),
                                   rtol=1e-5, atol=1e-3)
    _jax_dets_into_port(jdets, monkeypatch)
    dets, probs = model(pb, with_masks=True)
    side = 2 * pcfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION \
        if yaml is None else 14
    assert probs.dtype == torch.float32
    assert tuple(probs.shape) == valid.shape + (side, side)
    got, want = probs.numpy()[valid], np.asarray(jprobs)[valid]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_STAGE_ULPS * 2.0 ** -7
    assert 0.01 < want.mean() < 0.99


def test_da_step_leaves_the_mask_head_out():
    """A triplet-DA step of a ``MASK_ON`` model on batches without GT
    masks (the DA loaders'): ``loss_mask`` is 0, the mask head takes no
    gradient, and DDP leaves it out of the reduction in the DA modes
    only."""
    cfg = get_cfg()
    cfg.merge_from_file(entry.DCN_YAML.replace("X_101_32x8d_FPN_dcn",
                                               "R_50_FPN"))
    _narrow_fpn_train(cfg, "four")
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (16,) * 4
    model = entry.prepare_model(build_detection_model(cfg), CPU)
    state = create_train_state(cfg, model)
    args = entry.triplet_batches(cfg, 1)
    assert args[1].masks is None
    losses, _ = model.train_forward(args[0], args[1], state.da_state,
                                    *args[2:], deterministic=True,
                                    generator=state.generator)
    assert float(losses["loss_mask"]) == 0.0
    sum(losses.values()).backward()
    mask = {f"roi_heads.mask.{n}": p
            for n, p in model.mask_head.named_parameters()}
    assert mask and all(p.grad is None for p in mask.values())
    assert set(mask) <= set(parallel.unused_parameters(model, "da_triplet"))
    assert not set(mask) & set(parallel.unused_parameters(model,
                                                          "source_only"))


MASK_YAMLS = sorted(f for f in glob.glob("configs/**/*.yaml", recursive=True)
                    if "MASK_ON: True" in open(f).read())


@pytest.mark.parametrize("yaml", MASK_YAMLS)
def test_mask_yaml_builds(yaml):
    """Every ``MASK_ON`` YAML of the repository builds, narrowed, with the
    mask head its keys name (shared res5 features, the FPN conv stack with
    GroupNorm under USE_GN, or FBNet's mask stage with the 1x1
    predictor)."""
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    r = cfg.MODEL.RESNETS
    r.NUM_GROUPS, r.WIDTH_PER_GROUP = (4, 8) if r.NUM_GROUPS > 1 else (1, 32)
    r.STEM_OUT_CHANNELS = r.RES2_OUT_CHANNELS = 32
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 32
    cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 32
    cfg.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 32
    cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (32,) * 4
    h = cfg.MODEL.ROI_MASK_HEAD
    if cfg.MODEL.BACKBONE.CONV_BODY == "FBNet":
        from da_detect_tpu_torch.models.backbone.fbnet import FBNetRoIHead

        assert h.FEATURE_EXTRACTOR == "FBNet.roi_head_mask"
        head = build_detection_model(cfg).mask_head
        assert isinstance(head.feature_extractor, FBNetRoIHead)
        assert isinstance(head.predictor, pmh.MaskRCNNConv1x1Predictor)
        assert head.feature_extractor.pooler["output_size"] == \
            h.POOLER_RESOLUTION
        return
    head = build_detection_model(cfg).mask_head
    assert isinstance(head.predictor, pmh.MaskRCNNC4Predictor)
    if h.SHARE_BOX_FEATURE_EXTRACTOR:
        assert head.feature_extractor is None
    else:
        ext = head.feature_extractor
        assert isinstance(ext, pmh.MaskRCNNFPNFeatureExtractor)
        assert ext.use_gn == h.USE_GN
        assert ext.pooler["output_size"] == h.POOLER_RESOLUTION


def test_mask_head_init_is_kaiming_fan_out():
    """The mask head's convs drawn normal with std sqrt(2 / fan-out), as
    the JAX package's initializer, biases 0; at the YAML's widths."""
    cfg = entry.mask_cfg(dtype="float32")
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS = 8, 8, 16
    head = build_detection_model(cfg).mask_head
    convs = pmh.mask_layers(head)
    assert [type(c).__name__ for c in convs] == \
        ["Conv2d"] * 4 + ["ConvTranspose2d", "Conv2d"]
    for conv, fan_out in zip(convs, [256 * 9] * 4 + [256 * 4, 9]):
        std = float(conv.weight.detach().std())
        assert abs(std / (2.0 / fan_out) ** 0.5 - 1) < 0.05, (conv, std)
        assert float(conv.bias.detach().abs().max()) == 0.0


def test_with_masks_needs_a_mask_head():
    """``forward(with_masks=True)`` on a model without a mask head raises,
    so its return type always follows the flag."""
    cfg = entry.mask_cfg(dtype="float32")
    cfg.MODEL.MASK_ON = False
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS = 8, 8, 16
    model = build_detection_model(cfg)
    assert model.mask_head is None
    batch, _ = entry.make_batch(cfg, 1)
    with pytest.raises(ValueError, match="mask head"):
        model(batch, with_masks=True)
