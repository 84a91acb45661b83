"""The port's FBNet bodies and heads (``models/backbone/fbnet.py`` and the
FBNet paths of the detector) against the JAX package's, on the same numpy
weights and inputs.

Configs: the FBNet YAMLs narrowed by ``fbnet_cfgs`` (canvas 64x96, every
size even so that Flax's asymmetric stride-2 SAME padding shows; widths at
``FBNET.SCALE_FACTOR`` 0.5; 9 classes; every anchor and proposal sampled, so
both samplers take the same rows whatever their draws). BatchNorm statistics
are drawn too (means normal(0.1), variances uniform(0.5, 1.5)), so the
folded affine is exercised, not the identity.

Tolerances: float32 modules rtol 1e-5 and atol 1e-5 of the output's largest
magnitude (float32 sums in another order), detections' boxes atol 1e-3 px;
a step's losses rtol 1e-4 and every gradient within 1e-3 of its leaf's
largest |g| plus 1e-6 of the model's largest
(``torch_harness.assert_grads_match``).
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models.backbone import fbnet as jfb
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu_torch import entry
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.layers import BatchNorm
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.models.backbone import fbnet as pfb
from da_detect_tpu_torch.utils.weights import jax_state_dict, \
    load_jax_variables
from tests.torch_harness import (_narrow_fpn_train, assert_grads_match,
                                 assert_losses_match, assert_twins,
                                 mask_batches,
                                 module_state, nhwc_to_torch, port_step_one,
                                 random_variables, torch_to_nhwc)

CPU = torch.device("cpu")
F32_TOL = dict(rtol=1e-5)
FBNET_YAMLS = sorted(glob.glob("configs/e2e_*fbnet*.yaml"))
FASTER_YAML = "configs/e2e_faster_rcnn_fbnet.yaml"
CHAM_YAML = "configs/e2e_faster_rcnn_fbnet_chamv1a_600.yaml"
MASK_YAML = "configs/e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml"
# the RPN's objectness and the box head's class scores spread (random-init
# scores sit within float32 noise of each other), the box deltas towards
# the JAX package's init
SCALES = {"rpn_head_module/cls_logits/kernel": 30.0,
          "rpn_head_module/bbox_pred/kernel": 0.03,
          "predictor/cls_score/kernel": 30.0,
          "predictor/bbox_pred/kernel": 0.1}
ARCHS = ["default", "xirb16d_dsmask", "mobilenet_v2", "cham_v1a", "cham_v2"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fbnet_variables(shapes, seed: int, scales=None) -> dict:
    """``random_variables`` with the BatchNorm variances drawn positive,
    uniform(0.5, 1.5)."""
    rng = np.random.RandomState(seed + 100)
    tree = random_variables(shapes, seed, scales)

    def var(path, v):
        if str(getattr(path[-1], "key", path[-1])) != "var":
            return v
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(var, tree)


def _close(got: torch.Tensor, want, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(torch_to_nhwc(got.float()), want,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what, **F32_TOL)


def fbnet_cfgs(yaml: str = MASK_YAML, dtype: str = "float32"):
    """(JAX cfg, port cfg) of an FBNet YAML for the CPU:
    ``_narrow_fpn_train``'s canvas and budgets (64x96, 8 GT boxes, every
    anchor and proposal sampled), widths at SCALE_FACTOR 0.5, 9 classes, no
    DA heads, computing in ``dtype``."""
    from da_detect_tpu.config import get_cfg as j_get_cfg

    cfgs = []
    for cfg in (j_get_cfg(), get_cfg()):
        cfg.merge_from_file(yaml)
        _narrow_fpn_train(cfg, "four")
        cfg.MODEL.FBNET.SCALE_FACTOR = 0.5
        cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 9
        cfg.MODEL.DOMAIN_ADAPTATION_ON = False
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfgs.append(cfg)
    return tuple(cfgs)


# ---------------------------------------------------------------- blocks

# (stride, kernel, expansion, dw_skip_bn, dw_skip_relu, in, out)
MBCONV_CASES = [
    (1, 3, 1, True, True, 8, 8),      # expansion 1, residual
    (1, 5, 6, False, False, 8, 8),    # dw BN and ReLU on, residual
    (1, 7, 6, True, True, 8, 16),     # no residual: widths differ
    (2, 3, 6, True, True, 8, 16),
    (2, 5, 1, False, True, 8, 8),     # stride 2 at equal widths: no add
    (2, 7, 6, True, False, 16, 8),
    (-2, 3, 3, True, True, 8, 8),     # upsampling
    (-2, 5, 6, False, False, 16, 8),
]


def _mbconv_pair(stride, k, t, skip_bn, skip_relu, cin, cout):
    x = np.random.RandomState(5).randn(2, 10, 14, cin).astype(np.float32)
    jmod = jfb.MBConv(features=cout, expansion=t, stride=stride, kernel=k,
                      dw_skip_bn=skip_bn, dw_skip_relu=skip_relu)
    variables = fbnet_variables(
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x)), seed=2)
    pmod = pfb.MBConv(cin, cout, t, stride, k, skip_bn, skip_relu)
    pmod.load_state_dict(module_state(variables, "backbone/stages/block0",
                                      "backbone.stages.0."))
    return jmod, variables, pmod, x


@pytest.mark.parametrize("case", MBCONV_CASES,
                         ids=[f"s{c[0]}_k{c[1]}_t{c[2]}_bn{int(not c[3])}"
                              f"_relu{int(not c[4])}_{c[5]}to{c[6]}"
                              for c in MBCONV_CASES])
def test_mbconv_matches_jax(case):
    """One block at stride 1, 2 and -2, kernels 3/5/7, expansion 1 and
    more, the depthwise BN and ReLU on and off, on a 10x14 map (even sides:
    the stride-2 SAME padding is asymmetric there)."""
    jmod, variables, pmod, x = _mbconv_pair(*case)
    want = jmod.apply(variables, x)
    got = pmod(nhwc_to_torch(x))
    assert got.dtype == torch.float32
    _close(got, want, str(case))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_symmetric_padding_differs_from_jax(k):
    """The same stride-2 block with ``nn.Conv2d(padding=k // 2)``'s
    symmetric padding in its depthwise conv gives the same shape and other
    values: the asymmetric SAME padding is what makes the block match."""
    jmod, variables, pmod, x = _mbconv_pair(2, k, 6, True, True, 8, 16)
    want = np.asarray(jmod.apply(variables, x))
    dw = pmod.dw
    with torch.no_grad():
        h = F.relu(pmod.pw_bn(pmod.pw(nhwc_to_torch(x))))
        sym = pmod.pwl_bn(pmod.pwl(F.conv2d(h, dw.weight, None, 2, k // 2,
                                            1, dw.groups)))
    assert tuple(sym.shape) == (2, 16) + want.shape[1:3]
    assert np.abs(torch_to_nhwc(sym) - want).max() > \
        0.1 * np.abs(want).max()


def test_same_pad_is_flax_same():
    """``same_pad`` + an unpadded conv equals Flax's ``padding="SAME"`` at
    strides 1 and 2, kernels 3/5/7, on even and odd sides."""
    from flax import linen as nn

    rng = np.random.RandomState(1)
    for k in (3, 5, 7):
        for s in (1, 2):
            for hw in ((8, 12), (9, 13)):
                x = rng.randn(1, *hw, 4).astype(np.float32)
                w = rng.randn(k, k, 4, 3).astype(np.float32)
                want = nn.Conv(3, (k, k), strides=(s, s), padding="SAME",
                               use_bias=False).apply(
                    {"params": {"kernel": w}}, x)
                got = F.conv2d(pfb.same_pad(nhwc_to_torch(x), k, s),
                               torch.from_numpy(w.transpose(3, 2, 0, 1)),
                               stride=s)
                _close(got, want, f"k{k} s{s} {hw}")


def test_nearest_upsample_is_jax_resize():
    """``F.interpolate(mode="nearest")`` at factor 2 equals
    ``jax.image.resize(..., "nearest")`` bit for bit (the mask stage's -2
    strides, 6 -> 12)."""
    x = np.random.RandomState(0).randn(3, 6, 6, 5).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (3, 12, 12, 5), "nearest"))
    got = F.interpolate(nhwc_to_torch(x), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(torch_to_nhwc(got), want)


def test_batchnorm_matches_flax_and_outputs_float32():
    """``layers.BatchNorm`` equals Flax's inference BatchNorm on drawn
    statistics, and returns float32 on a bfloat16 input (Flax's
    promotion), the float32 BatchNorm of the bfloat16 values."""
    from flax import linen as nn

    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                    "bias": rng.randn(6).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(6).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    jbn = nn.BatchNorm(use_running_average=True)
    bn = BatchNorm(6)
    bn.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                        "bias": torch.from_numpy(v["params"]["bias"]),
                        "running_mean": torch.from_numpy(
                            v["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(
                            v["batch_stats"]["var"])})
    _close(bn(nhwc_to_torch(x)), jbn.apply(v, x))
    xb = nhwc_to_torch(x).to(torch.bfloat16)
    want = jbn.apply(v, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.float32
    got = bn(xb)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, bn(xb.float()), rtol=0, atol=0)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_matches_jax(arch):
    """The trunk of each arch at its full widths (WIDTH_DIVISOR 8) on a
    64x96 image: one stride-16 map, float32."""
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.FBNET.ARCH", arch,
                         "MODEL.FBNET.WIDTH_DIVISOR", 8,
                         "TPU.COMPUTE_DTYPE", "float32"])
    x = np.random.RandomState(4).randn(1, 64, 96, 3).astype(np.float32)
    arch_d = jfb._ARCHS[arch]
    jmod = jfb.FBNetTrunk(arch=arch_d, divisor=8)
    variables = fbnet_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), x)), seed=3)
    trunk, out_ch = pfb.build_fbnet_backbone(cfg, torch.float32)
    trunk.load_state_dict(module_state(variables, "backbone", "backbone."))
    want = jmod.apply(variables, x)[0]
    got = trunk(nhwc_to_torch(x), impl="plain")
    assert len(got) == 1 and got[0].shape[1] == out_ch == want.shape[-1]
    assert tuple(got[0].shape[2:]) == (4, 6)
    _close(got[0], want, arch)


@pytest.mark.parametrize("kind", ["rpn", "roi_head", "mask_extractor"])
def test_head_matches_jax(kind):
    """The FBNet RPN head (logits and deltas), box head ([B, R, C, 3, 3]
    from ROIs pooled at P 6) and mask extractor ([B, R, C, 12, 12]: 6 -> 3
    -> 6 -> 12) of the xirb16d_dsmask arch on a stride-16 map."""
    from da_detect_tpu.models.poolers import pooler_config as j_pooler

    jcfg, pcfg = fbnet_cfgs()
    rng = np.random.RandomState(6)
    c = pfb._Opts(pcfg, torch.float32).out_channels("backbone")
    feat = rng.randn(2, 4, 6, c).astype(np.float32)
    xy = rng.uniform(-4, (88, 56), (2, 10, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 48, (2, 10, 2))],
                          -1).astype(np.float32)
    f = jcfg.MODEL.FBNET
    common = dict(arch=jfb._ARCHS[f.ARCH], scale=f.SCALE_FACTOR,
                  divisor=f.WIDTH_DIVISOR)
    if kind == "rpn":
        jmod = jfb.FBNetRPNHead(num_anchors=15, **common)
        jargs = ([jnp.asarray(feat)],)
        pmod = pfb.make_fbnet_rpn_head(pcfg, c, 15, torch.float32)
        prefix = ("rpn_head_module", "rpn.head.")
    elif kind == "roi_head":
        jmod = jfb.FBNetRoIHead(pooler=j_pooler(jcfg, "ROI_BOX_HEAD"),
                                **common)
        jargs = ([jnp.asarray(feat)], jnp.asarray(rois))
        pmod, _ = pfb.make_fbnet_roi_head(pcfg, c, torch.float32)
        prefix = ("feature_extractor", "roi_heads.box.feature_extractor.")
    else:
        jmod = jfb.FBNetMaskFeatureExtractor(
            pooler=j_pooler(jcfg, "ROI_MASK_HEAD"), **common)
        jargs = ([jnp.asarray(feat)], jnp.asarray(rois))
        pmod, _ = pfb.make_fbnet_mask_extractor(pcfg, c, torch.float32)
        prefix = ("mask_head/extractor", "roi_heads.mask.feature_extractor.")
    variables = fbnet_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *jargs)), seed=4)
    pmod.load_state_dict(module_state(variables, *prefix))
    want = jmod.apply(variables, *jargs)
    if kind == "rpn":
        got = pmod([nhwc_to_torch(feat)])
        for g, w in zip(got, want):
            _close(g[0], w[0], kind)
        return
    got = pmod([nhwc_to_torch(feat)], torch.from_numpy(rois), impl="plain")
    side = 3 if kind == "roi_head" else 12
    assert tuple(got.shape[3:]) == (side, side)
    _close(got.reshape((-1,) + got.shape[2:]),
           np.asarray(want).reshape((-1,) + want.shape[2:]), kind)


# ---------------------------------------------------------------- models

def _variables(jmodel, jargs, with_targets=True):
    """numpy variables (params and batch_stats) of the JAX model's
    source-only training init, the mask head's included."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jargs[0], jargs[1],
        JDAState.create(), method=jmodel.train_forward))
    assert set(shapes) == {"params", "batch_stats"}
    return fbnet_variables(shapes, seed=1, scales=SCALES)


def _port_model(pcfg, variables):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    return entry.prepare_model(model, CPU)


@pytest.mark.parametrize("yaml", [FASTER_YAML, MASK_YAML, CHAM_YAML],
                         ids=["faster_default", "mask_xirb16d",
                              "faster_chamv1a"])
def test_eval_forward_matches_jax(yaml):
    """The eval forward of the narrowed model: as many valid detections an
    image, each JAX detection with a twin among the port's (same label,
    box within 1e-3 px, score within 1e-5: ``assert_twins``); the mask
    model's mask probabilities [B, 100, 12, 12] on the valid detections to
    1e-5 (here the order is JAX's own)."""
    jcfg, pcfg = fbnet_cfgs(yaml)
    jmodel = j_build(jcfg)
    (jb, jt), (pb, _) = mask_batches(jcfg, pcfg, seed=7)
    variables = _variables(jmodel, (jb, jt))
    masks = pcfg.MODEL.MASK_ON
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, with_masks=masks))(
        variables, jb)
    jdets, jprobs = jout if masks else (jout, None)
    valid = np.asarray(jdets.valid)
    assert valid.sum() >= 4
    model = _port_model(pcfg, variables)
    out = model(pb, with_masks=masks)
    dets, probs = out if masks else (out, None)
    np.testing.assert_array_equal(dets.valid.sum(1).numpy(), valid.sum(1))
    assert_twins(dets, jdets)
    if masks:
        assert tuple(probs.shape) == valid.shape + (12, 12)
        want = np.asarray(jprobs)[valid]
        np.testing.assert_allclose(probs.numpy()[valid], want, rtol=1e-5,
                                   atol=1e-5)
        assert 0.01 < want.mean() < 0.99


@pytest.mark.parametrize("yaml", [FASTER_YAML, MASK_YAML, CHAM_YAML],
                         ids=["faster_default", "mask_xirb16d",
                              "faster_chamv1a"])
def test_source_only_step_matches_jax(yaml):
    """One source-only step on 2 images (GT masks for the mask model):
    every loss and every trainable gradient against ``jax.value_and_grad``
    of JAX's ``train_forward`` applied to ``{"params", "batch_stats"}``
    (the statistics fixed, no gradient). Nothing of an FBNet body is frozen
    (FREEZE_CONV_BODY_AT names ResNet stages only)."""
    jcfg, pcfg = fbnet_cfgs(yaml)
    jmodel = j_build(jcfg)
    (jb, jt), (pb, pt) = mask_batches(jcfg, pcfg)
    variables = _variables(jmodel, (jb, jt))

    def loss_fn(params):
        losses, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            jt, JDAState.create(), method=jmodel.train_forward,
            deterministic=True, rngs={"sampling": jax.random.PRNGKey(3)})
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want = {k: float(v) for k, v in want.items()}
    jgrads = jax_state_dict({"params": jgrads})
    model = _port_model(pcfg, variables)
    assert all(p.requires_grad for p in model.parameters())
    state = create_train_state(pcfg, model, 0, "multistep")
    losses, grads = port_step_one(model, state, (pb, pt), aligned=False)
    assert set(grads) == set(jgrads)
    assert want["loss_classifier"] > 0 and want.get("loss_mask", 1) > 0
    assert_losses_match(losses, want)
    assert_grads_match(grads, jgrads)


def test_bf16_model_batchnorm_outputs_float32():
    """In the bfloat16 model every BatchNorm returns float32 (Flax's
    promotion), so the trunk's map, the pooled ROIs and the heads' block
    outputs are float32, while every conv computes in bfloat16 and the
    RPN's logits come out in it."""
    _, pcfg = fbnet_cfgs(MASK_YAML, "bfloat16")
    model = entry.prepare_model(build_detection_model(pcfg), CPU)
    seen = {"bn": set(), "conv": set()}

    def hook(kind):
        return lambda mod, inp, out: seen[kind].add(out.dtype)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(hook("bn"))
        elif type(m).__name__ == "Conv2d" and hasattr(m, "compute_dtype"):
            assert m.compute_dtype == torch.bfloat16
            m.register_forward_hook(hook("conv"))
    batch, _ = entry.make_batch(pcfg, 1)
    dets, probs = model(batch, with_masks=True)
    assert seen == {"bn": {torch.float32}, "conv": {torch.bfloat16}}
    feats = model.backbone(batch.normalized(
        model.pixel_mean, model.pixel_std, model.to_bgr255), impl="plain")
    assert feats[0].dtype == torch.float32
    assert probs.dtype == torch.float32 and torch.isfinite(probs).all()


def test_load_jax_variables_takes_batch_stats():
    """``load_jax_variables`` carries ``batch_stats`` into the BatchNorm
    buffers (``mean`` -> ``running_mean``, ``var`` -> ``running_var``) and
    the state dict round-trips; a key the port lacks, in any collection,
    raises, and so does a model entry left unset."""
    jcfg, pcfg = fbnet_cfgs(FASTER_YAML)
    jmodel = j_build(jcfg)
    jb, jt = mask_batches(jcfg, pcfg)[0]
    variables = _variables(jmodel, (jb, jt))
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    state = model.state_dict()
    stats = variables["batch_stats"]["backbone"]["first_bn"]
    np.testing.assert_array_equal(
        state["backbone.first_bn.running_mean"].numpy(), stats["mean"])
    np.testing.assert_array_equal(
        state["backbone.first_bn.running_var"].numpy(), stats["var"])
    want = jax_state_dict(variables)
    assert set(want) == set(state)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    with pytest.raises(KeyError, match="no counterpart|no port counterpart"):
        load_jax_variables(model, dict(variables, batch_stats=dict(
            variables["batch_stats"], backbone=dict(
                variables["batch_stats"]["backbone"],
                first_bn=dict(stats, momentum=stats["mean"])))))
    with pytest.raises(KeyError, match="no port counterpart"):
        load_jax_variables(model, dict(variables, batch_stats={
            "backbone": {"first_bn": {}, "extra_bn": {
                "mean": stats["mean"]}}}))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_variables(model, {"params": variables["params"]})


def test_fbnet_init_scales():
    """``init_parameters`` on an FBNet model: the blocks' convs and the RPN
    head's 1x1 convs lecun-normal (std 1/sqrt(fan_in)), the RPN biases 0,
    BatchNorm scale 1, bias 0, mean 0, variance 1; the mask predictor
    kaiming fan-out; at the YAML's widths."""
    cfg = entry.fbnet_cfg(MASK_YAML, dtype="float32")
    model = build_detection_model(cfg)
    pw = model.backbone.stages[3].pw.weight
    dw = model.backbone.stages[3].dw.weight
    for w in (pw, dw, model.rpn["head"].cls_logits.weight):
        std = float(w.detach().std())
        assert abs(std * w[0].numel() ** 0.5 - 1) < 0.15, (w.shape, std)
    assert float(model.rpn["head"].bbox_pred.bias.detach().abs().max()) == 0
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert bns and all(
        bool((m.weight == 1).all() and (m.bias == 0).all()
             and (m.running_mean == 0).all() and (m.running_var == 1).all())
        for m in bns)
    logits = model.mask_head.predictor.mask_fcn_logits.weight
    assert abs(float(logits.detach().std()) / (2.0 / 81) ** 0.5 - 1) < 0.1


YAMLS = FBNET_YAMLS + sorted(glob.glob("configs/retinanet/*.yaml"))


@pytest.mark.parametrize("yaml", YAMLS)
def test_fbnet_and_retinanet_yaml_builds(yaml):
    """Every FBNet YAML (7) and RetinaNet YAML (6) of the repository
    builds in the port, narrowed, into the meta-architecture and heads its
    keys name."""
    from da_detect_tpu_torch.models.retinanet import RetinaNet

    assert len(YAMLS) == 13
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    r = cfg.MODEL.RESNETS
    r.NUM_GROUPS, r.WIDTH_PER_GROUP = (4, 2) if r.NUM_GROUPS > 1 else (1, 8)
    r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS = 8, 16
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
    model = build_detection_model(cfg)
    if cfg.MODEL.RETINANET_ON:
        assert isinstance(model, RetinaNet)
        assert model.backbone.fpn.top_block == "p6p7"
        assert model.backbone.first_level == 1       # C3-C5
        assert len(model.anchor_generator.cells) == 5
        return
    assert isinstance(model.backbone, pfb.FBNetTrunk)
    assert isinstance(model.rpn["head"], pfb.FBNetRPNHead)
    ext = model.roi_heads["box"]["feature_extractor"]
    assert isinstance(ext, pfb.FBNetRoIHead)
    assert ext.pooler["output_size"] == 6
    assert (model.mask_head is not None) == cfg.MODEL.MASK_ON
