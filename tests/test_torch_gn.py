"""GroupNorm in the port against the JAX package: the norm itself, the GN
R-50-C4 body, the GN and ReLU FPN, the GN res5 head, the FPN conv head
(``FPNXconv1fcFeatureExtractor``, with and without GN), the GN weights
through ``load_jax_variables`` and ``load_jax_train_state``, and the
optimizer's groups for them.

Flax's ``nn.GroupNorm`` (the JAX package's ``make_norm("gn")``) returns
float32 on a bfloat16 input; the bfloat16 cases assert that both frameworks'
GN outputs are float32 and agree.

Tolerances: float32 modules 1e-5 relative to the output's largest magnitude
(``F32_REL``; the GN statistics and the convolutions summed in another
order); the whole GN R-50-C4 body 4e-5 (``BODY_REL``): eleven blocks, each
renormalizing the last one's float32 noise, leave each framework more than
1e-5 of the max away from a float64 evaluation of the same body, so 1e-5
between the two is below float32's own error there; bfloat16 modules in
bfloat16 ulps of the reference's largest magnitude, stated beside each
test (bfloat16 convolutions, each a float32 sum rounded once, then the
float32 GN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from da_detect_tpu.engine.trainer import TrainState as JTrainState
from da_detect_tpu.models import box_head as jbox
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models.backbone import build_backbone as j_build_backbone
from da_detect_tpu.models.backbone.fpn import FPN as JFPN
from da_detect_tpu.models.backbone.resnet import Bottleneck as JBottleneck
from da_detect_tpu.models.backbone.resnet import ResNetHead as JResNetHead
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.solver.optim import make_optimizer as j_make_optimizer
from da_detect_tpu_torch import entry
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.layers import GroupNorm, make_norm
from da_detect_tpu_torch.models import box_head as pbox
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.models.backbone import build_backbone
from da_detect_tpu_torch.models.backbone.fpn import FPN
from da_detect_tpu_torch.models.backbone.resnet import Bottleneck, ResNetHead
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_train_state,
                                               load_jax_variables)
from tests.torch_harness import (assert_ulps, bf16_numpy, module_state,
                                 nhwc_to_torch, random_variables, tiny_cfgs,
                                 torch_to_nhwc)

F32_REL = 1e-5
BODY_REL = 4e-5
KEY = jax.random.PRNGKey(0)
BF16, JBF16 = torch.bfloat16, jnp.bfloat16
SCALES = (0.25, 0.125, 0.0625, 0.03125)
POOLER = dict(scales=SCALES, output_size=7, sampling_ratio=2, max_samples=8)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(KEY, *args))
    return random_variables(shapes, seed)


def _x(seed, *shape, scale=1.0, offset=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + offset).astype(np.float32)


def _close(got, want, what="", rel=F32_REL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"{what}: {err:.3e} > {rel} x {top:.3e}"


def _gn_cfgs(fpn: bool = False):
    """(JAX cfg, port cfg) of a GN model narrowed for the CPU: widths that
    32 groups divide (stem 32, width 32, res2 64), float32, canvas
    64x96; with ``fpn`` the R-50-FPN body, FPN 32 wide."""
    jcfg, pcfg = tiny_cfgs()
    for cfg in (jcfg, pcfg):
        r = cfg.MODEL.RESNETS
        r.STEM_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS = (
            32, 32, 64)
        cfg.MODEL.BACKBONE.USE_GN = True
        cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 0
        cfg.MODEL.ROI_BOX_HEAD.USE_GN = True
        if fpn:
            cfg.MODEL.BACKBONE.CONV_BODY = "R-50-FPN"
            cfg.MODEL.BACKBONE.OUT_CHANNELS = 32
            cfg.MODEL.FPN.USE_GN = True
            cfg.MODEL.FPN.USE_RELU = True
    return jcfg, pcfg


@pytest.mark.parametrize("shape,offset,channels_last", [
    ((2, 5, 7, 64), 0.0, True), ((1, 9, 4, 32), 3.0, False),
    ((3, 1, 1, 96), 0.0, True)], ids=["c64", "offset_mean", "one_pixel"])
def test_group_norm_matches_flax(shape, offset, channels_last):
    """``make_norm("gn")`` against Flax's GroupNorm (32 groups, eps 1e-5)
    on trained-looking scale and bias."""
    x = _x(0, *shape, scale=3.0, offset=offset)
    jm = nn.GroupNorm(num_groups=32, epsilon=1e-5)
    v = _init(jm, 1, x)
    m = make_norm("gn", shape[-1])
    assert isinstance(m, GroupNorm) and m.num_groups == 32 and m.eps == 1e-5
    m.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                       "bias": torch.from_numpy(v["params"]["bias"])})
    t = nhwc_to_torch(x)
    if not channels_last:
        t = t.contiguous()
    got = m(t)
    assert got.is_contiguous(memory_format=torch.channels_last if
                             channels_last else torch.contiguous_format)
    _close(torch_to_nhwc(got), jm.apply(v, x), "GroupNorm")


def test_group_norm_bf16_returns_float32():
    """Flax promotes a bfloat16 input against its float32 statistics: the
    output is float32, and so is the port's, with the same values."""
    x = bf16_numpy(_x(2, 2, 6, 5, 64, scale=2.0))
    jm = nn.GroupNorm(num_groups=32, epsilon=1e-5)
    v = _init(jm, 3, x)
    want = jm.apply(v, jnp.asarray(x).astype(JBF16))
    m = GroupNorm(64)
    m.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                       "bias": torch.from_numpy(v["params"]["bias"])})
    got = m(nhwc_to_torch(x).to(BF16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(torch_to_nhwc(got), want, "GroupNorm bf16")


def test_group_norm_gradients_match_flax():
    x = _x(4, 2, 5, 6, 64, scale=2.0, offset=1.0)
    g = _x(5, 2, 5, 6, 64)
    jm = nn.GroupNorm(num_groups=32, epsilon=1e-5)
    v = _init(jm, 6, x)
    want_x, want_p = jax.grad(
        lambda xx, p: jnp.sum(jm.apply({"params": p}, xx) * g),
        argnums=(0, 1))(x, v["params"])
    m = GroupNorm(64)
    m.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                       "bias": torch.from_numpy(v["params"]["bias"])})
    t = nhwc_to_torch(x).requires_grad_(True)
    (m(t) * nhwc_to_torch(g)).sum().backward()
    _close(torch_to_nhwc(t.grad), want_x, "dx")
    _close(m.weight.grad.numpy(), want_p["scale"], "dscale")
    _close(m.bias.grad.numpy(), want_p["bias"], "dbias")


@pytest.mark.parametrize("stride,cin", [(2, 32), (1, 64)],
                         ids=["downsample", "identity"])
def test_gn_bottleneck(stride, cin):
    x = _x(7, 2, 10, 12, cin)
    jmod = JBottleneck(bottleneck_channels=32, out_channels=64, stride=stride,
                       norm="gn")
    v = _init(jmod, 8, x)
    tmod = Bottleneck(cin, 32, 64, stride=stride, norm="gn")
    tmod.load_state_dict(module_state(v, "backbone/body/layer1/block0",
                                      "backbone.body.layer1.0."))
    assert isinstance(tmod.bn1, GroupNorm)
    _close(torch_to_nhwc(tmod(nhwc_to_torch(x))), jmod.apply(v, x),
           "GN bottleneck")


def test_gn_bottleneck_bf16_is_float32():
    """In bfloat16 each GN output, the residual sum and the block's output
    are float32 (a float32 island), in JAX and in the port: 2 ulps of the
    max (three bfloat16 convolutions, each rounded once, normalized)."""
    x = bf16_numpy(_x(9, 2, 10, 12, 32))
    jmod = JBottleneck(bottleneck_channels=32, out_channels=64, stride=2,
                       norm="gn", dtype=JBF16)
    v = _init(jmod, 10, x)
    tmod = Bottleneck(32, 32, 64, stride=2, norm="gn", dtype=BF16)
    tmod.load_state_dict(module_state(v, "backbone/body/layer1/block0",
                                      "backbone.body.layer1.0."))
    want = jmod.apply(v, jnp.asarray(x).astype(JBF16))
    got = tmod(nhwc_to_torch(x).to(BF16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert_ulps(torch_to_nhwc(got), want, 2, "GN bottleneck bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_r50_c4_body(dtype):
    """``BACKBONE.USE_GN``: the stem, every block and the downsample with
    GroupNorm; the C4 map is float32 in both dtypes (bfloat16: 12 ulps of
    the max: a block holds to 2, and each of the 34 convolutions' flipped
    roundings is renormalized, not damped, by the GN after it, through
    eleven blocks)."""
    jcfg, pcfg = _gn_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.TPU.COMPUTE_DTYPE = dtype
    jmod, jspec = j_build_backbone(jcfg)
    tmod, tspec = build_backbone(pcfg)
    assert tspec == type(tspec)(jspec.out_channels, jspec.strides)
    x = _x(11, 1, 64, 96, 3)
    v = _init(jmod, 12, x)
    tmod.load_state_dict(module_state(v, "backbone", "backbone."))
    assert isinstance(tmod.body.stem.bn1, GroupNorm)
    assert isinstance(tmod.body.layer1[0].downsample[1], GroupNorm)
    want = jmod.apply(v, x)[0]
    got = tmod(nhwc_to_torch(x))[0]
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (1, 256, 4, 6)
    if dtype == "float32":
        _close(torch_to_nhwc(got), want, "GN C4 body", BODY_REL)
    else:
        assert_ulps(torch_to_nhwc(got), want, 12, "GN C4 body bf16")
    assert all(p.requires_grad for p in tmod.parameters())


@pytest.mark.parametrize("norm,relu", [("gn", False), ("none", True),
                                       ("gn", True)],
                         ids=["gn", "relu", "gn_relu"])
def test_gn_relu_fpn(norm, relu):
    """``FPN.USE_GN`` (a GN after every conv, the convs without bias) and
    ``FPN.USE_RELU``."""
    feats = [_x(13 + i, 1, h, w, c) for i, ((h, w), c) in enumerate(
        zip([(15, 25), (8, 13), (4, 7), (2, 4)], [32, 64, 96, 128]))]
    jm = JFPN(out_channels=32, norm=norm, use_relu=relu)
    v = _init(jm, 17, [jnp.asarray(f) for f in feats])
    want = jm.apply(v, [jnp.asarray(f) for f in feats])
    pm = FPN([32, 64, 96, 128], 32, norm=norm, use_relu=relu)
    pm.load_state_dict(module_state(v, "backbone/fpn", "backbone.fpn."),
                       strict=True)
    assert (pm.fpn_inner1.bias is None) == (norm == "gn")
    with torch.no_grad():
        got = pm([nhwc_to_torch(f) for f in feats])
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        _close(torch_to_nhwc(g), w, f"P{i + 2}")


def test_gn_fpn_bf16_is_float32():
    """In bfloat16 the GN FPN's levels are float32, as in JAX: 2 ulps of
    each level's max."""
    feats = [bf16_numpy(_x(20 + i, 1, h, w, c)) for i, ((h, w), c) in
             enumerate(zip([(15, 25), (8, 13), (4, 7), (2, 4)],
                           [32, 64, 96, 128]))]
    jm = JFPN(out_channels=32, norm="gn", dtype=JBF16)
    v = _init(jm, 24, [jnp.asarray(f) for f in feats])
    want = jm.apply(v, [jnp.asarray(f).astype(JBF16) for f in feats])
    pm = FPN([32, 64, 96, 128], 32, norm="gn", dtype=BF16)
    pm.load_state_dict(module_state(v, "backbone/fpn", "backbone.fpn."))
    got = pm([nhwc_to_torch(f).to(BF16) for f in feats])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert_ulps(torch_to_nhwc(g), w, 2, f"P{i + 2}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_res5_head(dtype):
    """``ROI_BOX_HEAD.USE_GN`` on the C4 res5 head, fed a float32 pooled
    map (what a GN body's C4 map gives the pooler); in bfloat16 the head
    casts it once and returns float32 (4 ulps of the max)."""
    x = _x(25, 3, 14, 14, 256)
    jd, td = (JBF16, BF16) if dtype == "bfloat16" else (jnp.float32,
                                                        torch.float32)
    jmod = JResNetHead(width_per_group=32, res2_out_channels=64, norm="gn",
                       dtype=jd)
    v = _init(jmod, 26, x)
    tmod = ResNetHead(width_per_group=32, res2_out_channels=64, norm="gn",
                      dtype=td)
    tmod.load_state_dict(module_state(v, "feature_extractor/head",
                                      "roi_heads.box.feature_extractor.head."))
    want = jmod.apply(v, x)
    got = tmod(nhwc_to_torch(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (3, 512, 7, 7)
    if dtype == "float32":
        _close(torch_to_nhwc(got), want, "GN res5 head")
    else:
        assert_ulps(torch_to_nhwc(got), want, 4, "GN res5 head bf16")


def _pyramid(seed, c):
    return [_x(seed + i, 1, h, w, c)
            for i, (h, w) in enumerate([(16, 24), (8, 12), (4, 6), (2, 3)])]


def _rois(seed, b, r):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (b, r, 2))
    wh = rng.uniform(4, 40, (b, r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("use_gn", [False, True], ids=["plain", "gn"])
def test_xconv1fc_head_matches_jax(use_gn):
    """``FPNXconv1fcFeatureExtractor``: 4 convs (GN and no bias under
    ``use_gn``), then fc6 over the (C, H, W) flatten (the bridge permutes
    fc6's input rows from JAX's (H, W, C))."""
    feats = _pyramid(30, 32)
    rois = _rois(31, 1, 12)
    jext = jbox.FPNXconv1fcFeatureExtractor(
        pooler=POOLER, conv_dim=32, num_stacked_convs=4, mlp_dim=48,
        use_gn=use_gn)
    jf = [jnp.asarray(f) for f in feats]
    v = _init(jext, 32, jf, jnp.asarray(rois))
    want = jext.apply(v, jf, jnp.asarray(rois))
    ext = pbox.FPNXconv1fcFeatureExtractor(POOLER, 32, conv_dim=32,
                                           num_stacked_convs=4, mlp_dim=48,
                                           use_gn=use_gn)
    state = jax_state_dict({"params": {"feature_extractor": v["params"]}},
                           fc6_chw=(32, 7, 7))
    ext.load_state_dict({k[len("roi_heads.box.feature_extractor."):]: t
                         for k, t in state.items()}, strict=True)
    assert (ext.xconvs0.bias is None) == use_gn
    with torch.no_grad():
        got = ext([nhwc_to_torch(f) for f in feats], torch.from_numpy(rois),
                  impl="plain")
    assert got.shape == (1, 12, 48)
    _close(got.numpy(), want, "Xconv1fc head")


GN_YAMLS = [f"configs/gn_baselines/{name}.yaml" for name in (
    "e2e_faster_rcnn_R_50_FPN_1x_gn",
    "e2e_faster_rcnn_R_50_FPN_Xconv1fc_1x_gn",
    "e2e_faster_rcnn_R_50_FPN_gn_1x",
    "scratch_e2e_faster_rcnn_R_50_FPN_3x_gn",
    "scratch_e2e_faster_rcnn_R_50_FPN_Xconv1fc_3x_gn")]


@pytest.mark.parametrize("yaml", GN_YAMLS,
                         ids=[y.split("/")[-1][:-5] for y in GN_YAMLS])
def test_gn_baseline_yamls_build_and_load_jax_variables(yaml):
    """Every faster-rcnn YAML of ``configs/gn_baselines/`` builds in the
    port (narrowed), and the JAX model's variables load into it strictly:
    every GN scale and bias has its counterpart."""
    from da_detect_tpu.config import get_cfg as j_get_cfg

    cfgs = []
    for get in (j_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(yaml)
        cfg.merge_from_list([
            "MODEL.RESNETS.STEM_OUT_CHANNELS", 32,
            "MODEL.RESNETS.WIDTH_PER_GROUP", 32,
            "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
            "MODEL.BACKBONE.OUT_CHANNELS", 32,
            "MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM", 32,
            "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 48,
            "TPU.IMAGE_SHAPE", (64, 96), "TPU.COMPUTE_DTYPE", "float32"])
        cfgs.append(cfg)
    jcfg, pcfg = cfgs
    import __graft_entry__ as graft
    jmodel = j_build(jcfg)
    batch, _ = graft._batch(jcfg, 1, seed=0)
    v = _init(jmodel, 40, batch)
    model = build_detection_model(pcfg)
    load_jax_variables(model, v)
    gn = [n for n, m in model.named_modules() if isinstance(m, GroupNorm)]
    n_jax_gn = sum(1 for path, _ in jax.tree_util.tree_flatten_with_path(
        v["params"])[0] if str(path[-1].key) == "scale")
    assert len(gn) == n_jax_gn > 0
    with torch.no_grad():
        dets = model(entry.make_batch(pcfg, 1, seed=0)[0], impl="plain")
    assert torch.isfinite(dets.boxes).all()


def _sanity_like_models():
    jcfg, pcfg = _gn_cfgs()
    jmodel = j_build(jcfg)
    import __graft_entry__ as graft
    jargs = []
    for seed, src in ((0, True), (1, False), (2, False)):
        b, t = graft._batch(jcfg, 1, seed=seed, is_source=src)
        jargs += [b, t]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": KEY, "sampling": KEY, "dropout": KEY}, jargs[0], jargs[1],
        JDAState.create(), *jargs[2:], aligned=True,
        method=jmodel.train_forward))
    v = random_variables(shapes, seed=41)
    model = entry.prepare_model(build_detection_model(pcfg),
                                torch.device("cpu"))
    return jcfg, pcfg, v, model


def test_gn_weights_train_state_and_optimizer_groups():
    """The GN model's Flax ``scale``/``bias`` params land in trainable GN
    ``weight``/``bias``; ``load_jax_train_state`` carries their momentum;
    the optimizer puts GN biases in the bias group (2x lr, its own decay)
    and GN weights in the weight group, as JAX's label tree does."""
    from da_detect_tpu.solver.optim import param_labels

    jcfg, pcfg, v, model = _sanity_like_models()
    tx, _ = j_make_optimizer(jcfg, v["params"], "cosine")
    rng = np.random.RandomState(42)
    momentum = jax.tree.map(
        lambda p: rng.randn(*p.shape).astype(np.float32), v["params"])
    jstate = JTrainState(
        step=jnp.asarray(7, jnp.int32), params=v["params"],
        frozen=v.get("frozen", {}), opt_state=(jnp.asarray(7, jnp.int32),
                                       type(tx.init(v["params"])[1])(
                                           momentum=momentum)),
        da_state=JDAState.create(-0.5, -0.5), rng=KEY)
    state = create_train_state(pcfg, model, 0, "cosine")
    load_jax_train_state(state, jstate)
    params = dict(model.named_parameters())
    gn_names = [n for n, m in model.named_modules()
                if isinstance(m, GroupNorm)]
    assert len(gn_names) > 50
    bufs = state.optimizer.momentum_buffers()
    want = jax_state_dict({"params": momentum})
    for name in gn_names:
        for leaf, jleaf in (("weight", "scale"), ("bias", "bias")):
            key = f"{name}.{leaf}"
            assert params[key].requires_grad
            torch.testing.assert_close(bufs[key], want[key], rtol=0, atol=0)
    wanted = jax_state_dict({"params": v["params"]})
    for name in gn_names[:3]:
        torch.testing.assert_close(params[f"{name}.weight"],
                                   wanted[f"{name}.weight"], rtol=0, atol=0)
    labels = jax_state_dict({"params": jax.tree.map(
        lambda s: np.zeros(1, np.float32) if s == "bias"
        else np.ones(1, np.float32),
        param_labels(v["params"], 0))})
    groups = {g["name"]: {state.optimizer.names[p] for p in g["params"]}
              for g in state.optimizer.sgd.param_groups}
    for name in gn_names:
        assert labels[f"{name}.bias"].item() == 0.0
        assert labels[f"{name}.weight"].item() == 1.0
        assert f"{name}.bias" in groups["bias"]
        assert f"{name}.weight" in groups["weight"]
