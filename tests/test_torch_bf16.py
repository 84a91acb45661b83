"""The port in bfloat16 (``TPU.COMPUTE_DTYPE "bfloat16"``, the JAX package's
default) against the JAX package's bfloat16 modules, module by module and
for the eval forward; and a guard that the port really rounds in bfloat16.

Both frameworks get the same numpy weights (float32 parameters, cast at
use) and the same inputs, rounded to bfloat16 first where the module's
input is bfloat16. Tolerances are in
bfloat16 ulps of the reference's largest magnitude (``bf16_ulp``: 2 **
(floor(log2 m) - 7)), stated beside each test: the two frameworks round at
the same places (a float32-accumulated product or convolution rounded once,
each elementwise op rounded), so a module differs by the ulp that another
summation order flips, carried through the layers after it.

The deformable conv, ROIAlign and the scatter-add in bfloat16 are in
tests/test_torch_{deform_conv,roi_align,gather}.py; the flagship's train
step in tests/test_torch_bf16_train.py; the FPN-DCN model in
tests/test_torch_bf16_dcn.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.layers import FrozenBatchNorm as JFrozenBN
from da_detect_tpu.models import box_head as jbox
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models import da as jda
from da_detect_tpu.models import rpn as jrpn
from da_detect_tpu.models.backbone.fpn import FPN as JFPN
from da_detect_tpu.models.backbone.resnet import Bottleneck as JBottleneck
from da_detect_tpu.models.backbone.resnet import ResNetHead as JResNetHead
from da_detect_tpu.models.backbone.resnet import Stem as JStem
from da_detect_tpu.ops import grl as jgrl
from da_detect_tpu_torch import entry
from da_detect_tpu_torch.layers import Conv2d, FrozenBatchNorm, Linear
from da_detect_tpu_torch.models import box_head as tbox
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.models import da as tda
from da_detect_tpu_torch.models import rpn as trpn
from da_detect_tpu_torch.models.backbone.fpn import FPN
from da_detect_tpu_torch.models.backbone.resnet import (Bottleneck,
                                                        ResNetHead, Stem)
from da_detect_tpu_torch.ops import grl as tgrl
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_variables)
from tests.torch_harness import (as_f32, assert_ulps, bf16_numpy,
                                 module_state, nhwc_to_torch,
                                 random_variables, torch_to_nhwc)

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(module, seed, *args, scales=None, **kw):
    shapes = jax.eval_shape(lambda: module.init(KEY, *args, **kw))
    return random_variables(shapes, seed, scales)


def _x(seed, *shape):
    """A bfloat16-valued input, as float32 numpy."""
    return bf16_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32))


def _tb(x):
    """numpy NHWC -> torch bfloat16 NCHW (channels-last)."""
    return nhwc_to_torch(x).to(BF16)


def _jb(x):
    return jnp.asarray(x).astype(JBF16)


# ------------------------------------------------------------- modules

def test_frozen_batchnorm_bf16():
    """The affine cast to the input's dtype: bfloat16 in, bfloat16 out,
    float32 buffers. Exact: one multiply and one add, each rounded."""
    x = _x(0, 2, 5, 7, 6)
    v = _init(JFrozenBN(), 1, x)
    want = JFrozenBN().apply(v, _jb(x))
    bn = FrozenBatchNorm(6)
    bn.load_state_dict({"weight": torch.from_numpy(v["frozen"]["scale"]),
                        "bias": torch.from_numpy(v["frozen"]["bias"])})
    got = bn(_tb(x))
    assert got.dtype == BF16 and want.dtype == JBF16
    assert bn.weight.dtype == torch.float32
    assert_ulps(torch_to_nhwc(got.float()), want, 0, "FrozenBN")


# bottleneck (stride, stride_in_1x1, groups): 2 ulps of the output's max
# (three convolutions, each a float32 sum rounded once, the residual add)
@pytest.mark.parametrize("cin,cout,stride,groups", [
    (16, 32, 2, 1), (32, 32, 1, 1), (16, 32, 2, 4)],
    ids=["downsample", "identity", "grouped"])
def test_bottleneck_bf16(cin, cout, stride, groups):
    x = _x(2, 2, 12, 10, cin)
    jmod = JBottleneck(bottleneck_channels=8, out_channels=cout,
                       stride=stride, num_groups=groups, dtype=JBF16)
    v = _init(jmod, 3, x)
    tmod = Bottleneck(cin, 8, cout, stride=stride, num_groups=groups,
                      dtype=BF16)
    tmod.load_state_dict(module_state(v, "backbone/body/layer1/block0",
                                      "backbone.body.layer1.0."))
    want = jmod.apply(v, _jb(x))
    got = tmod(_tb(x))
    assert got.dtype == BF16 and want.dtype == JBF16
    assert_ulps(torch_to_nhwc(got.float()), want, 2, "bottleneck")


def test_stem_bf16():
    """The stem casts its float32 input (the normalized image) to
    bfloat16, as the JAX ResNet does before its stem: 1 ulp of the max."""
    x = np.random.RandomState(4).randn(1, 32, 48, 3).astype(np.float32)
    jmod = JStem(out_channels=16, dtype=JBF16)
    v = _init(jmod, 5, x)
    tmod = Stem(16, dtype=BF16)
    tmod.load_state_dict(module_state(v, "backbone/body/stem",
                                      "backbone.body.stem."))
    want = jmod.apply(v, jnp.asarray(x).astype(JBF16))
    got = tmod(nhwc_to_torch(x).to(BF16))
    assert got.dtype == BF16
    assert_ulps(torch_to_nhwc(got.float()), want, 1, "stem")


def test_res5_head_bf16():
    """Three res5 bottlenecks on pooled bfloat16 features: 4 ulps of the
    max (nine convolutions' roundings carried through)."""
    x = _x(6, 3, 14, 14, 128)
    jmod = JResNetHead(width_per_group=8, res2_out_channels=32, dtype=JBF16)
    v = _init(jmod, 7, x)
    tmod = ResNetHead(width_per_group=8, res2_out_channels=32, dtype=BF16)
    tmod.load_state_dict(module_state(v, "feature_extractor/head",
                                      "roi_heads.box.feature_extractor.head."))
    want = jmod.apply(v, _jb(x))
    got = tmod(_tb(x))
    assert got.dtype == BF16
    assert_ulps(torch_to_nhwc(got.float()), want, 4, "res5 head")


def _pyramid(seed, c):
    return [_x(seed + i, 1, h, w, c)
            for i, (h, w) in enumerate([(16, 24), (8, 12), (4, 6), (2, 3)])]


def test_fpn_bf16():
    """Lateral and output convs in bfloat16, the top-down sums in
    bfloat16: 2 ulps of each level's max."""
    feats = [_x(i, 1, h, w, c) for i, ((h, w), c) in enumerate(
        zip([(15, 25), (8, 13), (4, 7), (2, 4)], [8, 16, 32, 64]))]
    jm = JFPN(out_channels=16, dtype=JBF16)
    v = _init(jm, 1, [jnp.asarray(f) for f in feats])
    want = jm.apply(v, [_jb(f) for f in feats])
    pm = FPN([8, 16, 32, 64], 16, dtype=BF16)
    pm.load_state_dict(module_state(v, "backbone/fpn", "backbone.fpn."))
    got = pm([_tb(f) for f in feats])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == BF16
        assert_ulps(torch_to_nhwc(g.float()), w, 2, f"P{i + 2}")


def test_rpn_head_bf16():
    """The shared 3x3 conv and both 1x1 convs in bfloat16 on two levels:
    1 ulp of each output's max (logits spread x 30)."""
    feats = [_x(8, 2, 8, 12, 32), _x(9, 2, 4, 6, 32)]
    jm = jrpn.RPNHead(num_anchors=3, dtype=JBF16)
    v = _init(jm, 9, [jnp.asarray(f) for f in feats],
              scales={"cls_logits/kernel": 30.0})
    want = jm.apply(v, [_jb(f) for f in feats])
    pm = trpn.RPNHead(32, 3, dtype=BF16)
    pm.load_state_dict(module_state(v, "rpn_head", "rpn.head."))
    got = pm([_tb(f) for f in feats])
    for kind, g_levels, w_levels in zip(("logits", "deltas"), got, want):
        for g, w in zip(g_levels, w_levels):
            assert g.dtype == BF16
            assert_ulps(torch_to_nhwc(g.float()), w, 1, kind)


POOLER = dict(scales=(0.25, 0.125, 0.0625, 0.03125), output_size=7,
              sampling_ratio=2, max_samples=8)


def _rois(seed, b, r, hw=(64, 96)):
    rng = np.random.RandomState(seed)
    h, w = hw
    x1 = rng.uniform(0, w - 8, (b, r))
    y1 = rng.uniform(0, h - 8, (b, r))
    return np.stack([x1, y1, x1 + rng.uniform(4, 70, (b, r)),
                     y1 + rng.uniform(4, 50, (b, r))], -1).astype(np.float32)


def test_fpn_mlp_head_and_predictors_bf16():
    """FPN pooling in bfloat16, fc6/fc7 and the FPN predictor in bfloat16;
    and the C4 predictor (average pool, then its two linears): 2 ulps of
    each output's max."""
    feats = _pyramid(8, 16)
    rois = _rois(9, 1, 30)
    jext = jbox.FPN2MLPFeatureExtractor(pooler=POOLER, mlp_dim=32,
                                        dtype=JBF16)
    jpred = jbox.FPNPredictor(num_classes=9, dtype=JBF16)
    jf = [_jb(f) for f in feats]
    ext_vars = _init(jext, 10, jf, jnp.asarray(rois))
    x = jext.apply(ext_vars, jf, jnp.asarray(rois))
    pred_vars = _init(jpred, 11, x)
    want_logits, want_deltas = jpred.apply(pred_vars, x)
    ext = tbox.FPN2MLPFeatureExtractor(POOLER, 16, 32, dtype=BF16)
    state = jax_state_dict({"params": {"feature_extractor":
                                       ext_vars["params"]}},
                           fc6_chw=(16, 7, 7))
    ext.load_state_dict({k[len("roi_heads.box.feature_extractor."):]: v
                         for k, v in state.items()})
    pred = tbox.FPNPredictor(32, 9, dtype=BF16)
    pred.load_state_dict(module_state(pred_vars, "predictor",
                                      "roi_heads.box.predictor."))
    got_x = ext([_tb(f) for f in feats], torch.from_numpy(rois),
                impl="plain")
    got_logits, got_deltas = pred(got_x)
    assert got_x.dtype == got_logits.dtype == BF16
    assert_ulps(got_x, x, 2, "fc7")
    assert_ulps(got_logits, want_logits, 2, "cls_score")
    assert_ulps(got_deltas, want_deltas, 2, "bbox_pred")

    xc4 = _x(12, 2, 5, 7, 7, 64)                      # [B, R, 7, 7, C]
    jc4 = jbox.FastRCNNPredictor(num_classes=9, dtype=JBF16)
    c4_vars = _init(jc4, 13, jnp.asarray(xc4))
    want_c4 = jc4.apply(c4_vars, _jb(xc4))
    pc4 = tbox.FastRCNNPredictor(64, 9, dtype=BF16)
    pc4.load_state_dict(module_state(c4_vars, "predictor",
                                     "roi_heads.box.predictor."))
    got_c4 = pc4(torch.from_numpy(xc4).permute(0, 1, 4, 2, 3).to(BF16))
    for g, w, name in zip(got_c4, want_c4, ("cls_score", "bbox_pred")):
        assert g.dtype == BF16
        assert_ulps(g, w, 2, f"C4 {name}")


def test_da_heads_and_grl_bf16():
    """The image head (1x1 convs to 512 and 1) and the instance head
    (1024-1024-1, dropout off) in bfloat16: 2 ulps of each output's max;
    the GRL's backward scales the bfloat16 gradient by the weight rounded
    to bfloat16, as JAX does: exact."""
    img = _x(14, 2, 6, 8, 32)
    jimg = jda.DAImgHead(dtype=JBF16)
    vi = _init(jimg, 15, [jnp.asarray(img)])
    want_img = jimg.apply(vi, [_jb(img)])[0]
    pimg = tda.DAImgHead(32, dtype=BF16)
    pimg.load_state_dict(module_state(vi, "da_heads/imghead",
                                      "da_heads.imghead."))
    got_img = pimg([_tb(img)])[0]
    assert got_img.dtype == BF16
    assert_ulps(torch_to_nhwc(got_img.float()), want_img, 2, "image head")

    ins = _x(16, 2, 6, 64)
    jins = jda.DAInsHead(dtype=JBF16)
    vn = _init(jins, 17, jnp.asarray(ins), deterministic=True)
    want_ins = jins.apply(vn, _jb(ins), deterministic=True)
    pins = tda.DAInsHead(64, dtype=BF16)
    pins.load_state_dict(module_state(vn, "da_heads/inshead",
                                      "da_heads.inshead."))
    got_ins = pins(torch.from_numpy(ins).to(BF16), deterministic=True)
    assert got_ins.dtype == BF16
    assert_ulps(got_ins, want_ins, 2, "instance head")

    g = _x(18, 3, 4)
    for weight in (-0.1, 0.3):
        _, vjp = jax.vjp(lambda y: jgrl.gradient_scalar(y, weight),
                         _jb(g))
        want = vjp(_jb(g))[0]
        xt = torch.from_numpy(g).to(BF16).requires_grad_()
        tgrl.gradient_scalar(xt, weight).backward(
            torch.from_numpy(g).to(BF16))
        assert xt.grad.dtype == BF16
        assert_ulps(xt.grad, want, 0, f"GRL {weight}")
        xt.grad = None
        tgrl.gradient_scalar(xt, torch.tensor(weight)).backward(
            torch.from_numpy(g).to(BF16))
        assert_ulps(xt.grad, want, 0, f"GRL tensor {weight}")


# ------------------------------------------------------- the eval forward

SCORE_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
                "predictor/cls_score/kernel": 30.0}


def _tiny_cfgs(dtype):
    """The flagship narrowed for the CPU (canvas 64x96, 64 -> 16
    proposals, stem 16, width 8, res2 32) in ``dtype``, exact top-k."""
    jcfg = graft._flagship_cfg(canvas=(64, 96), test_tops=(64, 16))
    pcfg = entry.flagship_cfg(canvas=(64, 96), test_tops=(64, 16),
                              dtype=dtype)
    for cfg in (jcfg, pcfg):
        cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
        cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfg.TPU.APPROX_TOPK = False
    return jcfg, pcfg


def _jax_forward(jcfg, variables, jbatch):
    """Detections and the backbone, RPN-head and predictor outputs of the
    JAX model's eval forward."""
    jmodel = j_build(jcfg)
    dets, inter = jax.jit(lambda v, b: jmodel.apply(
        v, b, capture_intermediates=True, mutable=["intermediates"]))(
            variables, jbatch)
    inter = inter["intermediates"]
    return dets, dict(
        features=inter["backbone"]["__call__"][0][0],
        rpn_logits=inter["rpn_head"]["__call__"][0][0][0],
        cls_logits=inter["predictor"]["__call__"][0][0])


def _port_forward(pcfg, variables, batch):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = entry.prepare_model(model, torch.device("cpu"))
    seen = {}

    def keep(key, pick):
        def hook(module, args, out):
            seen[key] = pick(out)
        return hook

    hooks = [
        model.backbone.register_forward_hook(keep("features",
                                                  lambda o: o[0])),
        model.rpn["head"].register_forward_hook(keep("rpn_logits",
                                                     lambda o: o[0][0])),
        model.roi_heads["box"]["predictor"].register_forward_hook(
            keep("cls_logits", lambda o: o[0]))]
    dets = model(batch)
    for h in hooks:
        h.remove()
    return model, dets, {
        "features": torch_to_nhwc(seen["features"].float()),
        "rpn_logits": torch_to_nhwc(seen["rpn_logits"].float()),
        "cls_logits": as_f32(seen["cls_logits"])}


@pytest.fixture(scope="module")
def forwards():
    """The tiny flagship eval forward on one set of numpy variables: JAX in
    bfloat16 and float32, the port in bfloat16."""
    jcfg, pcfg = _tiny_cfgs("bfloat16")
    jbatch, _ = graft._batch(jcfg, 2, seed=0)
    shapes = jax.eval_shape(
        lambda: j_build(jcfg).init({"params": KEY}, jbatch))
    variables = random_variables(shapes, seed=1, scales=SCORE_SCALES)
    want, want_inter = _jax_forward(jcfg, variables, jbatch)
    f32_cfg, _ = _tiny_cfgs("float32")
    _, f32_inter = _jax_forward(f32_cfg, variables, jbatch)
    batch, _ = entry.make_batch(pcfg, 2, seed=0)
    model, got, got_inter = _port_forward(pcfg, variables, batch)
    return dict(model=model, batch=batch, want=jax.device_get(want),
                got=got, want_inter=want_inter, f32_inter=f32_inter,
                got_inter=got_inter)


def test_eval_forward_bf16_matches_jax(forwards):
    """``entry.flagship_cfg()``'s dtype, bfloat16: the tiny flagship's
    detections against the JAX model's bfloat16 forward. Validity, labels
    and order exactly; boxes within 0.25 px (a bfloat16 ulp of a box delta
    near 1, 2^-7, times boxes up to ~60 px); scores within 1e-4 (float32
    softmax of bfloat16 logits one ulp apart at most)."""
    want, got = forwards["want"], forwards["got"]
    valid = np.asarray(want.valid)
    assert valid.sum(axis=1).min() >= 8
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=0.25)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-4)
    assert got.boxes.dtype == got.scores.dtype == torch.float32


@pytest.mark.parametrize("stage", ["features", "rpn_logits", "cls_logits"])
def test_port_really_rounds_in_bf16(forwards, stage):
    """The gap between the port's bfloat16 and JAX's bfloat16 is at most a
    quarter of the gap between JAX's bfloat16 and JAX's float32, on the C4
    features, the RPN logits and the box logits: a port that stayed in
    float32 would sit at the full gap."""
    got, want = forwards["got_inter"][stage], forwards["want_inter"][stage]
    f32 = forwards["f32_inter"][stage]
    port_gap = float(np.abs(got - np.asarray(want, np.float32)).max())
    dtype_gap = float(np.abs(np.asarray(want, np.float32)
                             - np.asarray(f32, np.float32)).max())
    assert dtype_gap > 0
    assert port_gap <= 0.25 * dtype_gap, (stage, port_gap, dtype_gap)


def test_conv_and_linear_inputs_are_bf16(forwards):
    """A census of forward pre-hooks on every convolution and linear layer
    of the bfloat16 model in its eval forward (the train step's census,
    with the DA heads, and the FPN-DCN model's, with the deformable convs'
    float32 outputs, are in test_torch_bf16_train.py): every input is
    bfloat16, and every such layer computes in bfloat16."""
    model, batch = forwards["model"], forwards["batch"]
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args, name=name: seen.append((name, args[0].dtype)))
        for name, m in model.named_modules()
        if isinstance(m, (Conv2d, Linear))]
    model(batch)
    for h in hooks:
        h.remove()
    layers = {name: m for name, m in model.named_modules()
              if isinstance(m, (Conv2d, Linear))}
    assert all(m.compute_dtype == BF16 for m in layers.values())
    # every layer but the DA heads' runs in the eval forward
    assert {name for name, _ in seen} == {
        name for name in layers if not name.startswith("da_heads.")}
    assert {dtype for _, dtype in seen} == {BF16}, [
        s for s in seen if s[1] != BF16]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_entry_points_compute_dtype():
    """``entry()`` and ``entry(cfg=dcn_cfg())`` compute in bfloat16, as
    ``__graft_entry__.entry()`` and the DCN YAML do; ``train_cfg()`` stays
    float32, as ``_dryrun_impl`` sets it."""
    assert entry.flagship_cfg().TPU.COMPUTE_DTYPE == "bfloat16"
    assert graft._flagship_cfg().TPU.COMPUTE_DTYPE == "bfloat16"
    assert entry.dcn_cfg().TPU.COMPUTE_DTYPE == "bfloat16"
    assert entry.dcn_train_cfg().TPU.COMPUTE_DTYPE == "bfloat16"
    assert entry.train_cfg().TPU.COMPUTE_DTYPE == "float32"
    _, (model, batch) = entry.entry(device="cpu", cfg=_tiny_cfgs(
        "bfloat16")[1])
    assert model.rpn["head"].conv.compute_dtype == BF16
    dets = model(batch)
    assert dets.boxes.dtype == torch.float32
    assert bool(torch.isfinite(dets.boxes).all())
