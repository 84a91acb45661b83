"""The port's remaining single-card modules against the JAX package's, on the
same numpy weights and inputs: the ``Registry`` and the backbone table, the
ResNet C5 bodies, deformable PS-ROI pooling (``layers/deform_pool.py``),
position and channel attention (``models/attention.py``), the multi-level
DA heads (``models/da_fpn.py``), and ``Boxes`` (``structures/boxes.py``)
with the box geometry it adds to ``ops/box_ops.py``.

Zero-initialised parameters would make parity vacuous (an untrained PAM or
CAM is the identity, an untrained ``DeformRoIPooling`` pools without
offsets): every parameter is drawn by ``torch_harness.random_variables``
(kernels std 1/sqrt(fan_in), other leaves normal(0.1)), and the tests check
that ``gamma`` and ``offset_fc2`` came out nonzero.

Tolerances: float32 outputs and gradients rtol 1e-5 and atol 1e-5 of their
largest magnitude (float32 sums in another order; the attention's
parameter gradients plus 1e-6 of the largest of them, for PAM's key bias,
whose gradient the softmax cancels to rounding noise); losses rtol 1e-5; the
box geometry and ``Boxes`` exact (the same float32 operations in the same
order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu.layers import deform_pool as jdp
from da_detect_tpu.models import attention as jatt
from da_detect_tpu.models import da_fpn as jfpn
from da_detect_tpu.models.backbone import backbone as jbb
from da_detect_tpu.ops import box_ops as jbox
from da_detect_tpu.structures import boxes as jboxes
from da_detect_tpu.utils.registry import Registry as JRegistry
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.layers import deform_pool as pdp
from da_detect_tpu_torch.models import attention as patt
from da_detect_tpu_torch.models import da_fpn as pfpn
from da_detect_tpu_torch.models.backbone import backbone as pbb
from da_detect_tpu_torch.models.backbone.vgg import VGG16
from da_detect_tpu_torch.ops import box_ops as pbox
from da_detect_tpu_torch.structures import Boxes, concat_boxes
from da_detect_tpu_torch.utils.registry import Registry
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_variables)
from tests.torch_harness import (module_state, nhwc_to_torch,
                                 random_variables, torch_to_nhwc)

TOL = dict(rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _allclose(got, want, what: str = "") -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5 * float(
        np.abs(want).max()), err_msg=what, **TOL)


def _close(got: torch.Tensor, want, what: str = "") -> None:
    """A logical NCHW tensor against NHWC numpy."""
    _allclose(torch_to_nhwc(got.detach()), want, what)


def _variables(jmod, *args, seed: int = 2) -> dict:
    return random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *args)), seed=seed)


# ---------------------------------------------------------------- registry

def test_registry_matches_jax():
    """register (direct and as a decorator) and the refusal of a name
    twice, as the JAX package's ``Registry``."""
    for reg in (Registry(), JRegistry()):
        assert reg.register("a", 1) == 1

        @reg.register("b")
        def fn():
            return 2

        assert reg["b"] is fn and list(reg) == ["a", "b"]
        with pytest.raises(KeyError, match="already registered"):
            reg.register("a", 3)
        with pytest.raises(KeyError, match="already registered"):
            reg.register("b")(fn)
        assert reg["a"] == 1


def _c5_cfgs(body: str):
    jcfg, pcfg = j_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list([
            "MODEL.BACKBONE.CONV_BODY", body,
            "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
            "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
            "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
            "TPU.COMPUTE_DTYPE", "float32"])
    return jcfg, pcfg


def test_c5_body_matches_jax():
    """R-50-C5 narrowed (stem 8, width 4, res2 16): 4 stages, no FPN, one
    stride-32 map; FrozenBN statistics drawn, so the folded affine is
    exercised; stages before FREEZE_CONV_BODY_AT 2 frozen."""
    jcfg, pcfg = _c5_cfgs("R-50-C5")
    jmod, jspec = jbb.build_backbone(jcfg)
    x = np.random.RandomState(6).randn(1, 64, 96, 3).astype(np.float32)
    variables = random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), x)), seed=3)
    (want,) = jax.jit(jmod.apply)(variables, x)
    pmod, pspec = pbb.build_backbone(pcfg)
    pmod.load_state_dict(module_state(variables, "backbone", "backbone."))
    pmod = pmod.to(memory_format=torch.channels_last)
    (got,) = pmod(nhwc_to_torch(x), impl="plain")
    assert (pspec.out_channels, pspec.strides) == (128, (32,))
    assert (jspec.out_channels, jspec.strides) == (128, (32,))
    assert tuple(got.shape) == (1, 128, 2, 3)
    _close(got, want)
    frozen = {n.split(".")[0] for n, p in pmod.body.named_parameters()
              if not p.requires_grad}
    assert frozen == {"stem", "layer1"}


@pytest.mark.parametrize("body", list(jbb.BACKBONES) + ["VGG-16"])
def test_body_spec_matches_jax(body):
    """Every CONV_BODY of the JAX package's table (in its order) and VGG-16:
    the port's spec (output channels and strides) equals JAX's
    ``build_backbone``'s, narrowed."""
    assert list(pbb.BACKBONES) == list(jbb.BACKBONES)
    assert isinstance(pbb.BACKBONES, Registry)
    jcfg, pcfg = _c5_cfgs(body)
    if body.startswith("X-"):
        for cfg in (jcfg, pcfg):
            cfg.merge_from_list(["MODEL.RESNETS.NUM_GROUPS", 4,
                                 "MODEL.RESNETS.WIDTH_PER_GROUP", 2])
    assert pbb.BACKBONES.get(body) == jbb.BACKBONES.get(body)
    _, jspec = jbb.build_backbone(jcfg)
    module, pspec = pbb.build_backbone(pcfg)
    assert (pspec.out_channels, pspec.strides) == (jspec.out_channels,
                                                   jspec.strides)
    assert isinstance(module, VGG16) == body.startswith("V")


def test_unknown_body_raises_keyerror():
    cfg = get_cfg()
    cfg.MODEL.BACKBONE.CONV_BODY = "R-18-C4"
    with pytest.raises(KeyError, match="unknown CONV_BODY"):
        pbb.build_backbone(cfg)




# ---------------------------------------------------------------- deform pool

H, W, P, CPP = 9, 11, 3, 5


def _pool_inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(H, W, P * P * CPP).astype(np.float32)
    # ROIs in image coordinates at scale 1/4: inside, across the edge,
    # tiny (sides clamped to 0.1) and a half-pixel rounding case
    rois = np.array([[3.0, 5.0, 30.0, 25.0], [-6.0, 10.0, 20.0, 50.0],
                     [12.0, 12.0, 12.4, 12.2], [20.5, 2.5, 44.5, 33.5],
                     [0.0, 0.0, 43.0, 35.0]], np.float32)
    offsets = (0.8 * rng.randn(len(rois), P, P, 2)).astype(np.float32)
    return feats, rois, offsets


POOL_KW = dict(spatial_scale=0.25, output_size=P, out_channels=4,
               sample_per_part=3, trans_std=0.1)


@functools.lru_cache(maxsize=None)
def _jax_pool(with_offsets: bool):
    """JAX's pool of ``_pool_inputs`` and its gradients under a random
    cotangent (features, offsets or None), once a case for both impls."""
    feats, rois, offsets = _pool_inputs()
    cot = np.random.RandomState(1).randn(len(rois), P, P, 4).astype(
        np.float32)

    def jloss(f, o):
        out = jdp.deform_ps_roi_pool(f, jnp.asarray(rois), o, **POOL_KW)
        return jnp.sum(out * cot), out

    (_, want), (gf, go) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(feats), jnp.asarray(offsets) if with_offsets else None)
    return cot, np.asarray(want), np.asarray(gf), \
        None if go is None else np.asarray(go)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("with_offsets", [False, True])
def test_deform_ps_roi_pool_matches_jax(impl, with_offsets):
    """Forward, and the gradients of the features and the offsets under a
    random cotangent (out_channels 4 of C' 5: the last channel cut),
    through the plain gather and through the kernel wrappers' CPU branch."""
    feats, rois, offsets = _pool_inputs()
    cot, want, gf, go = _jax_pool(with_offsets)
    f_t = torch.tensor(feats, requires_grad=True)
    o_t = torch.tensor(offsets, requires_grad=True) if with_offsets \
        else None
    got = pdp.deform_ps_roi_pool(f_t, torch.from_numpy(rois), o_t,
                                 impl=impl, **POOL_KW)
    assert tuple(got.shape) == (len(rois), P, P, 4)
    _allclose(got, want)
    (got * torch.from_numpy(cot)).sum().backward()
    _allclose(f_t.grad, gf, "d features")
    assert float(f_t.grad.abs().max()) > 0
    if with_offsets:
        _allclose(o_t.grad, go, "d offsets")
        assert float(o_t.grad.abs().max()) > 0


def test_deform_roi_pooling_module_matches_jax():
    """``DeformRoIPooling`` with its offset branch: drawn weights (so
    ``offset_fc2`` is nonzero and the second pool moves), output and the
    gradients of every parameter and of the features."""
    feats, rois, _ = _pool_inputs(3)
    kw = dict(spatial_scale=0.25, output_size=P, out_channels=4)
    jmod = jdp.DeformRoIPooling(**kw)
    variables = _variables(jmod, jnp.asarray(feats), jnp.asarray(rois))
    assert np.abs(variables["params"]["offset_fc2"]["kernel"]).max() > 0
    cot = np.random.RandomState(4).randn(len(rois), P, P, 4).astype(
        np.float32)

    def jloss(v, f):
        out = jmod.apply(v, f, jnp.asarray(rois))
        return jnp.sum(out * cot), out

    (_, want), (gv, gf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        variables, jnp.asarray(feats))
    pmod = pdp.DeformRoIPooling(**kw)
    load_jax_variables(pmod, variables)
    f_t = torch.tensor(feats, requires_grad=True)
    got = pmod(f_t, torch.from_numpy(rois))
    _allclose(got, want)
    plain = pdp.deform_ps_roi_pool(f_t.detach(), torch.from_numpy(rois),
                                   None, **kw).detach()
    assert float((got.detach() - plain).abs().max()) > 1e-3   # the offsets act
    (got * torch.from_numpy(cot)).sum().backward()
    _allclose(f_t.grad, gf, "d features")
    grads = {n: p.grad for n, p in pmod.named_parameters()}
    want_grads = jax_state_dict(gv, detector=False)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        _allclose(g, want_grads[name].numpy(), name)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("name", ["PAM", "CAM"])
def test_attention_matches_jax(name):
    """PAM and CAM with a drawn (nonzero) gamma: output and the gradients
    of the input and of every parameter."""
    x = np.random.RandomState(5).randn(2, 6, 7, 16).astype(np.float32)
    jmod = getattr(jatt, name)()
    variables = _variables(jmod, x, seed=6)
    assert abs(float(variables["params"]["gamma"])) > 1e-3
    cot = np.random.RandomState(7).randn(*x.shape).astype(np.float32)

    def jloss(v, xx):
        out = jmod.apply(v, xx)
        return jnp.sum(out * cot), out

    (_, want), (gv, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        variables, jnp.asarray(x))
    pmod = patt.PAM(16) if name == "PAM" else patt.CAM()
    load_jax_variables(pmod, variables)
    x_t = nhwc_to_torch(x).clone().requires_grad_(True)
    got = pmod(x_t)
    _close(got, want)
    (got * nhwc_to_torch(cot)).sum().backward()
    _close(x_t.grad, gx, "d x")
    want_grads = jax_state_dict(gv, detector=False)
    # the key's bias moves every logit of a query alike, which the softmax
    # cancels: its gradient is rounding noise, held to 1e-6 of the largest
    floor = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for n, p in pmod.named_parameters():
        w = want_grads[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5, err_msg=n,
                                   atol=1e-5 * float(np.abs(w).max()) + floor)


# ---------------------------------------------------------------- DA heads

LEVELS = ((8, 12), (4, 6), (2, 3))


def test_multi_level_da_module_matches_jax():
    """``MultiLevelDAModule`` on 3 levels of 2 images (one source, one
    target): both losses, and the gradients of the levels (the image loss's
    through the reversal, -0.1 times, plus the scale discriminator's, not
    reversed) and of every parameter."""
    rng = np.random.RandomState(8)
    feats = [rng.randn(2, h, w, 16).astype(np.float32) for h, w in LEVELS]
    is_source = np.array([True, False])
    jmod = jfpn.MultiLevelDAModule()
    variables = random_variables(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), feats, jnp.asarray(is_source))), seed=9)

    def jloss(v, fs):
        losses = jmod.apply(v, fs, jnp.asarray(is_source))
        return sum(losses.values()), losses

    (_, want), (gv, gfs) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        variables, [jnp.asarray(f) for f in feats])
    pmod = pfpn.MultiLevelDAModule(16, len(LEVELS))
    load_jax_variables(pmod, variables)
    fs_t = [nhwc_to_torch(f).clone().requires_grad_(True) for f in feats]
    losses = pmod(fs_t, torch.from_numpy(is_source))
    assert set(losses) == set(want) == {"loss_da_image_mlvl",
                                        "loss_scale_disc"}
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(want[k]), **TOL,
                                   err_msg=k)
    sum(losses.values()).backward()
    for f, g in zip(fs_t, gfs):
        _close(f.grad, g, "d level")
    want_grads = jax_state_dict(gv, detector=False)
    assert set(want_grads) == {n for n, _ in pmod.named_parameters()}
    for n, p in pmod.named_parameters():
        _allclose(p.grad, want_grads[n].numpy(), n)


def test_multi_level_da_reversal_and_no_disc():
    """The image loss alone (``scale_weight`` 0: no discriminator) reaches
    the levels reversed: their gradient is -grl_weight times the loss's
    gradient without the reversal."""
    rng = np.random.RandomState(10)
    feats = [rng.randn(2, 16, h, w).astype(np.float32) for h, w in LEVELS]
    torch.manual_seed(0)
    pmod = pfpn.MultiLevelDAModule(16, len(LEVELS), grl_weight=0.25,
                                   scale_weight=0.0)
    with torch.no_grad():
        pmod.scale_head.conv1_joint.weight.normal_(0.0, 0.1)
        pmod.scale_head.conv2_joint.weight.normal_(0.0, 0.1)
    assert pmod.scale_disc is None
    is_source = torch.tensor([True, False])
    fs = [torch.tensor(f, requires_grad=True) for f in feats]
    losses = pmod(fs, is_source)
    assert set(losses) == {"loss_da_image_mlvl"}
    losses["loss_da_image_mlvl"].backward()
    plain = [torch.tensor(f, requires_grad=True) for f in feats]
    total, count = 0.0, 0.0
    for lvl in pmod.scale_head(plain):
        lv = lvl.reshape(2, -1)
        total = total + torch.nn.functional.binary_cross_entropy_with_logits(
            lv, is_source[:, None].float().expand_as(lv), reduction="sum")
        count += lv.numel()
    (total / count).backward()
    for f, g in zip(fs, plain):
        torch.testing.assert_close(f.grad, -0.25 * g.grad, rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------------- boxes

def _box_inputs(seed: int = 11, batch: tuple = (2,), n: int = 6):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-20, 80, batch + (n,))
    y1 = rng.uniform(-20, 60, batch + (n,))
    xyxy = np.stack([x1, y1, x1 + rng.uniform(0, 40, x1.shape),
                     y1 + rng.uniform(0, 30, x1.shape)], -1).astype(
        np.float32)
    valid = rng.rand(*batch, n) > 0.3
    fields = {"scores": rng.rand(*batch, n).astype(np.float32),
              "labels": rng.randint(0, 9, batch + (n,)).astype(np.int32),
              "masks": rng.rand(*batch, n, 3, 4).astype(np.float32)}
    return xyxy, valid, fields


def _pair_boxes(seed: int = 11):
    xyxy, valid, fields = _box_inputs(seed)
    jb = jboxes.Boxes(xyxy=jnp.asarray(xyxy), valid=jnp.asarray(valid),
                      fields={k: jnp.asarray(v) for k, v in fields.items()})
    pb = Boxes(xyxy=torch.from_numpy(xyxy), valid=torch.from_numpy(valid),
               fields={k: torch.from_numpy(v) for k, v in fields.items()})
    return jb, pb


def _same(pb: Boxes, jb) -> None:
    np.testing.assert_array_equal(pb.xyxy.numpy(), np.asarray(jb.xyxy))
    np.testing.assert_array_equal(pb.valid.numpy(), np.asarray(jb.valid))
    assert set(pb.fields) == set(jb.fields)
    for k, v in pb.fields.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jb.fields[k]),
                                      err_msg=k)


BOX_METHODS = {
    "scale": lambda b: b.scale(0.5, 1.25),
    "scale_per_image": None,
    "hflip": lambda b: b.hflip(96.0),
    "clip_to_image": lambda b: b.clip_to_image(48, 64),
    "prune_small": lambda b: b.prune_small(12.0),
    "prune_small_continuous": lambda b: b.prune_small(12.0,
                                                      legacy_plus1=False),
    "with_fields": None,
}


@pytest.mark.parametrize("method", list(BOX_METHODS))
def test_boxes_method_matches_jax(method):
    jb, pb = _pair_boxes()
    if method == "scale_per_image":
        s = np.array([[0.5], [2.0]], np.float32)
        got, want = pb.scale(torch.from_numpy(s), torch.from_numpy(s)), \
            jb.scale(jnp.asarray(s), jnp.asarray(s))
    elif method == "with_fields":
        got = pb.with_fields(extra=pb.fields["scores"] * 2)
        want = jb.with_fields(extra=jb.fields["scores"] * 2)
    else:
        got, want = BOX_METHODS[method](pb), BOX_METHODS[method](jb)
    _same(got, want)


@pytest.mark.parametrize("legacy_plus1", [True, False])
def test_boxes_area_and_counts_match_jax(legacy_plus1):
    jb, pb = _pair_boxes()
    np.testing.assert_array_equal(pb.area(legacy_plus1).numpy(),
                                  np.asarray(jb.area(legacy_plus1)))
    np.testing.assert_array_equal(pb.num_valid().numpy(),
                                  np.asarray(jb.num_valid()))
    assert pb.capacity == jb.capacity == 6
    assert pb.has_field("scores") and not pb.has_field("nothing")
    assert pb.get_field("labels") is pb.fields["labels"]
    empty = Boxes.empty(4, (3,), scores=torch.zeros(3, 4))
    jempty = jboxes.Boxes.empty(4, (3,), scores=jnp.zeros((3, 4)))
    assert tuple(empty.xyxy.shape) == jempty.xyxy.shape
    assert not empty.valid.any() and empty.valid.dtype == torch.bool


@pytest.mark.parametrize("with_mask", [False, True])
def test_boxes_take_matches_jax(with_mask):
    """Rows gathered along the box axis, with repeats; fields of more dims
    than the mask (masks [B, N, 3, 4]) along the same axis."""
    jb, pb = _pair_boxes()
    idx = np.array([[5, 0, 0, 3], [1, 2, 5, 4]], np.int32)
    iv = np.array([[True, False, True, True], [True, True, False, True]])
    got = pb.take(torch.from_numpy(idx),
                  torch.from_numpy(iv) if with_mask else None)
    want = jb.take(jnp.asarray(idx), jnp.asarray(iv) if with_mask else None)
    _same(got, want)


def test_concat_boxes_matches_jax():
    (ja, pa), (jb, pb) = _pair_boxes(11), _pair_boxes(12)
    _same(concat_boxes([pa, pb]), jboxes.concat_boxes([ja, jb]))
    with pytest.raises(ValueError, match="field mismatch"):
        concat_boxes([pa, pb.with_fields(extra=pb.fields["scores"])])


BOX_OPS = ["box_area", "box_iou", "encode_boxes", "decode_boxes",
           "clip_boxes", "min_size_mask", "scale_boxes", "hflip_boxes",
           "xywh_to_xyxy", "xyxy_to_xywh"]


@pytest.mark.parametrize("legacy_plus1", [True, False])
@pytest.mark.parametrize("name", BOX_OPS)
def test_box_ops_match_jax(name, legacy_plus1):
    """Each geometry function in both pixel conventions (``scale_boxes``
    has none), bit for bit: the same float32 operations in the same order;
    the box coder within a float32 ulp (its log and exp are each
    library's own)."""
    xyxy, _, _ = _box_inputs(13)
    other, _, _ = _box_inputs(14)
    deltas = np.random.RandomState(15).randn(*xyxy.shape).astype(np.float32)
    kw = {} if name == "scale_boxes" else {"legacy_plus1": legacy_plus1}
    args = {"box_area": (xyxy,), "box_iou": (xyxy, other),
            "encode_boxes": (other, xyxy), "decode_boxes": (deltas, xyxy),
            "clip_boxes": (xyxy, 48.0, 64.0), "min_size_mask": (xyxy, 10.0),
            "scale_boxes": (xyxy, 0.5, 1.5), "hflip_boxes": (xyxy, 96.0),
            "xywh_to_xyxy": (np.abs(xyxy),),
            "xyxy_to_xywh": (xyxy,)}[name]
    want = np.asarray(getattr(jbox, name)(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args],
        **kw))
    got = getattr(pbox, name)(*[
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args], **kw).numpy()
    if name in ("encode_boxes", "decode_boxes"):
        # log and exp are each library's own: within their last bit
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
