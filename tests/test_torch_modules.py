"""Each module of the port's eval slice against its JAX counterpart, on the
same numpy inputs and bridged numpy weights. Features agree to rtol = atol =
1e-4 (float32 convolutions summed in another order); proposals and detections
agree exactly in order, validity and labels, boxes to atol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.layers import FrozenBatchNorm as JFrozenBN
from da_detect_tpu.models import anchors as janchors
from da_detect_tpu.models import box_head as jbox
from da_detect_tpu.models import rpn as jrpn
from da_detect_tpu.models.backbone import build_backbone as j_build_backbone
from da_detect_tpu.models.backbone.resnet import Bottleneck as JBottleneck
from da_detect_tpu.models.backbone.resnet import ResNetHead as JResNetHead
from da_detect_tpu.ops import box_ops as jbox_ops
from da_detect_tpu.structures.image_batch import ImageBatch as JImageBatch
from da_detect_tpu_torch.layers import FrozenBatchNorm
from da_detect_tpu_torch.models import anchors as tanchors
from da_detect_tpu_torch.models import box_head as tbox
from da_detect_tpu_torch.models import rpn as trpn
from da_detect_tpu_torch.models.backbone import build_backbone
from da_detect_tpu_torch.models.backbone.resnet import Bottleneck, ResNetHead
from da_detect_tpu_torch.ops import box_ops as tbox_ops
from da_detect_tpu_torch.structures import ImageBatch
from tests.test_nms import make_cluster_boxes
from tests.torch_harness import (module_state, nhwc_to_torch,
                                 random_variables, tiny_cfgs, torch_to_nhwc)

FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(module, seed, *args, scales=None):
    shapes = jax.eval_shape(lambda: module.init(KEY, *args))
    return random_variables(shapes, seed, scales)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     (10.0, 10.0, 5.0, 5.0)])
def test_box_ops_match_jax(weights):
    """Legacy +1 geometry and the box coder, including the decode clamp
    (large dw/dh) and boxes that leave the frame."""
    rng = np.random.RandomState(12)
    boxes, _ = make_cluster_boxes(40, 12, spread=150.0)
    others, _ = make_cluster_boxes(30, 13, spread=150.0)
    deltas = (rng.randn(40, 8) * 2.0).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tbox_ops.box_area(t(boxes)).numpy(),
                               np.asarray(jbox_ops.box_area(boxes)),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tbox_ops.box_iou(t(boxes), t(others)).numpy(),
        np.asarray(jbox_ops.box_iou(boxes, others)))
    enc = tbox_ops.encode_boxes(t(others[:20]), t(boxes[:20]), weights)
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(jbox_ops.encode_boxes(
            others[:20], boxes[:20], weights)), rtol=1e-5, atol=1e-5)
    dec = tbox_ops.decode_boxes(t(deltas), t(boxes), weights)
    np.testing.assert_allclose(
        dec.numpy(),
        np.asarray(jbox_ops.decode_boxes(deltas, boxes, weights)),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        tbox_ops.decode_boxes(enc, t(boxes[:20]), weights).numpy(),
        others[:20], atol=1e-3)
    clipped = tbox_ops.clip_boxes(dec.reshape(40, 2, 4), 120.0, 160.0)
    np.testing.assert_array_equal(
        clipped.numpy(), np.asarray(jbox_ops.clip_boxes(
            np.asarray(dec.reshape(40, 2, 4)), 120.0, 160.0)))
    np.testing.assert_array_equal(
        tbox_ops.min_size_mask(clipped, 12.0).numpy(),
        np.asarray(jbox_ops.min_size_mask(clipped.numpy(), 12.0)))


def test_frozen_batchnorm():
    x = np.random.RandomState(0).randn(2, 5, 7, 6).astype(np.float32)
    v = _init(JFrozenBN(), 1, x)
    want = np.asarray(JFrozenBN().apply(v, x))
    bn = FrozenBatchNorm(6)
    bn.load_state_dict({"weight": torch.from_numpy(v["frozen"]["scale"]),
                        "bias": torch.from_numpy(v["frozen"]["bias"])})
    assert not list(bn.parameters())  # buffers only: nothing trains
    np.testing.assert_allclose(torch_to_nhwc(bn(nhwc_to_torch(x))), want,
                               **FEAT_TOL)


@pytest.mark.parametrize("cin,cout,stride,stride_in_1x1", [
    (16, 32, 2, True), (16, 32, 2, False), (32, 32, 1, True)])
def test_bottleneck(cin, cout, stride, stride_in_1x1):
    x = np.random.RandomState(2).randn(2, 12, 10, cin).astype(np.float32)
    jmod = JBottleneck(bottleneck_channels=8, out_channels=cout,
                       stride=stride, stride_in_1x1=stride_in_1x1)
    v = _init(jmod, 3, x)
    tmod = Bottleneck(cin, 8, cout, stride=stride,
                      stride_in_1x1=stride_in_1x1)
    tmod.load_state_dict(module_state(v, "backbone/body/layer1/block0",
                                      "backbone.body.layer1.0."))
    assert (tmod.downsample is None) == (cin == cout and stride == 1)
    np.testing.assert_allclose(torch_to_nhwc(tmod(nhwc_to_torch(x))),
                               np.asarray(jmod.apply(v, x)), **FEAT_TOL)


def test_r50_c4_body():
    jcfg, pcfg = tiny_cfgs()
    jmod, jspec = j_build_backbone(jcfg)
    tmod, tspec = build_backbone(pcfg)
    assert tspec == type(tspec)(jspec.out_channels, jspec.strides)
    x = np.random.RandomState(4).randn(1, 64, 96, 3).astype(np.float32)
    v = _init(jmod, 5, x)
    tmod.load_state_dict(module_state(v, "backbone", "backbone."))
    want = np.asarray(jmod.apply(v, x)[0])
    got = torch_to_nhwc(tmod(nhwc_to_torch(x))[0])
    assert got.shape == want.shape == (1, 4, 6, 128)
    np.testing.assert_allclose(got, want, **FEAT_TOL)
    # FREEZE_CONV_BODY_AT = 2: the stem and res2 take no gradient
    frozen = {n.split(".")[1] for n, p in tmod.named_parameters()
              if not p.requires_grad}
    assert frozen == {"stem", "layer1"}


def test_res5_head():
    x = np.random.RandomState(6).randn(3, 14, 14, 128).astype(np.float32)
    jmod = JResNetHead(width_per_group=8, res2_out_channels=32)
    v = _init(jmod, 7, x)
    tmod = ResNetHead(width_per_group=8, res2_out_channels=32)
    tmod.load_state_dict(module_state(v, "feature_extractor/head",
                                      "roi_heads.box.feature_extractor.head."))
    want = np.asarray(jmod.apply(v, x))
    got = torch_to_nhwc(tmod(nhwc_to_torch(x)))
    assert got.shape == want.shape == (3, 7, 7, 256)
    np.testing.assert_allclose(got, want, **FEAT_TOL)


def test_anchors_match():
    jcfg, pcfg = tiny_cfgs()
    jgen = janchors.make_anchor_generator(jcfg)
    tgen = tanchors.make_anchor_generator(pcfg)
    assert tgen.num_anchors_per_location == jgen.num_anchors_per_location
    np.testing.assert_array_equal(tgen.anchors_for_shapes([(38, 76)])[0],
                                  jgen.anchors_for_shapes([(38, 76)])[0])


def _proposal_inputs(seed):
    """RPN head outputs on an 8x12 C4 map (1440 anchors) with spread
    objectness, and per-image valid sizes inside a 128x192 canvas."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(2, 8, 12, 128).astype(np.float32)
    head = jrpn.RPNHead(num_anchors=15)
    v = _init(head, seed + 1, [feat], scales={"cls_logits/kernel": 30.0})
    logits, deltas = head.apply(v, [feat])
    sizes = np.asarray([[128, 192], [100, 150]], np.float32)
    return feat, v, np.asarray(logits[0]), np.asarray(deltas[0]), sizes


def test_rpn_head():
    feat, v, logits, deltas, _ = _proposal_inputs(8)
    tmod = trpn.RPNHead(128, 15)
    tmod.load_state_dict(module_state(v, "rpn_head", "rpn.head."))
    t_logits, t_deltas = tmod([nhwc_to_torch(feat)])
    np.testing.assert_allclose(torch_to_nhwc(t_logits[0]), logits,
                               **FEAT_TOL)
    np.testing.assert_allclose(torch_to_nhwc(t_deltas[0]), deltas,
                               **FEAT_TOL)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_select_proposals(impl):
    """The port's selection fed the JAX head's logits and deltas."""
    _, _, logits, deltas, sizes = _proposal_inputs(9)
    anchors = janchors.AnchorGenerator((32, 64, 128, 256, 512),
                                       (0.5, 1.0, 2.0), (16,)
                                       ).anchors_for_shapes([(8, 12)])
    # 500 slots: more than survive NMS, so the invalid tail is compared too
    kw = dict(pre_nms_top_n=600, post_nms_top_n=500, fpn_post_nms_top_n=500,
              nms_thresh=0.7, min_size=0, is_train=False)
    want = jrpn.select_proposals([jnp.asarray(a) for a in anchors],
                                 [jnp.asarray(logits)], [jnp.asarray(deltas)],
                                 jnp.asarray(sizes), **kw)
    got = trpn.select_proposals([torch.from_numpy(a) for a in anchors],
                                [nhwc_to_torch(logits)],
                                [nhwc_to_torch(deltas)],
                                torch.from_numpy(sizes), **kw, impl=impl)
    valid = np.asarray(want.valid)
    assert 10 < valid.sum(axis=1).min() and valid.sum() < valid.size
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)


def _detection_inputs(seed, b=2, p=64, c=9):
    rng = np.random.RandomState(seed)
    boxes = np.stack([make_cluster_boxes(p, seed + i, spread=150.0)[0]
                      for i in range(b)])
    logits = (3.0 * rng.randn(b, p, c)).astype(np.float32)
    deltas = (0.5 * rng.randn(b, p, 4 * c)).astype(np.float32)
    valid = rng.rand(b, p) > 0.15
    sizes = np.asarray([[200, 220], [160, 190]], np.float32)[:b]
    return logits, deltas, boxes, valid, sizes


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_postprocess_detections(impl):
    """Per-class NMS by class offset, fed the same logits and deltas."""
    logits, deltas, boxes, valid, sizes = _detection_inputs(10)
    kw = dict(score_thresh=0.05, nms_thresh=0.3, detections_per_img=100,
              reg_weights=(10.0, 10.0, 5.0, 5.0))
    want = jbox.postprocess_detections(*map(jnp.asarray, (
        logits, deltas, boxes, valid, sizes)), **kw)
    got = tbox.postprocess_detections(*map(torch.from_numpy, (
        logits, deltas, boxes, valid, sizes)), **kw, impl=impl)
    w_valid = np.asarray(want.valid)
    assert 20 < w_valid.sum(axis=1).min() and w_valid.sum() < w_valid.size
    np.testing.assert_array_equal(got.valid.numpy(), w_valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("to_bgr255", [True, False])
def test_image_batch_normalized_uint8(to_bgr255):
    rng = np.random.RandomState(11)
    pixels = rng.randint(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    sizes = np.asarray([[16, 24], [11, 17]], np.int32)
    mean, std = (102.9801, 115.9465, 122.7717), (57.0, 58.0, 59.0)
    jb = JImageBatch(images=jnp.asarray(pixels), sizes=jnp.asarray(sizes),
                     orig_sizes=jnp.asarray(sizes),
                     is_source=jnp.ones(2, bool))
    tb = ImageBatch(images=nhwc_to_torch(pixels),
                    sizes=torch.from_numpy(sizes),
                    orig_sizes=torch.from_numpy(sizes),
                    is_source=torch.ones(2, dtype=torch.bool))
    want = np.asarray(jb.normalized(mean, std, to_bgr255))
    got = tb.normalized(mean, std, to_bgr255)
    assert got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(torch_to_nhwc(got), want, rtol=1e-6, atol=1e-5)
    assert np.all(torch_to_nhwc(got)[1, 11:] == 0.0)
