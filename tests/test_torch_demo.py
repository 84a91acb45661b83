"""The port's demo package (``da_detect_tpu_torch/demo``) on the CPU:
``COCODemo`` against the JAX package's on the same weights and the same
prepared canvas, its overlays, and the folder CLI, the camera loop (over a
stubbed capture) and the walkthrough.

Config: the keypoint R-CNN YAML narrowed for the CPU (stem 8, width 8, res2
16, FPN 16, MLP head 32, keypoint convs 16, canvas 64x96, 100 -> 20
proposals, float32), random weights from numpy with the score layers
spread; the box head's NMS at IoU 0.9 so that the small canvas keeps a few
detections.

Tolerances: detections as twins (same label, boxes within 1e-3 px in the
original image, scores within 1e-4: the class logits' x 30 spread turns
float32 rounding into about 1e-5 of a score), keypoints x and y within
1e-3 px and scores within 1e-5, as tests/test_torch_keypoint.py.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu.data.transforms import apply_geometry as j_apply_geometry
from da_detect_tpu.data.transforms import \
    normalize_and_pad as j_normalize_and_pad
from da_detect_tpu.demo.predictor import COCODemo as JCOCODemo
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.demo import (demo_walkthrough, draw_detection,
                                      predictor, webcam)
from da_detect_tpu_torch.demo.predictor import COCODemo
from da_detect_tpu_torch.structures.image_batch import ImageBatch
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.torch_harness import KEYPOINT_YAMLS, random_variables

BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
KP_XY_ATOL, KP_SCORE_ATOL = 1e-3, 1e-5
NARROW = ["MODEL.WEIGHT", "",
          "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
          "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
          "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
          "MODEL.BACKBONE.OUT_CHANNELS", "16",
          "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "32",
          "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", str((16,) * 8),
          "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100",
          "MODEL.RPN.POST_NMS_TOP_N_TEST", "20",
          "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "20",
          "MODEL.ROI_HEADS.NMS", "0.9",
          "TPU.IMAGE_SHAPE", "(64, 96)",
          "TPU.COMPUTE_DTYPE", "float32",
          "TPU.APPROX_TOPK", "False",
          "INPUT.MIN_SIZE_TEST", "60",
          "INPUT.MAX_SIZE_TEST", "96"]
SCALES = {"rpn_head/cls_logits/kernel": 30.0,
          "rpn_head/bbox_pred/kernel": 0.03,
          "predictor/cls_score/kernel": 30.0,
          "predictor/bbox_pred/kernel": 0.1,
          "backbone/body/stem/conv1/kernel": 0.01}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(getter, yaml=KEYPOINT_YAMLS[0], extra=()):
    cfg = getter()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(NARROW + list(extra))
    return cfg


def _image(seed, hw=(50, 70)):
    return (np.random.RandomState(seed).rand(*hw, 3) * 255).astype(np.uint8)


class _ShapesOnlyInit:
    """The JAX model with ``init`` giving the variables' shapes alone (its
    random init, run op by op, is most of the JAX demo's construction, and
    the test replaces the variables anyway)."""

    def __init__(self, model):
        self.model = model

    def init(self, rngs, *args, **kwargs):
        return jax.eval_shape(lambda: self.model.init(rngs, *args, **kwargs))

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


@pytest.fixture(scope="module")
def demos():
    """(port COCODemo, JAX COCODemo) of the narrowed keypoint YAML on the
    same numpy variables, confidence threshold 0."""
    from da_detect_tpu.demo import predictor as j_predictor

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_predictor, "build_detection_model",
                   lambda cfg: _ShapesOnlyInit(j_build(cfg)))
        jdemo = JCOCODemo(_cfg(j_get_cfg), confidence_threshold=0.0)
    shapes = jdemo.variables
    variables = jax.tree.map(np.asarray,
                             random_variables(shapes, seed=3, scales=SCALES))
    jdemo.variables = jax.tree.map(jnp.asarray, variables)
    demo = COCODemo(_cfg(get_cfg), confidence_threshold=0.0, device="cpu")
    load_jax_variables(demo.model, variables)
    return demo, jdemo


def _twins(got, want):
    """Each of JAX's detections has its own twin among the port's: the same
    label, the box within BOX_ATOL, the score within SCORE_ATOL, and its
    keypoints within KP_XY_ATOL / KP_SCORE_ATOL."""
    free = np.ones(len(got[0]), bool)
    for box, score, label, kp in zip(*want):
        ok = free & (got[2] == label) \
            & (np.abs(got[0] - box).max(-1) <= BOX_ATOL) \
            & (np.abs(got[1] - score) <= SCORE_ATOL)
        assert ok.any(), (box, score, label)
        i = int(np.argmax(ok))
        free[i] = False
        np.testing.assert_allclose(got[3][i][:, :2], kp[:, :2], rtol=0,
                                   atol=KP_XY_ATOL)
        np.testing.assert_allclose(got[3][i][:, 2], kp[:, 2], rtol=0,
                                   atol=KP_SCORE_ATOL)


@pytest.mark.parametrize("hw", [(50, 70), (70, 50)],
                         ids=["landscape", "portrait"])
def test_compute_prediction_matches_jax(demos, hw):
    """``COCODemo.predict`` on the JAX demo's own prepared canvas (cv2's
    resize, its portrait transpose for a portrait image): detections above
    the threshold and their keypoints in the original image, as JAX's
    ``compute_prediction`` gives them. The port's own preparation gives a
    canvas of the same geometry."""
    demo, jdemo = demos
    img = _image(1, hw)
    want = jdemo.compute_prediction(img)
    assert len(want[0]) >= 2
    cfg = demo.cfg
    resized, _, (rh, rw) = j_apply_geometry(
        img, np.zeros((0, 4), np.float32), min_size=cfg.INPUT.MIN_SIZE_TEST,
        max_size=cfg.INPUT.MAX_SIZE_TEST, hflip=False)
    canvas = demo.canvas if rh <= rw else demo.canvas[::-1]
    padded = j_normalize_and_pad(resized, canvas, cfg.INPUT.PIXEL_MEAN,
                                 cfg.INPUT.TO_BGR255, cfg.INPUT.PIXEL_STD)
    batch = ImageBatch(
        images=torch.from_numpy(padded)[None].permute(0, 3, 1, 2),
        sizes=torch.tensor([[rh, rw]], dtype=torch.int32),
        orig_sizes=torch.tensor([hw], dtype=torch.int32),
        is_source=torch.ones(1, dtype=torch.bool))
    got = demo.predict(batch)
    assert len(got) == 4 and got[3].shape == (len(got[0]), 17, 3)
    assert len(got[0]) == len(want[0])
    _twins(got, want)
    own = demo.prepare(img)
    assert tuple(own.images.shape[2:]) == tuple(canvas)
    assert own.sizes.tolist() == [[rh, rw]] and own.images.dtype \
        == torch.uint8
    boxes, scores, labels, kps = demo.compute_prediction(img)
    assert kps.shape == (len(boxes), 17, 3) and len(scores) == len(labels)


def test_overlays(demos):
    """The keypoint model's overlay (boxes, skeletons, names) keeps the
    image's shape; the mask model's contours and its heatmap montage
    (JET, masks_per_dim x masks_per_dim maps of 28 x 28); the palette
    gives classes their own colours; the threshold keeps what it should."""
    demo, _ = demos
    img = _image(2)
    out = demo.run_on_opencv_image(img)
    assert out.shape == img.shape and out.dtype == np.uint8
    assert not np.array_equal(out, img)
    colors = demo.compute_colors_for_labels(np.array([1, 2]))
    assert colors[0] != colors[1]
    strict = COCODemo(demo.cfg, confidence_threshold=2.0, device="cpu")
    assert len(strict.compute_prediction(img)[0]) == 0
    assert strict.run_on_opencv_image(img).shape == img.shape
    mask_cfg = _cfg(get_cfg, "configs/cityscapes/"
                    "e2e_mask_rcnn_R_50_FPN_1x_cocostyle.yaml",
                    ["MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(16, 16, 16, 16)"])
    mdemo = COCODemo(mask_cfg, confidence_threshold=0.0, device="cpu")
    boxes, _, _, masks, probs = mdemo.compute_prediction(img)
    assert masks.shape == (len(boxes),) + img.shape[:2] and masks.dtype \
        == bool
    assert mdemo.run_on_opencv_image(img).shape == img.shape
    heat = COCODemo(mask_cfg, confidence_threshold=0.0, device="cpu",
                    show_mask_heatmaps=True, masks_per_dim=2)
    assert heat.run_on_opencv_image(img).shape == (56, 56, 3)


def test_overlays_need_cv2(demos, monkeypatch):
    demo, _ = demos
    monkeypatch.setattr(predictor, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        demo.run_on_opencv_image(_image(3))
    boxes, scores, labels, kps = demo.compute_prediction(_image(3))
    assert kps.shape[1:] == (17, 3)


def test_draw_detection_over_a_folder(tmp_path):
    """``draw_detection.main`` draws every PNG of a folder into the output
    folder, each of its image's shape."""
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    for i in range(2):
        cv2.imwrite(str(src / f"img_{i}.png"), _image(10 + i, (48, 80)))
    paths = draw_detection.main([
        "--config-file", KEYPOINT_YAMLS[0], "--input-dir", str(src),
        "--output-dir", str(dst), "--confidence-threshold", "0.0",
        "--device", "cpu"] + NARROW)
    assert len(paths) == 2
    for i in range(2):
        out = cv2.imread(str(dst / f"img_{i}.png"))
        assert out is not None and out.shape == (48, 80, 3)


def test_webcam_over_a_stubbed_capture(monkeypatch):
    """``webcam.main`` shows a frame a read until the capture runs dry,
    then releases it and closes its windows."""
    frames = [_image(20 + i, (48, 80)) for i in range(3)]
    shown, events = [], []

    class Capture:
        def __init__(self, index):
            events.append(("open", index))

        def read(self):
            return (True, frames.pop(0)) if frames else (False, None)

        def release(self):
            events.append(("release",))

    monkeypatch.setattr(cv2, "VideoCapture", Capture)
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append(img))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    monkeypatch.setattr(cv2, "destroyAllWindows",
                        lambda: events.append(("closed",)))
    n = webcam.main(["--config-file", KEYPOINT_YAMLS[0], "--camera", "2",
                     "--device", "cpu"] + NARROW)
    assert n == 3 and [s.shape for s in shown] == [(48, 80, 3)] * 3
    assert events == [("open", 2), ("release",), ("closed",)]


def test_walkthrough_runs(tmp_path, monkeypatch):
    """The notebook's counterpart builds its COCO demo (narrowed R-50-C4,
    81 classes), draws the synthetic image and writes the overlay."""
    monkeypatch.chdir(tmp_path)
    narrow = ["MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
              "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
              "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
              "TPU.IMAGE_SHAPE", (64, 96), "TPU.COMPUTE_DTYPE", "float32",
              "INPUT.MIN_SIZE_TEST", 60, "INPUT.MAX_SIZE_TEST", 96]
    demo = demo_walkthrough.build_demo(confidence_threshold=0.0,
                                       device="cpu", opts=narrow)
    img = demo_walkthrough.load_bgr(None)
    out = demo.run_on_opencv_image(img)
    assert out.shape == img.shape and out.dtype == img.dtype
    assert demo_walkthrough.main([], device="cpu", opts=narrow) == 0
    assert os.path.exists(tmp_path / "demo.pred.png")
