"""The port's evaluation path against the JAX package's: the COCO evaluator,
the expected-results gate, ``compute_on_dataset`` and the test-time
augmentation (``engine/bbox_aug.py``), on the tiny on-disk triple of
``tests/data_factory.py``.

Tolerances: the evaluator's numbers equal JAX's exactly (float64, the same
arithmetic); the TTA merge keeps exactly JAX's indices in JAX's order, score
ties included. ``compute_on_dataset`` and the TTA pipeline run the
narrowed flagship model (``torch_harness.tiny_cfgs``, float32) with the same
numpy variables in both packages and the same pixels (the JAX loader's
canvases for ``compute_on_dataset``; for the TTA, whose loaders are built
inside it, the port's resize is replaced by cv2's, as the resizes differ by
one level by design): boxes within 1e-3 pixels, scores within 1e-5, labels
and the order of detections exactly, as ``tests/test_torch_slice.py``.
"""

import importlib
import json

import cv2
import jax
import numpy as np
import pytest
import torch

import tests.data_factory as factory
from da_detect_tpu.data import make_data_loader as j_make_data_loader
from da_detect_tpu.data.datasets import COCODataset as JCOCODataset
from da_detect_tpu.data.evaluation.coco_eval import \
    CocoEvaluator as JCocoEvaluator
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu_torch.data import transforms
from da_detect_tpu_torch.data.datasets import COCODataset
from da_detect_tpu_torch.data.evaluation import evaluate
from da_detect_tpu_torch.data.evaluation.coco_eval import CocoEvaluator
from da_detect_tpu_torch.engine import bbox_aug, inference
from da_detect_tpu_torch.entry import prepare_model
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.structures.image_batch import ImageBatch
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.torch_harness import (random_variables, register_port_tiny_catalog,
                                 tiny_cfgs)

# the modules (the package's __init__ exports a function ``inference``)
j_bbox_aug = importlib.import_module("da_detect_tpu.engine.bbox_aug")
j_inference = importlib.import_module("da_detect_tpu.engine.inference")

# the slice tests' score spread; and the stem scaled by 1/100: the loaders
# give pixels of 0-255 less the mean where the slice tests feed unit noise,
# and unscaled, the random box deltas run into the decode clamp, where float32
# noise moves a box by more than the tolerance
SCORE_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
                "predictor/cls_score/kernel": 30.0,
                "backbone/body/stem/conv1/kernel": 0.01}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    dirs = factory.make_triplet_datasets(str(tmp_path_factory.mktemp("tiny")))
    factory.register_tiny_catalog(dirs)
    with pytest.MonkeyPatch.context() as mp:
        register_port_tiny_catalog(dirs, mp)
        yield dirs


@pytest.fixture(scope="module")
def crowd_datasets(tiny, tmp_path_factory):
    """(port, JAX) COCODataset of the clean images, with a crowd region and
    an ignored box added to every other image."""
    img_dir, ann_file = tiny["clean"]
    with open(ann_file) as f:
        ann = json.load(f)
    extra = []
    for img in ann["images"][::2]:
        for key in ("iscrowd", "ignore"):
            extra.append({"id": 1000 + len(extra), "image_id": img["id"],
                          "category_id": 1, "bbox": [5, 5, 60, 40],
                          "area": 2400, "iscrowd": int(key == "iscrowd"),
                          "ignore": int(key == "ignore")})
    ann["annotations"] += extra
    path = tmp_path_factory.mktemp("crowd") / "ann.json"
    path.write_text(json.dumps(ann))
    return (COCODataset(str(path), img_dir, False),
            JCOCODataset(str(path), img_dir, False))


def _predictions(dataset, seed):
    """Jittered ground truth, false positives, an unknown label, and scores
    on a coarse grid (ties)."""
    rng = np.random.RandomState(seed)
    preds = {}
    for idx in range(len(dataset)):
        s = dataset.sample(idx)
        n_fp = rng.randint(0, 6)
        fp = rng.uniform(0, 100, (n_fp, 2))
        boxes = np.concatenate([
            s["boxes"] + rng.uniform(-4, 4, s["boxes"].shape),
            np.concatenate([fp, fp + rng.uniform(5, 50, (n_fp, 2))], 1)])
        labels = np.concatenate([s["labels"], rng.randint(1, 4, n_fp)])
        scores = np.round(rng.uniform(0.05, 1.0, len(boxes)), 1)
        preds[s["image_id"]] = dict(boxes=boxes.astype(np.float32),
                                    scores=scores.astype(np.float32),
                                    labels=labels)
    return preds


@pytest.mark.parametrize("seed", range(4))
def test_coco_eval_matches_jax(crowd_datasets, seed):
    mine, ref = crowd_datasets
    preds = _predictions(ref, seed)
    got = CocoEvaluator(mine).evaluate(preds)
    want = JCocoEvaluator(ref).evaluate(preds)
    assert got == want


def test_perfect_predictions_give_ap_one(crowd_datasets):
    mine, _ = crowd_datasets
    preds = {}
    for idx in range(len(mine)):
        s = mine.sample(idx)
        preds[s["image_id"]] = dict(
            boxes=s["boxes"], labels=s["labels"],
            scores=np.linspace(0.9, 0.5, len(s["boxes"])))
    res, per_cat = CocoEvaluator(mine).evaluate(preds)
    assert res["AP"] == 1.0 and res["AP50"] == 1.0, res
    assert all(r["AP"] == 1.0 for r in per_cat.values())


def test_evaluate_writes_results_and_refuses_what_is_not_ported(
        crowd_datasets, tiny, tmp_path):
    mine, _ = crowd_datasets
    preds = _predictions(mine, 0)
    res = evaluate(mine, preds, output_folder=str(tmp_path))
    assert (tmp_path / "coco_results.json").exists()
    assert set(res) == {"bbox"}
    # the Cityscapes protocol is ported (tests/test_torch_eval_protocols.py)
    # and, with the mask head, its mask protocol and COCO segm
    # (tests/test_torch_mask_eval.py), and with the keypoint head COCO's
    # keypoint protocol (OKS, tests/test_torch_keypoint.py)
    cs = evaluate(mine, preds, style="cityscapes")
    assert set(cs) == {"bbox"} and "allAp50%" in cs["bbox"]
    assert set(evaluate(mine, preds, iou_types=("bbox", "segm"),
                        style="cityscapes")) == {"bbox", "segm"}
    with pytest.raises(ValueError, match="EVAL_STYLE"):
        evaluate(mine, preds, style="voc")
    assert set(evaluate(mine, preds, iou_types=("bbox", "segm"))) \
        == {"bbox", "segm"}
    plain = COCODataset(tiny["clean"][1], tiny["clean"][0], False)
    kp_preds = _predictions(plain, 1)
    rng = np.random.RandomState(2)
    for p in kp_preds.values():
        b = p["boxes"][:, None]
        xy = b[..., :2] + rng.uniform(0, 1, (len(b), 17, 2)) * (
            b[..., 2:] - b[..., :2])
        p["keypoints"] = np.concatenate(
            [xy, np.ones((len(b), 17, 1))], -1).astype(np.float32)
    res = evaluate(plain, kp_preds, iou_types=("bbox", "keypoints"))
    assert set(res) == {"bbox", "keypoints"} and "AR20" in res["keypoints"]
    with pytest.raises(ValueError, match="iou type"):
        evaluate(mine, preds, iou_types=("bbox", "parts"))


@pytest.mark.parametrize("expected,raises", [
    ((("bbox", "AP50", 0.5, 0.2),), False),
    ((("bbox", "AP", 0.5, 0.2), ("bbox", "AP50", 0.6, 0.1)), False),
    ((("bbox", "AP50", 5.0, 0.1),), True),
    ((("bbox", "AP", 0.5, 0.2), ("bbox", "AP75", -1.0, 0.1)), True),
])
def test_check_expected_results_matches_jax(expected, raises):
    results = {"bbox": {"AP": 0.45, "AP50": 0.61, "AP75": 0.3}}
    outcomes = []
    for check in (inference.check_expected_results,
                  j_inference.check_expected_results):
        try:
            check(results, expected, 4.0)
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == raises


# ------------------------------------------------------- models on datasets

def _eval_cfgs():
    jcfg, pcfg = tiny_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.TPU.IMAGE_SHAPE = (0, 0)
        cfg.DATALOADER.SIZE_DIVISIBILITY = 32
        cfg.DATALOADER.NUM_WORKERS = 0
        cfg.DATALOADER.STAGE_CACHE = False
        cfg.INPUT.MIN_SIZE_TEST = 120
        cfg.INPUT.MAX_SIZE_TEST = 160
        cfg.TEST.IMS_PER_BATCH = 3
        cfg.DATASETS.TEST = ("tiny_foggy_cocostyle",)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def models(tiny):
    """(JAX cfg, JAX model, variables, port cfg, port model) sharing numpy
    variables."""
    jcfg, pcfg = _eval_cfgs()
    jmodel = j_build(jcfg)
    loader, _ = j_make_data_loader(jcfg, is_train=False)
    batch, _ = next(iter(loader))
    loader.close()
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, batch))
    variables = random_variables(shapes, seed=1, scales=SCORE_SCALES)
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    return jcfg, jmodel, variables, pcfg, prepare_model(model, CPU)


def _assert_predictions_match(got, want):
    assert got.keys() == want.keys()
    for img_id, w in want.items():
        g = got[img_id]
        assert len(w["scores"]) > 0
        np.testing.assert_array_equal(g["labels"], np.asarray(w["labels"]))
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], np.asarray(w["scores"]),
                                   rtol=0, atol=1e-5)


def test_compute_on_dataset_matches_jax(models):
    """The JAX eval loader's batches (8 images, batches of 3, the last
    padded) through both packages' compute_on_dataset."""
    jcfg, jmodel, variables, _, model = models
    loader, _ = j_make_data_loader(jcfg, is_train=False)
    batches = list(loader)
    assert batches[-1][1][-1] is None
    want = j_inference.compute_on_dataset(jmodel, variables, batches)
    mine = [(ImageBatch(
        images=torch.from_numpy(np.asarray(b.images)).permute(0, 3, 1, 2),
        sizes=torch.from_numpy(np.asarray(b.sizes)),
        orig_sizes=torch.from_numpy(np.asarray(b.orig_sizes)),
        is_source=torch.from_numpy(np.asarray(b.is_source))), ids)
        for b, ids in batches]
    got = inference.compute_on_dataset(model, mine)
    assert len(got) == 8
    _assert_predictions_match(got, want)


def _candidates(seed):
    """Per-pass-like candidates: clusters of overlapping boxes over three
    labels, scores on a coarse grid (ties), some duplicated boxes."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(20, 140, (6, 2))
    n = 90
    c = centres[rng.randint(0, 6, n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(10, 40, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    boxes[60:70] = boxes[50:60]
    scores = np.round(rng.uniform(0.05, 1.0, n), 1).astype(np.float32)
    labels = rng.randint(1, 4, n).astype(np.int64)
    return boxes, scores, labels


@pytest.mark.parametrize("max_dets", [100, 12])
@pytest.mark.parametrize("seed", range(3))
def test_tta_merge_keeps_jax_indices(seed, max_dets):
    boxes, scores, labels = _candidates(seed)
    want = j_bbox_aug._np_per_class_nms(boxes, scores, labels, 0.3, max_dets)
    for impl in ("plain", "cuda"):  # "cuda" on the CPU: the wrapper's plain
        got = bbox_aug.merge_per_class(boxes, scores, labels, 0.3, max_dets,
                                       device=CPU, impl=impl)
        np.testing.assert_array_equal(got, want)
    assert len(want) < len(boxes)


def test_tta_merge_of_nothing():
    got = bbox_aug.merge_per_class(np.zeros((0, 4), np.float32),
                                   np.zeros(0, np.float32),
                                   np.zeros(0, np.int64), 0.3, 100,
                                   device=CPU, impl="plain")
    assert got.shape == (0,)


def test_compute_on_dataset_aug_matches_jax(models, monkeypatch):
    """Four passes: the test scale, its flip, scale 96 at max size 128 and
    its flip; the merged detections of every image."""
    jcfg, jmodel, variables, pcfg, model = models
    for cfg in (jcfg, pcfg):
        cfg.TEST.BBOX_AUG.ENABLED = True
        cfg.TEST.BBOX_AUG.H_FLIP = True
        cfg.TEST.BBOX_AUG.SCALES = (96,)
        cfg.TEST.BBOX_AUG.MAX_SIZE = 128
        cfg.TEST.BBOX_AUG.SCALE_H_FLIP = True
    assert len(bbox_aug.tta_passes(pcfg)) == 4
    monkeypatch.setattr(transforms, "resize_u8", lambda img, rh, rw:
                        cv2.resize(img, (rw, rh),
                                   interpolation=cv2.INTER_LINEAR))
    want, _ = j_bbox_aug.compute_on_dataset_aug(jmodel, variables, jcfg,
                                                "tiny_foggy_cocostyle")
    got, dataset = bbox_aug.compute_on_dataset_aug(
        model, pcfg, "tiny_foggy_cocostyle", device=CPU)
    assert len(dataset) == 8
    _assert_predictions_match(got, want)
