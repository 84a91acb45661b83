"""The port's mask host code against the JAX package's, exactly on the same
inputs: ``rasterize_polygons``, the four ``masker`` functions, the train
loader's GT masks (cold and staged, flipped and not), ``compute_on_dataset``
with masks, and the COCO ``segm`` and Cityscapes ``use_masks`` numbers;
the segm cases of tests/test_coco_eval_adversarial.py through the port.

Data: tests/data_factory.py's tiny tree (120x160, 1 to 3 boxes an image)
with each annotation's rectangle replaced by random polygons inside its box
(one or two an instance, 3 to 8 vertices, some crossing themselves), so the
masks are not their boxes. The model: the Cityscapes mask YAML narrowed as
tests/test_torch_mask.py narrows it, float32.
"""

import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

import tests.data_factory as factory
import tests.test_coco_eval_adversarial as adv
from da_detect_tpu.data import build as j_build
from da_detect_tpu.data import masker as jmasker
from da_detect_tpu.data import transforms as jtransforms
from da_detect_tpu.data.datasets import COCODataset as JCOCODataset
from da_detect_tpu.data.evaluation import evaluate as j_evaluate
from da_detect_tpu.models import build_detection_model as j_build_model
from da_detect_tpu_torch.data import build, image_io, masker, transforms
from da_detect_tpu_torch.data.datasets import COCODataset
from da_detect_tpu_torch.data.evaluation import coco_eval, evaluate
from da_detect_tpu_torch.entry import prepare_model
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.structures.image_batch import ImageBatch
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_data import _cfgs, _drain
from tests.torch_harness import (mask_cfgs, random_variables,
                                 register_port_tiny_catalog)

CPU = torch.device("cpu")
# the modules (each engine package's __init__ exports a function
# ``inference``)
inference = importlib.import_module("da_detect_tpu_torch.engine.inference")
j_inference = importlib.import_module("da_detect_tpu.engine.inference")


def _polygons(rng, box):
    """One or two random polygons inside ``box`` (x1, y1, x2, y2), 3 to 8
    vertices each, in the COCO flat list form."""
    x1, y1, x2, y2 = box
    out = []
    for _ in range(rng.randint(1, 3)):
        n = rng.randint(3, 9)
        xs = rng.uniform(x1, x2, n)
        ys = rng.uniform(y1, y2, n)
        out.append([round(float(v), 2) for xy in zip(xs, ys) for v in xy])
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree with polygon masks, registered in both catalogs."""
    root = tmp_path_factory.mktemp("mask_tree")
    dirs = factory.make_triplet_datasets(str(root))
    ann = dirs["clean"][1]
    with open(ann) as f:
        coco = json.load(f)
    rng = np.random.RandomState(11)
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        a["segmentation"] = _polygons(rng, (x, y, x + w, y + h))
    with open(ann, "w") as f:
        json.dump(coco, f)
    factory.register_tiny_catalog(dirs)
    with pytest.MonkeyPatch.context() as mp:
        register_port_tiny_catalog(dirs, mp)
        yield dirs


# ---------------------------------------------------------------- masker

def test_rasterize_polygons_matches_jax():
    rng = np.random.RandomState(0)
    for i in range(40):
        box = np.sort(rng.uniform(0, 300, 4).reshape(2, 2), 0).T.ravel()
        box = (box[0], box[2], box[1], box[3]) if i % 7 else (5, 5, 5, 5)
        segs = _polygons(rng, (box[0] - 5, box[1] - 5, box[2] + 5,
                               box[3] + 5))
        for res in (28, 112):
            got = transforms.rasterize_polygons(segs, box, res)
            want = jtransforms.rasterize_polygons(segs, box, res)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert transforms.rasterize_polygons([], (0, 0, 4, 4), 8).sum() == 0


def test_masker_matches_jax():
    """paste_masks (with and without the 1-pixel pad), paste_single_crop,
    rasterize_polygons_crop and mask_iou, on boxes inside, across and off
    the image."""
    rng = np.random.RandomState(1)
    hw = (90, 130)
    probs = rng.uniform(0, 1, (12, 28, 28)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-20, 120, (12, 2)),
                            rng.uniform(2, 60, (12, 2))], 1)
    boxes[:, 2:] += boxes[:, :2]
    boxes[3] = [200, 200, 250, 260]                    # off the image
    for padding in (1, 0):
        np.testing.assert_array_equal(
            masker.paste_masks(probs, boxes, hw, padding=padding),
            jmasker.paste_masks(probs, boxes, hw, padding=padding))
    for p, b in zip(probs, boxes):
        got, want = (m.paste_single_crop(p, b, hw, 0.4)
                     for m in (masker, jmasker))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        segs = _polygons(rng, b)
        got, want = (m.rasterize_polygons_crop(segs, hw)
                     for m in (masker, jmasker))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    pasted = masker.paste_masks(probs, boxes, hw)
    for a, b in zip(pasted[:-1], pasted[1:]):
        assert masker.mask_iou(a, b) == jmasker.mask_iou(a, b)
    assert masker.rasterize_polygons_crop([[1, 2]], hw) == \
        jmasker.rasterize_polygons_crop([[1, 2]], hw)


def test_mask_helpers_raise_without_cv2(monkeypatch):
    monkeypatch.setattr(image_io, "cv2", None)
    with pytest.raises(RuntimeError, match="rasterize_polygons"):
        transforms.rasterize_polygons([[0, 0, 4, 0, 4, 4]], (0, 0, 8, 8), 8)
    with pytest.raises(RuntimeError, match="paste_masks"):
        masker.paste_masks(np.ones((1, 4, 4)), np.array([[0, 0, 3, 3]]),
                           (8, 8))
    with pytest.raises(RuntimeError, match="paste_single_crop"):
        masker.paste_single_crop(np.ones((4, 4)), (0, 0, 3, 3), (8, 8))


# ---------------------------------------------------------------- loader

def _mask_loader_cfgs(**opts):
    jcfg, pcfg = _cfgs(**opts)
    for cfg in (jcfg, pcfg):
        cfg.MODEL.MASK_ON = True
    return jcfg, pcfg


def test_loader_mask_targets_match_jax(tree):
    """A train epoch with masks (flips drawn at 0.5 from the same seed):
    every batch's GT masks equal the JAX loader's bit for bit, flipped
    images' masks mirrored."""
    jcfg, pcfg = _mask_loader_cfgs()
    want = list(j_build.make_data_loader(jcfg, is_train=True, seed=5,
                                         infinite=False, with_masks=True)[0])
    got = _drain(build.make_data_loader(pcfg, is_train=True, device=CPU,
                                        seed=5, infinite=False,
                                        with_masks=True)[0])
    assert len(got) == len(want) > 1
    for (_, gt), (_, wt) in zip(got, want):
        assert gt.masks.dtype == torch.float32
        assert tuple(gt.masks.shape[-2:]) == (112, 112)
        np.testing.assert_array_equal(gt.masks.numpy(),
                                      np.asarray(wt.masks))
        valid = gt.valid.numpy()
        assert (gt.masks.numpy().sum((-1, -2)) > 0)[valid].all()
        assert gt.masks.numpy()[~valid].sum() == 0
    plain = _drain(build.make_data_loader(pcfg, is_train=True, device=CPU,
                                          seed=5, infinite=False)[0])
    assert plain[0][1].masks is None


def test_staged_loader_carries_the_same_masks(tree, tmp_path):
    """With the staging cache, the warm epoch (every canvas a hit) gives
    the cold epoch's masks: they come from the annotations either way."""
    _, pcfg = _mask_loader_cfgs(**{
        "DATALOADER.STAGE_CACHE": True,
        "DATALOADER.STAGE_DIR": str(tmp_path / "stage")})
    runs = []
    for _ in range(2):
        loader, _ = build.make_data_loader(pcfg, is_train=True, device=CPU,
                                           seed=5, infinite=False,
                                           with_masks=True)
        runs.append(_drain(loader))
    assert loader.stats["stage_hits"] > 0
    for (_, a), (_, b) in zip(*runs):
        assert torch.equal(a.masks, b.masks)


# ---------------------------------------------------------------- eval

@pytest.fixture(scope="module")
def predictions(tree):
    """The JAX eval loader's batches of the foggy tree through both
    packages' compute_on_dataset with masks (the narrowed mask model on the
    same numpy weights): (port's, JAX's)."""
    jcfg, pcfg = mask_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list([
            "TPU.IMAGE_SHAPE", (0, 0), "DATALOADER.SIZE_DIVISIBILITY", 32,
            "DATALOADER.NUM_WORKERS", 0, "DATALOADER.STAGE_CACHE", False,
            "INPUT.MIN_SIZE_TEST", 120, "INPUT.MAX_SIZE_TEST", 160,
            "TEST.IMS_PER_BATCH", 3,
            "DATASETS.TEST", ("tiny_foggy_cocostyle",)])
    jmodel = j_build_model(jcfg)
    loader, _ = j_build.make_data_loader(jcfg, is_train=False)
    batches = list(loader)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, batches[0][0], with_masks=True))
    variables = random_variables(shapes, seed=1, scales={
        "rpn_head/cls_logits/kernel": 30.0,
        "predictor/cls_score/kernel": 30.0,
        "rpn_head/bbox_pred/kernel": 0.03,
        "predictor/bbox_pred/kernel": 0.1})
    want = j_inference.compute_on_dataset(jmodel, variables, batches,
                                          with_masks=True)
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    mine = [(ImageBatch(
        images=torch.from_numpy(np.asarray(b.images)).permute(0, 3, 1, 2),
        sizes=torch.from_numpy(np.asarray(b.sizes)),
        orig_sizes=torch.from_numpy(np.asarray(b.orig_sizes)),
        is_source=torch.from_numpy(np.asarray(b.is_source))), ids)
        for b, ids in batches]
    got = inference.compute_on_dataset(prepare_model(model, CPU), mine,
                                       with_masks=True)
    return got, want


def test_compute_on_dataset_with_masks_matches_jax(predictions):
    got, want = predictions
    assert got.keys() == want.keys() and len(got) == 8
    for img_id, w in want.items():
        g = got[img_id]
        assert len(w["scores"]) > 0
        np.testing.assert_array_equal(g["labels"], np.asarray(w["labels"]))
        # the box head's float32 sums in another order, through the
        # decode's exp: 1e-4 of the coordinates
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]),
                                   rtol=1e-4, atol=1e-3)
        assert g["mask_probs"].shape == (len(w["scores"]), 28, 28)
        # pooled from boxes 1e-3 px apart: 1e-4 in the probabilities
        np.testing.assert_allclose(g["mask_probs"],
                                   np.asarray(w["mask_probs"]), rtol=0,
                                   atol=1e-4)


def _datasets(tree):
    img_dir, ann = tree["foggy"]
    return (COCODataset(root=img_dir, ann_file=ann,
                        remove_images_without_annotations=False),
            JCOCODataset(root=img_dir, ann_file=ann,
                         remove_images_without_annotations=False))


def _host(preds):
    return {k: {f: np.asarray(v) for f, v in p.items()}
            for k, p in preds.items()}


@pytest.mark.parametrize("style", ["coco", "cityscapes"])
def test_segm_results_equal_jax(tree, predictions, style, tmp_path):
    """COCO segm (mask IoU on each pair's rectangle, crowd on mask pixels,
    a detection's area its mask pixels, GT masks from the polygons) and
    Cityscapes use_masks (full-resolution GT masks, pixel-count sizes) on
    JAX's predictions: every number equal to the JAX package's."""
    pds, jds = _datasets(tree)
    preds = _host(predictions[1])
    got = evaluate(pds, preds, output_folder=str(tmp_path),
                   iou_types=("bbox", "segm"), style=style)
    want = j_evaluate(jds, preds, iou_types=("bbox", "segm"), style=style)
    assert got == want
    assert set(got) == {"bbox", "segm"}
    assert os.path.exists(tmp_path / f"{style}_results.json")


@pytest.mark.parametrize("style", ["coco", "cityscapes"])
def test_segm_results_on_near_masks_equal_jax(tree, style):
    """Predictions that hit: each GT's own polygons as a probability map in
    a jittered box, a mask-less box and misses: segm numbers equal JAX's
    and above zero."""
    pds, jds = _datasets(tree)
    rng = np.random.RandomState(2)
    preds = {}
    for img_id in pds.ids:
        boxes, probs = [], []
        for a in pds.anns[img_id]:
            x, y, w, h = a["bbox"]
            box = np.array([x, y, x + w, y + h]) + rng.uniform(-2, 2, 4)
            crop, (oy, ox) = masker.rasterize_polygons_crop(
                a["segmentation"], (120, 160))
            prob = np.zeros((28, 28), np.float32)
            full = np.zeros((120, 160), np.float32)
            full[oy:oy + crop.shape[0], ox:ox + crop.shape[1]] = crop
            y0, x0 = int(max(box[1], 0)), int(max(box[0], 0))
            sub = full[y0:int(box[3]) + 1, x0:int(box[2]) + 1]
            if sub.size:
                import cv2

                prob = cv2.resize(sub, (28, 28))
            boxes.append(box)
            probs.append(prob)
        boxes.append(rng.uniform(0, 60, 4).cumsum()[[0, 1, 3, 3]])
        probs.append(rng.uniform(0, 1, (28, 28)).astype(np.float32))
        preds[img_id] = dict(
            boxes=np.asarray(boxes, np.float32),
            scores=rng.uniform(0.1, 1, len(boxes)).astype(np.float32),
            labels=np.asarray([pds.json_category_id_to_contiguous_id[
                a["category_id"]] for a in pds.anns[img_id]] + [1]),
            mask_probs=np.asarray(probs, np.float32))
    got = evaluate(pds, preds, iou_types=("segm",), style=style)
    want = j_evaluate(jds, preds, iou_types=("segm",), style=style)
    assert got == want
    top = got["segm"]["AP50"] if style == "coco" \
        else got["segm"]["allAp50%"]
    assert top > 0.3


SEGM_CASES = ["test_mask_iou_diverges_from_box_iou",
              "test_segm_crowd_ignore_uses_mask_pixels",
              "test_segm_det_area_is_mask_pixels_not_box",
              "test_segm_empty_masks"]


@pytest.mark.parametrize("case", SEGM_CASES)
def test_adversarial_segm_case_through_the_port(case, monkeypatch):
    """The JAX package's hand-derived segm cases, each evaluation run by
    the port's CocoEvaluator (held to the case's numbers) and equal to the
    JAX package's."""
    def both(dataset, preds, iou_type="bbox"):
        want = adv.CocoEvaluator(dataset, iou_type).evaluate(preds)
        got = coco_eval.CocoEvaluator(dataset, iou_type).evaluate(preds)
        assert got == want
        return got[0]

    monkeypatch.setattr(adv, "ev", both)
    getattr(adv, case)()
