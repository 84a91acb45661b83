"""The port's Cityscapes-style and Pascal VOC evaluators and the VOC
dataset against the JAX package's, number for number.

- Cityscapes (bbox): the hand cases of ``tests/test_cityscapes_eval.py``
  (their datasets and predictions, each quirk: integer boxes without +1,
  duplicate matches as FPs, hard FNs, predictions ignored over small GT
  regions, the stepwise PR integral, NaN for an absent class, cross-class
  matches), and random predictions over the ``tests/data_factory.py`` tree;
  every AP equal (NaN in the same places), the averages equal.
- ``evaluate(style="cityscapes")`` and ``inference(style=...)`` dispatch to
  it; the mask protocol raises.
- Pascal VOC: a tree written here (xml annotations, difficult objects, one
  image without objects): ``PascalVOCDataset`` samples, ``build_dataset``
  through the catalog's VOC names, and ``do_voc_evaluation`` (VOC07 11-point
  and the area AP) equal to JAX's.

The numbers are float64 host numpy in both packages: compared exactly.
"""

import os

import numpy as np
import pytest
import torch

import tests.data_factory as factory
from da_detect_tpu.data.datasets import COCODataset as JCOCODataset
from da_detect_tpu.data.datasets import PascalVOCDataset as JVOC
from da_detect_tpu.data.evaluation import cityscapes_eval as jcs
from da_detect_tpu.data.evaluation import voc_eval as jvoc
from da_detect_tpu_torch.data import build_dataset
from da_detect_tpu_torch.data.datasets import COCODataset, PascalVOCDataset
from da_detect_tpu_torch.data.evaluation import cityscapes_eval as pcs
from da_detect_tpu_torch.data.evaluation import evaluate
from tests.test_cityscapes_eval import FakeDataset, _ann, _pred


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want, what=""):
    """Nested results equal, NaN where the other has NaN."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


# the hand cases of tests/test_cityscapes_eval.py: (GT anns a image,
# classes, predictions)
HAND_CASES = {
    "perfect": ([[_ann(10, 10, 60, 60)]], 1,
                {0: _pred([[10, 10, 60, 60]], [0.9], [1])}),
    "high_scored_fp_and_missed_gt": (
        [[_ann(10, 10, 60, 60), _ann(100, 100, 150, 150)]], 1,
        {0: _pred([[10, 10, 60, 60], [200, 10, 240, 40]], [0.9, 0.95],
                  [1, 1])}),
    "overlap_splits_ap50_ap75": ([[_ann(0, 0, 100, 100)]], 1,
                                 {0: _pred([[0, 0, 99, 70]], [0.8], [1])}),
    "duplicate_is_fp": ([[_ann(10, 10, 110, 110)]], 1,
                        {0: _pred([[10, 10, 110, 110], [12, 12, 110, 110]],
                                  [0.9, 0.6], [1, 1])}),
    "small_gt_absorbs_fp": (
        [[_ann(10, 10, 15, 15), _ann(100, 100, 180, 180)]], 1,
        {0: _pred([[10, 10, 15, 15], [100, 100, 180, 180]], [0.7, 0.9],
                  [1, 1])}),
    "absent_class_nan": ([[_ann(10, 10, 60, 60, cat=10)]], 2,
                         {0: _pred([[10, 10, 60, 60]], [0.9], [1])}),
    "cross_class_match": (
        [[_ann(10, 10, 110, 110, cat=10)]], 2,
        {0: _pred([[10, 10, 109, 109], [200, 150, 240, 180]], [0.9, 0.5],
                  [2, 1])}),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_cityscapes_hand_cases_match_jax(case):
    anns, n_cls, preds = HAND_CASES[case]
    ds = FakeDataset(anns, num_classes=n_cls)
    labels = list(range(1, n_cls + 1))
    want_ap = jcs.evaluate_matches(jcs.match_gts_with_preds(ds, preds),
                                   labels)
    got_ap = pcs.evaluate_matches(pcs.match_gts_with_preds(ds, preds),
                                  labels)
    np.testing.assert_array_equal(got_ap, want_ap)
    _same(pcs.do_cityscapes_evaluation(ds, preds),
          jcs.do_cityscapes_evaluation(ds, preds))


def test_cityscapes_hand_values():
    """The hand-traced values themselves: AP 1, 0.125 at every overlap, the
    0.707 overlap counting at 0.5 and not at 0.75, NaN for the absent
    class."""
    def ap(case):
        anns, n_cls, preds = HAND_CASES[case]
        ds = FakeDataset(anns, num_classes=n_cls)
        return pcs.evaluate_matches(pcs.match_gts_with_preds(ds, preds),
                                    list(range(1, n_cls + 1)))

    assert ap("perfect").tolist() == [[1.0] * 10]
    np.testing.assert_allclose(ap("high_scored_fp_and_missed_gt")[0], 0.125)
    split = ap("overlap_splits_ap50_ap75")[0]
    assert split[0] == 1.0 and split[5] == 0.0
    assert np.isnan(ap("absent_class_nan")[1]).all()
    assert ap("cross_class_match")[0, 0] == 1.0


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("protocols"))
    return factory.make_triplet_datasets(root, n_images=6)


def _random_predictions(dataset, seed):
    rng = np.random.RandomState(seed)
    preds = {}
    for idx, img_id in enumerate(dataset.ids):
        info = dataset.get_img_info(idx)
        h, w = info["height"], info["width"]
        gts = [a["bbox"] for a in dataset.anns[img_id]]
        boxes = []
        for x, y, bw, bh in gts:        # near-hits, some duplicates
            for _ in range(rng.randint(0, 3)):
                jitter = rng.uniform(-6, 6, 4)
                boxes.append([x, y, x + bw, y + bh] + jitter)
        for _ in range(rng.randint(0, 4)):  # misses
            x1, y1 = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            boxes.append([x1, y1, x1 + rng.uniform(3, 40),
                          y1 + rng.uniform(3, 40)])
        n = len(boxes)
        preds[img_id] = dict(
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            scores=rng.uniform(0.05, 1.0, n).astype(np.float32),
            labels=rng.randint(1, 3, n).astype(np.int32))
    return preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cityscapes_random_predictions_match_jax(tiny_tree, seed, tmp_path):
    img_dir, ann = tiny_tree["foggy"]
    jds = JCOCODataset(root=img_dir, ann_file=ann,
                      remove_images_without_annotations=False)
    pds = COCODataset(root=img_dir, ann_file=ann,
                      remove_images_without_annotations=False)
    preds = _random_predictions(jds, seed)
    want = jcs.do_cityscapes_evaluation(jds, preds)
    got = evaluate(pds, preds, output_folder=str(tmp_path),
                   style="cityscapes")
    _same(got, want)
    assert os.path.exists(tmp_path / "cityscapes_results.json")
    assert 0.0 < want["bbox"]["allAp50%"] < 1.0


def test_cityscapes_masks_raise_naming_slice_7(tiny_tree):
    """The mask protocol came with the mask head: predictions without mask
    probabilities evaluate under segm as the JAX package's do (no mask, no
    match); an unknown style still raises."""
    img_dir, ann = tiny_tree["foggy"]
    pds = COCODataset(root=img_dir, ann_file=ann,
                      remove_images_without_annotations=False)
    jds = JCOCODataset(root=img_dir, ann_file=ann,
                       remove_images_without_annotations=False)
    preds = _random_predictions(pds, 0)
    assert len(pcs.match_gts_with_preds(pds, preds, use_masks=True)) \
        == len(pds.ids)
    _same(evaluate(pds, preds, iou_types=("segm",), style="cityscapes"),
          jcs.do_cityscapes_evaluation(jds, preds, iou_types=("segm",)))
    with pytest.raises(ValueError, match="EVAL_STYLE"):
        evaluate(pds, preds, style="kitti")


def test_inference_dispatches_eval_style(tiny_tree, monkeypatch):
    """``inference(style="cityscapes")`` evaluates the detections of
    ``compute_on_dataset`` with the Cityscapes protocol."""
    from da_detect_tpu_torch.engine import inference as pinf

    img_dir, ann = tiny_tree["foggy"]
    pds = COCODataset(root=img_dir, ann_file=ann,
                      remove_images_without_annotations=False)
    preds = _random_predictions(pds, 3)
    monkeypatch.setattr(pinf, "compute_on_dataset",
                        lambda model, loader, **heads: preds)
    res, got_preds = pinf.inference(None, None, pds, style="cityscapes")
    assert got_preds is preds
    _same(res, jcs.do_cityscapes_evaluation(pds, preds))
    coco, _ = pinf.inference(None, None, pds)
    assert "AP50" in coco["bbox"]


VOC_OBJECTS = {
    "000001": ((120, 160), [("car", (10, 12, 60, 70), 0),
                            ("person", (80, 20, 120, 110), 0),
                            ("car", (5, 90, 30, 118), 1)]),
    "000002": ((100, 140), [("dog", (20, 30, 90, 95), 0),
                            ("person", (100, 10, 130, 60), 1)]),
    "000003": ((90, 90), []),
    "000004": ((110, 150), [("car", (40, 40, 100, 100), 0),
                            ("car", (42, 44, 98, 101), 0)]),
}


def _write_voc(root):
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                           "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for img_id, ((h, w), objs) in VOC_OBJECTS.items():
        parts = [f"<annotation><size><width>{w}</width><height>{h}</height>"
                 "<depth>3</depth></size>"]
        for name, (x1, y1, x2, y2), diff in objs:
            parts.append(
                f"<object><name> {name.upper()} </name>"
                f"<difficult>{diff}</difficult><bndbox><xmin>{x1}</xmin>"
                f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
                "</bndbox></object>")
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"),
                  "w") as f:
            f.write("".join(parts) + "</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(VOC_OBJECTS) + "\n")


def _voc_predictions(ds, seed):
    rng = np.random.RandomState(seed)
    preds = {}
    for idx in range(len(ds)):
        s = ds.sample(idx)
        boxes = [b + rng.uniform(-5, 5, 4) for b in s["boxes"]
                 for _ in range(rng.randint(0, 3))]
        boxes += [np.r_[xy, xy + rng.uniform(5, 40, 2)]
                  for xy in rng.uniform(0, 80, (rng.randint(0, 3), 2))]
        n = len(boxes)
        labels = [int(l) for l in s["labels"]][:n]
        labels += list(rng.choice([7, 12, 15], n - len(labels)))
        preds[s["image_id"]] = dict(
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            scores=rng.uniform(0.05, 1.0, n).astype(np.float32),
            labels=np.asarray(labels, np.int32))
    return preds


@pytest.mark.parametrize("use_difficult", [False, True])
def test_voc_dataset_matches_jax(tmp_path, use_difficult):
    _write_voc(str(tmp_path))
    jds = JVOC(str(tmp_path), "test", use_difficult=use_difficult)
    pds = PascalVOCDataset(str(tmp_path), "test",
                           use_difficult=use_difficult)
    assert len(pds) == len(jds) == 4
    for idx in range(len(jds)):
        assert pds.get_img_info(idx) == jds.get_img_info(idx)
        got, want = pds.sample(idx), jds.sample(idx)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("use_07_metric", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_voc_eval_matches_jax(tmp_path, seed, use_07_metric):
    _write_voc(str(tmp_path))
    jds = JVOC(str(tmp_path), "test", use_difficult=True)
    pds = PascalVOCDataset(str(tmp_path), "test", use_difficult=True)
    preds = _voc_predictions(jds, seed)
    want = jvoc.do_voc_evaluation(jds, preds, use_07_metric=use_07_metric)
    got = evaluate(pds, preds, use_07_metric=use_07_metric)
    _same(got, want)
    assert 0.0 < want["voc"]["map"] < 1.0


def test_build_dataset_builds_voc_from_the_catalog(tmp_path, monkeypatch):
    """The catalog's ``voc_2007_test`` name under $DA_DETECT_DATA_DIR: a
    ``PascalVOCDataset`` with difficult objects kept for evaluation and
    dropped for training, as the JAX package's ``build_dataset`` makes."""
    from da_detect_tpu.data.build import build_dataset as j_build_dataset

    _write_voc(str(tmp_path / "voc" / "VOC2007"))
    monkeypatch.setenv("DA_DETECT_DATA_DIR", str(tmp_path))
    for is_train in (False, True):
        got = build_dataset(("voc_2007_test",), is_train)
        want = j_build_dataset(("voc_2007_test",), is_train)
        assert isinstance(got, PascalVOCDataset)
        assert got.keep_difficult == want.keep_difficult == (not is_train)
        assert [len(got.sample(i)["boxes"]) for i in range(len(got))] == [
            len(want.sample(i)["boxes"]) for i in range(len(want))]
