"""The port's dataset tools against the JAX package's, on trees written here:
Cityscapes gtFine polygons and KITTI labels to COCO JSON (byte for byte),
and the rainy domain's images (pixel for pixel, same seed), with drawn
streaks and with ``--mask-dir``."""

import json
import os

import numpy as np
import pytest

from da_detect_tpu.tools import convert_cityscapes_to_coco as j_city
from da_detect_tpu.tools import convert_kitti_to_coco as j_kitti
from da_detect_tpu.tools import generate_rainy_dataset as j_rain
from da_detect_tpu_torch.tools import convert_cityscapes_to_coco as p_city
from da_detect_tpu_torch.tools import convert_kitti_to_coco as p_kitti
from da_detect_tpu_torch.tools import generate_rainy_dataset as p_rain

cv2 = pytest.importorskip("cv2")


def _gtfine_tree(root):
    """train: two cities, three images; val: one. Objects of every class,
    a cargroup and a persongroup (crowds), a 2-point polygon, and labels
    that are not converted (road, sky, license plate)."""
    rng = np.random.RandomState(0)
    labels = ("person", "rider", "car", "truck", "bus", "train",
              "motorcycle", "bicycle", "cargroup", "persongroup", "road",
              "sky", "license plate")
    for split, cities in (("train", {"aachen": 2, "bochum": 1}),
                          ("val", {"frankfurt": 1})):
        for city, n in cities.items():
            os.makedirs(os.path.join(root, split, city))
            for i in range(n):
                objects = []
                for j in range(12):
                    pts = int(rng.randint(3, 9))
                    poly = (rng.uniform(0, 2048, (pts, 2))
                            .round(1 if j % 2 else 0).tolist())
                    objects.append({"label": labels[(i + j) % len(labels)],
                                    "polygon": poly})
                objects.append({"label": "car", "polygon": [[1, 2], [30, 4]]})
                objects.append({"label": "cargroup",
                                "polygon": [[10, 10], [90, 12], [60, 70]]})
                stem = f"{city}_{i:06d}_000019"
                with open(os.path.join(root, split, city,
                                       f"{stem}_gtFine_polygons.json"),
                          "w") as f:
                    json.dump({"imgHeight": 1024, "imgWidth": 2048,
                               "objects": objects}, f)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("caronly", [False, True],
                         ids=["instances", "caronly"])
def test_cityscapes_json_matches_jax(tmp_path, caronly):
    gt = str(tmp_path / "gtFine")
    _gtfine_tree(gt)
    flag = ["--caronly"] if caronly else []
    j_city.main(["--gt-dir", gt, "--out-dir", str(tmp_path / "jax")] + flag)
    counts = p_city.main(["--gt-dir", gt, "--out-dir",
                          str(tmp_path / "port")] + flag)
    prefix = "caronly" if caronly else "instancesonly"
    for split in ("train", "val"):
        name = f"{prefix}_filtered_gtFine_{split}.json"
        got = _read(tmp_path / "port" / name)
        assert got == _read(tmp_path / "jax" / name), name
        data = json.loads(got)
        assert counts[split] == (len(data["images"]),
                                 len(data["annotations"]))
        anns = data["annotations"]
        # the 2-point polygon is dropped, cargroup is a car crowd
        assert all(len(a["segmentation"][0]) >= 6 for a in anns)
        car = 1 if caronly else 3
        assert any(a["iscrowd"] == 1 and a["category_id"] == car
                   for a in anns)
        names = {c["name"] for c in data["categories"]}
        assert names == ({"car"} if caronly else set(p_city.INSTANCE_CLASSES))
    assert counts["train"][0] == 3 and counts["val"][0] == 1


def test_cityscapes_missing_split_warns_and_matches(tmp_path, capsys):
    gt = str(tmp_path / "gtFine")
    os.makedirs(gt)
    j_city.convert_split(gt, "test", str(tmp_path / "j.json"))
    assert p_city.convert_split(gt, "test", str(tmp_path / "p.json")) \
        == (0, 0)
    assert "no *_gtFine_polygons.json" in capsys.readouterr().err
    assert _read(tmp_path / "p.json") == _read(tmp_path / "j.json")


def test_kitti_json_matches_jax(tmp_path):
    """Label files with cars and other classes, a blank line and an empty
    file; images of two sizes, and one label without its image (KITTI's
    default dims)."""
    labels, images = tmp_path / "label_2", tmp_path / "image_2"
    labels.mkdir()
    images.mkdir()
    rng = np.random.RandomState(1)
    for i, kinds in enumerate((("Car", "Pedestrian", "Car"), ("Cyclist",),
                               ("Car", "DontCare", "Van", "Car"), ())):
        lines = []
        for kind in kinds:
            x1, y1 = rng.uniform(0, 900, 2).round(2)
            w, h = rng.uniform(5, 200, 2).round(2)
            lines.append(f"{kind} 0.00 0 -1.57 {x1:.2f} {y1:.2f} "
                         f"{x1 + w:.2f} {y1 + h:.2f} 1.5 1.6 3.9 1 1 1 0")
        with open(labels / f"{i:06d}.txt", "w") as f:
            f.write("\n".join(lines[:1] + [""] + lines[1:]))
        if i < 3:
            hw = (20, 30) if i % 2 else (24, 40)
            cv2.imwrite(str(images / f"{i:06d}.png"),
                        rng.randint(0, 255, hw + (3,)).astype(np.uint8))
    j_kitti.convert(str(labels), str(images), str(tmp_path / "j.json"))
    n = p_kitti.main(["--label-dir", str(labels), "--image-dir", str(images),
                      "--out", str(tmp_path / "p.json")])
    got = _read(tmp_path / "p.json")
    assert got == _read(tmp_path / "j.json")
    data = json.loads(got)
    assert n == (4, 4)
    assert [(im["height"], im["width"]) for im in data["images"]] == [
        (24, 40), (20, 30), (24, 40), p_kitti.KITTI_HW]


def _png_tree(root):
    """Two levels of clean images (PNG and JPEG) and a file that is not an
    image."""
    rng = np.random.RandomState(2)
    for sub, n in (("", 1), ("aachen", 2), (os.path.join("b", "c"), 1)):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            img = rng.randint(0, 255, (48 + 8 * i, 80, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"img_{i}.png"), img)
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not an image")
    cv2.imwrite(os.path.join(root, "aachen", "photo.jpg"),
                rng.randint(0, 255, (40, 64, 3)).astype(np.uint8))


def _tree_images(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            out[os.path.relpath(path, root)] = cv2.imread(path,
                                                          cv2.IMREAD_COLOR)
    return out


@pytest.mark.parametrize("with_masks", [False, True],
                         ids=["drawn", "mask_dir"])
def test_rainy_tree_matches_jax(tmp_path, with_masks):
    src = str(tmp_path / "clean")
    _png_tree(src)
    mask_dir = None
    if with_masks:
        mask_dir = str(tmp_path / "masks")
        os.makedirs(mask_dir)
        rng = np.random.RandomState(3)
        for i in range(3):
            cv2.imwrite(os.path.join(mask_dir, f"m{i}.png"),
                        rng.randint(0, 255, (30 + 10 * i, 50)).astype(
                            np.uint8))
    n_j = j_rain.process_tree(src, str(tmp_path / "jax"), seed=7,
                              mask_dir=mask_dir)
    argv = ["--src", src, "--dst", str(tmp_path / "port"), "--seed", "7"]
    n_p = p_rain.main(argv + (["--mask-dir", mask_dir] if mask_dir else []))
    assert n_p == n_j == 5
    got, want = _tree_images(tmp_path / "port"), _tree_images(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    clean = _tree_images(src)
    for rel, img in want.items():
        np.testing.assert_array_equal(got[rel], img, err_msg=rel)
        # rain brightens some pixels above the darkened image
        assert (got[rel].astype(int) > clean[rel] * 0.85 + 2).any(), rel


def test_rain_pieces_match_jax():
    rng_j, rng_p = np.random.RandomState(5), np.random.RandomState(5)
    for h, w in ((64, 96), (33, 50)):
        m_j = j_rain.synth_rain_mask(h, w, rng_j)
        m_p = p_rain.synth_rain_mask(h, w, rng_p)
        np.testing.assert_array_equal(m_p, m_j)
        assert m_p.dtype == np.float32 and m_p.max() > 0
        img = np.random.RandomState(6).randint(0, 255, (h, w, 3)).astype(
            np.uint8)
        np.testing.assert_array_equal(p_rain.rain_aug(img, m_p),
                                      j_rain.rain_aug(img, m_j))


def test_rainy_tool_raises_without_cv2(monkeypatch, tmp_path):
    monkeypatch.setattr(p_rain, "cv2", None)
    with pytest.raises(ImportError, match="generate_rainy_dataset"):
        p_rain.process_tree(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(ImportError, match="generate_rainy_dataset"):
        p_rain.synth_rain_mask(8, 8, np.random.RandomState(0))
