"""Cityscapes gtFine polygons -> COCO instance JSON (port of
``da_detect_tpu/tools/convert_cityscapes_to_coco.py``; reference
tools/cityscapes/convert_cityscapes_to_coco.py).

    python -m da_detect_tpu_torch.tools.convert_cityscapes_to_coco \
        --gt-dir <cityscapes>/gtFine --out-dir <annotations> [--caronly] \
        [--splits train val]

It reads every ``<split>/<city>/*_gtFine_polygons.json`` and writes
``instancesonly_filtered_gtFine_<split>.json`` (the 8 instance classes) or,
with ``--caronly``, ``caronly_filtered_gtFine_<split>.json``. A label ending
in "group" (``cargroup``) is its class with ``iscrowd`` 1; other labels are
dropped, and so are polygons of fewer than 3 points. Foggy and rainy
Cityscapes are pixel-aligned renderings of the same images: they reuse the
JSON. The output is the JAX tool's, byte for byte.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

INSTANCE_CLASSES = ("person", "rider", "car", "truck", "bus", "train",
                    "motorcycle", "bicycle")


def poly_bbox(polygon) -> list:
    """[x, y, w, h] of the polygon's extent."""
    xs = [p[0] for p in polygon]
    ys = [p[1] for p in polygon]
    x1, y1 = min(xs), min(ys)
    return [x1, y1, max(xs) - x1, max(ys) - y1]


def poly_area(polygon) -> float:
    """The shoelace area."""
    area = 0.0
    n = len(polygon)
    for i in range(n):
        x1, y1 = polygon[i]
        x2, y2 = polygon[(i + 1) % n]
        area += x1 * y2 - x2 * y1
    return abs(area) / 2.0


def _annotation(obj, cat_id: dict, ann_id: int, img_id: int):
    """The COCO annotation of one gtFine object, or None when its class is
    not converted or its polygon has fewer than 3 points."""
    label = obj["label"]
    crowd = int(label.endswith("group"))
    base = label[:-len("group")] if crowd else label
    poly = obj["polygon"]
    if base not in cat_id or len(poly) < 3:
        return None
    return {"id": ann_id, "image_id": img_id, "category_id": cat_id[base],
            "bbox": poly_bbox(poly), "area": poly_area(poly),
            "iscrowd": crowd,
            "segmentation": [[float(v) for pt in poly for v in pt]]}


def convert_split(gt_dir: str, split: str, out_file: str,
                  classes=INSTANCE_CLASSES,
                  img_suffix: str = "_leftImg8bit.png") -> tuple[int, int]:
    """Write one split's JSON; returns (images, annotations)."""
    cat_id = {c: i + 1 for i, c in enumerate(classes)}
    images, annotations = [], []
    files = sorted(glob.glob(os.path.join(gt_dir, split, "*",
                                          "*_gtFine_polygons.json")))
    if not files:
        print(f"warning: no *_gtFine_polygons.json under "
              f"{os.path.join(gt_dir, split)}", file=sys.stderr)
    for img_id, path in enumerate(files, start=1):
        with open(path) as f:
            gt = json.load(f)
        city = os.path.basename(os.path.dirname(path))
        stem = os.path.basename(path).replace("_gtFine_polygons.json", "")
        images.append({"id": img_id,
                       "file_name": os.path.join(city, stem + img_suffix),
                       "height": gt["imgHeight"], "width": gt["imgWidth"]})
        for obj in gt["objects"]:
            ann = _annotation(obj, cat_id, len(annotations) + 1, img_id)
            if ann is not None:
                annotations.append(ann)
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with open(out_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": i, "name": c}
                                  for c, i in cat_id.items()]}, f)
    return len(images), len(annotations)


def main(argv=None) -> dict:
    """Returns {split: (images, annotations)}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gt-dir", required=True,
                   help="gtFine root (holds train/val/test)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--caronly", action="store_true")
    args = p.parse_args(argv)
    classes = ("car",) if args.caronly else INSTANCE_CLASSES
    prefix = "caronly" if args.caronly else "instancesonly"
    counts = {}
    for split in args.splits:
        out = os.path.join(args.out_dir,
                           f"{prefix}_filtered_gtFine_{split}.json")
        counts[split] = convert_split(args.gt_dir, split, out, classes)
        print(f"{split}: {counts[split][0]} images, {counts[split][1]} "
              f"annotations -> {out}")
    return counts


if __name__ == "__main__":
    main()
