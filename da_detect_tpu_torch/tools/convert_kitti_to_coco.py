"""KITTI object labels -> car-only COCO JSON (port of
``da_detect_tpu/tools/convert_kitti_to_coco.py``; reference
tools/kitti/convert_kitti_to_coco.py ``convert_kitti_car_only``).

    python -m da_detect_tpu_torch.tools.convert_kitti_to_coco \
        --label-dir <kitti>/training/label_2 \
        --image-dir <kitti>/training/image_2 --out <annotations>/car.json

One image a label file (``<stem>.png``), its dimensions read from the image
(the PNG header; another format through cv2), or KITTI's 375x1242 when the
image is missing; one annotation a "Car" line, its box from columns 4-7.
The output is the JAX tool's, byte for byte.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..data.image_io import image_size

KITTI_HW = (375, 1242)


def convert(label_dir: str, image_dir: str, out_file: str) -> tuple[int, int]:
    """Write the JSON; returns (images, annotations)."""
    images, annotations = [], []
    files = sorted(glob.glob(os.path.join(label_dir, "*.txt")))
    for img_id, path in enumerate(files, start=1):
        stem = os.path.splitext(os.path.basename(path))[0]
        img_path = os.path.join(image_dir, stem + ".png")
        if os.path.exists(img_path):
            w, h = image_size(img_path)
        else:
            h, w = KITTI_HW
        images.append({"id": img_id, "file_name": stem + ".png",
                       "height": h, "width": w})
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0] != "Car":
                    continue
                x1, y1, x2, y2 = (float(v) for v in parts[4:8])
                annotations.append({
                    "id": len(annotations) + 1, "image_id": img_id,
                    "category_id": 1, "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "area": (x2 - x1) * (y2 - y1), "iscrowd": 0,
                    "segmentation": [[x1, y1, x2, y1, x2, y2, x1, y2]]})
    with open(out_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "car"}]}, f)
    return len(images), len(annotations)


def main(argv=None) -> tuple[int, int]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label-dir", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    n_img, n_ann = convert(args.label_dir, args.image_dir, args.out)
    print(f"{n_img} images, {n_ann} car annotations -> {args.out}")
    return n_img, n_ann


if __name__ == "__main__":
    main()
