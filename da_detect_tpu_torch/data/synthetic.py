"""A synthetic aligned triple of COCO-style datasets on disk: clean, "foggy"
and "rainy" renderings of the same images, the relationship of Cityscapes,
Foggy Cityscapes and Rainy Cityscapes, for smoke runs and tests of the
loaders and CLIs on a machine without the real datasets.

Images are dark noise with bright rectangles at the ground-truth boxes (a
detector has something to learn); the foggy image is the clean one * 0.55 +
110, the rainy one adds 120 to every 7th column. PNGs are written with
``image_io.write_png``; the three domains share one annotation file.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .image_io import write_png

CATEGORIES = [{"id": 1, "name": "car"}, {"id": 2, "name": "person"}]
DOMAINS = ("clean", "foggy", "rainy")


def degrade(img: np.ndarray) -> dict[str, np.ndarray]:
    """The three pixel-aligned renderings of a clean uint8 image."""
    fog = (img.astype(np.float32) * 0.55 + 110).clip(0, 255).astype(np.uint8)
    rain = img.copy()
    rain[:, ::7] = np.minimum(rain[:, ::7].astype(int) + 120,
                              255).astype(np.uint8)
    return {"clean": img, "foggy": fog, "rainy": rain}


def write_triplet_datasets(root: str, n_images: int = 8, h: int = 120,
                           w: int = 160, boxes=(1, 4), box_side=(15, 40),
                           seed: int = 0, level: int = 1) -> dict:
    """Write the clean/foggy/rainy trees and their annotation json under
    ``root``; ``boxes``: [low, high) boxes an image, ``box_side``: [low,
    high) pixels a side, classes drawn from ``CATEGORIES``. Returns
    {domain: (image dir, annotation file)}."""
    rng = np.random.RandomState(seed)
    dirs = {d: os.path.join(root, d) for d in DOMAINS}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        img = rng.randint(0, 60, (h, w, 3), dtype=np.uint8)
        for _ in range(rng.randint(*boxes)):
            bw, bh = (int(v) for v in rng.randint(*box_side, 2))
            x1 = int(rng.randint(0, w - bw - 1))
            y1 = int(rng.randint(0, h - bh - 1))
            label = int(rng.randint(1, len(CATEGORIES) + 1))
            img[y1:y1 + bh, x1:x1 + bw] = ((220, 40, 40) if label == 1
                                           else (40, 220, 40))
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1,
                "category_id": label, "bbox": [x1, y1, bw, bh],
                "area": bw * bh, "iscrowd": 0})
        name = f"img_{i:04d}.png"
        for d, arr in degrade(img).items():
            write_png(os.path.join(dirs[d], name), arr, level)
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": CATEGORIES}, f)
    return {d: (dirs[d], ann) for d in DOMAINS}
