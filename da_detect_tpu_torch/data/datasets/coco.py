"""COCO-style dataset (port of ``da_detect_tpu/data/datasets/coco.py``;
reference data/datasets/coco.py:44-124) without pycocotools: the
annotation json is parsed directly.

Returns host-side numpy samples; the loader handles resize, flip, padding
and normalization. Carries the DA ``is_source`` domain flag per dataset
(reference coco.py:96-97).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np


class COCODataset:
    def __init__(self, ann_file: str, root: str,
                 remove_images_without_annotations: bool = True,
                 is_source: bool = True, transforms=None):
        with open(ann_file) as f:
            coco = json.load(f)
        self.root = root
        self.is_source = is_source
        self.transforms = transforms

        self.cats = {c["id"]: c for c in coco.get("categories", [])}
        cat_ids = sorted(self.cats)
        # contiguous remapping, background = 0 (reference coco.py:64-69)
        self.json_category_id_to_contiguous_id = {
            cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()}

        anns_by_img = defaultdict(list)
        for a in coco.get("annotations", []):
            anns_by_img[a["image_id"]].append(a)

        self.images = []
        self.anns = {}        # training anns: crowd filtered (coco.py:80)
        self.eval_anns = {}   # evaluation keeps crowd as ignore regions
        for img in sorted(coco["images"], key=lambda im: im["id"]):
            all_anns = [a for a in anns_by_img.get(img["id"], [])
                        if a.get("bbox") and a["bbox"][2] > 0 and a["bbox"][3] > 0]
            anns = [a for a in all_anns if not a.get("iscrowd", 0)]
            if remove_images_without_annotations and not anns:
                continue
            self.images.append(img)
            self.anns[img["id"]] = anns
            self.eval_anns[img["id"]] = all_anns
        self.ids = [im["id"] for im in self.images]

    def __len__(self):
        return len(self.images)

    def get_img_info(self, index: int) -> dict:
        return self.images[index]

    def sample(self, index: int) -> dict:
        """Raw host sample: image path + xyxy boxes + contiguous labels."""
        info = self.images[index]
        anns = self.anns[info["id"]]
        boxes = np.asarray([a["bbox"] for a in anns],
                           np.float32).reshape(-1, 4)
        # xywh -> xyxy with the legacy TO_REMOVE=1 convention
        # (reference coco.py:86-88 BoxList convert)
        if len(boxes):
            boxes = np.stack([boxes[:, 0], boxes[:, 1],
                              boxes[:, 0] + np.maximum(boxes[:, 2] - 1, 0),
                              boxes[:, 1] + np.maximum(boxes[:, 3] - 1, 0)], 1)
        labels = np.asarray(
            [self.json_category_id_to_contiguous_id[a["category_id"]]
             for a in anns], np.int32)
        segs = [a.get("segmentation") for a in anns]
        return dict(
            path=os.path.join(self.root, info["file_name"]),
            image_id=info["id"],
            width=info["width"],
            height=info["height"],
            boxes=boxes,
            labels=labels,
            segmentations=segs,
            keypoints=[a.get("keypoints") for a in anns],
            is_source=self.is_source,
        )


class ConcatDataset:
    """reference data/datasets/concat_dataset.py — id-remapped concat."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, index):
        di = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[di], index - int(self.offsets[di])

    def sample(self, index):
        d, i = self._locate(index)
        return d.sample(i)

    def get_img_info(self, index):
        d, i = self._locate(index)
        return d.get_img_info(i)
