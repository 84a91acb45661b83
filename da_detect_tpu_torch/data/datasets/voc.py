"""Pascal VOC xml dataset (port of ``da_detect_tpu/data/datasets/voc.py``;
reference data/datasets/voc.py:17-134): ``ImageSets/Main/<split>.txt``
lists the ids, ``Annotations/<id>.xml`` holds the size and the boxes
(1-based, shifted to 0-based as the reference's TO_REMOVE), ``JPEGImages``
the images. Difficult objects are kept under ``use_difficult`` (evaluation)
and flagged in the sample."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

CLASSES = ("__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
           "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
           "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
           "tvmonitor")


class PascalVOCDataset:
    CLASSES = CLASSES

    def __init__(self, data_dir: str, split: str, use_difficult: bool = False,
                 is_source: bool = True, transforms=None):
        self.data_dir = data_dir
        self.split = split
        self.keep_difficult = use_difficult
        self.is_source = is_source
        self.transforms = transforms
        self._img_dir = os.path.join(data_dir, "JPEGImages")
        self._ann_dir = os.path.join(data_dir, "Annotations")
        split_file = os.path.join(data_dir, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.cls_to_ind = {c: i for i, c in enumerate(CLASSES)}
        self._infos = {}

    def __len__(self):
        return len(self.ids)

    def _parse(self, img_id: str):
        tree = ET.parse(os.path.join(self._ann_dir, f"{img_id}.xml"))
        boxes, labels, difficult = [], [], []
        size = tree.find("size")
        w = int(size.find("width").text)
        h = int(size.find("height").text)
        for obj in tree.iter("object"):
            diff = int(obj.find("difficult").text) == 1
            if diff and not self.keep_difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            # VOC is 1-indexed (reference voc.py TO_REMOVE=1)
            box = [float(bb.find("xmin").text) - 1,
                   float(bb.find("ymin").text) - 1,
                   float(bb.find("xmax").text) - 1,
                   float(bb.find("ymax").text) - 1]
            boxes.append(box)
            labels.append(self.cls_to_ind[name])
            difficult.append(diff)
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int32),
                np.asarray(difficult, bool), h, w)

    def get_img_info(self, index: int) -> dict:
        img_id = self.ids[index]
        if img_id not in self._infos:
            _, _, _, h, w = self._parse(img_id)
            self._infos[img_id] = dict(height=h, width=w, id=index,
                                       file_name=f"{img_id}.jpg")
        return self._infos[img_id]

    def sample(self, index: int) -> dict:
        img_id = self.ids[index]
        boxes, labels, difficult, h, w = self._parse(img_id)
        return dict(
            path=os.path.join(self._img_dir, f"{img_id}.jpg"),
            image_id=index,
            width=w,
            height=h,
            boxes=boxes,
            labels=labels,
            difficult=difficult,
            segmentations=[None] * len(labels),
            is_source=self.is_source,
        )

    def map_class_id_to_class_name(self, class_id):
        return CLASSES[class_id]
