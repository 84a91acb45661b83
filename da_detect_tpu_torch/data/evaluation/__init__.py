"""Evaluation dispatch (port of ``da_detect_tpu/data/evaluation/__init__.py``;
reference data/datasets/evaluation/__init__.py).

COCO-style datasets take the COCO protocol. ``style="cityscapes"`` (the
cityscapes-native instance-level AP) and the VOC evaluator are not ported
yet and raise.
"""

from __future__ import annotations

from ..datasets import COCODataset, ConcatDataset
from .coco_eval import do_coco_evaluation


def evaluate(dataset, predictions, output_folder=None, iou_types=("bbox",),
             style: str = "coco"):
    if isinstance(dataset, ConcatDataset):
        raise NotImplementedError("evaluate each test dataset separately")
    if not isinstance(dataset, COCODataset):
        raise NotImplementedError(f"no evaluator for {type(dataset)}")
    if style == "cityscapes":
        raise NotImplementedError(
            "TEST.EVAL_STYLE cityscapes: cityscapes_eval is not ported yet")
    if style != "coco":
        raise ValueError(f"unknown TEST.EVAL_STYLE {style!r}")
    return do_coco_evaluation(dataset, predictions, output_folder, iou_types)
