"""Evaluation dispatch (port of ``da_detect_tpu/data/evaluation/__init__.py``;
reference data/datasets/evaluation/__init__.py).

COCO-style datasets take the COCO protocol, or with ``style="cityscapes"``
(``TEST.EVAL_STYLE``) the cityscapes-native instance-level AP; Pascal VOC
datasets the VOC mAP (``kwargs``: its ``iou_thresh``, ``use_07_metric``).
"""

from __future__ import annotations

from ..datasets import COCODataset, ConcatDataset, PascalVOCDataset
from .cityscapes_eval import do_cityscapes_evaluation
from .coco_eval import do_coco_evaluation
from .voc_eval import do_voc_evaluation


def evaluate(dataset, predictions, output_folder=None, iou_types=("bbox",),
             style: str = "coco", **kwargs):
    if isinstance(dataset, ConcatDataset):
        raise NotImplementedError("evaluate each test dataset separately")
    if isinstance(dataset, COCODataset):
        if style == "cityscapes":
            return do_cityscapes_evaluation(dataset, predictions,
                                            output_folder, iou_types)
        if style != "coco":
            raise ValueError(f"unknown TEST.EVAL_STYLE {style!r}")
        return do_coco_evaluation(dataset, predictions, output_folder,
                                  iou_types)
    if isinstance(dataset, PascalVOCDataset):
        return do_voc_evaluation(dataset, predictions, output_folder,
                                 **kwargs)
    raise NotImplementedError(f"no evaluator for {type(dataset)}")
