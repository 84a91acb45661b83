from .base import AbstractDataset, ListDataset
from .coco import COCODataset, ConcatDataset
from .voc import PascalVOCDataset

__all__ = ["AbstractDataset", "COCODataset", "ConcatDataset", "ListDataset",
           "PascalVOCDataset"]
