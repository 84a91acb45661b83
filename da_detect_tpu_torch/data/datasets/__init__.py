from .base import AbstractDataset
from .coco import COCODataset, ConcatDataset

__all__ = ["AbstractDataset", "COCODataset", "ConcatDataset"]
