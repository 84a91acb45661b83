from .boxes import Boxes, concat_boxes
from .detections import Detections
from .image_batch import ImageBatch, Targets

__all__ = ["Boxes", "Detections", "ImageBatch", "Targets", "concat_boxes"]
