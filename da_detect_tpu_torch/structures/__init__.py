from .detections import Detections
from .image_batch import ImageBatch, Targets

__all__ = ["Detections", "ImageBatch", "Targets"]
