from .image_batch import ImageBatch, Targets

__all__ = ["ImageBatch", "Targets"]
