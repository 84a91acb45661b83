from .predictor import COCODemo

__all__ = ["COCODemo"]
