from .norms import FrozenBatchNorm

__all__ = ["FrozenBatchNorm"]
