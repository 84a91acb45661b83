from .deform_conv import DeformConv2d
from .norms import FrozenBatchNorm

__all__ = ["DeformConv2d", "FrozenBatchNorm"]
