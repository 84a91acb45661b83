from .cast import Conv2d, Linear, compute_dtype
from .deform_conv import DeformConv2d
from .norms import FrozenBatchNorm

__all__ = ["Conv2d", "DeformConv2d", "FrozenBatchNorm", "Linear",
           "compute_dtype"]
