from .cast import Conv2d, ConvTranspose2d, Linear, compute_dtype
from .deform_conv import DeformConv2d
from .norms import BatchNorm, FrozenBatchNorm, GroupNorm, make_norm
from .rows import RowOps

__all__ = ["BatchNorm", "Conv2d", "ConvTranspose2d", "DeformConv2d",
           "FrozenBatchNorm", "GroupNorm", "Linear", "RowOps",
           "compute_dtype", "make_norm"]
