"""Box, NMS and ROIAlign ops; each CUDA kernel sits beside its plain version.
Importing the package registers the kernels' operators (``library``)."""

from . import library  # noqa: F401
