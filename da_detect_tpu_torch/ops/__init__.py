"""Box, NMS and ROIAlign ops; each CUDA kernel sits beside its plain version."""
