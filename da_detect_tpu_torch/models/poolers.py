"""ROI pooling (port of ``da_detect_tpu/models/poolers.py``, single level).

``impl`` picks the ROIAlign: "cuda" goes through the kernels' autograd
function (``ops/roi_align_cuda.py``: forward and backward kernels), "plain"
through the plain version (``ops/roi_align.py``, differentiated by
autograd). Multi-level (FPN) pooling is a later slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops import roi_align as roi_align_plain
from ..ops import roi_align_cuda


def pool_rois(features: Sequence[torch.Tensor], rois: torch.Tensor, *,
              scales: Sequence[float], output_size: int, sampling_ratio: int,
              max_samples: int = 8, impl: str) -> torch.Tensor:
    """features: per-level [B, C, H_l, W_l]; rois [B, R, 4] (image coords).
    Returns [B, R, C, P, P]."""
    if len(features) != 1:
        raise NotImplementedError(
            "multi-level (FPN) ROI pooling is a later slice")
    if impl == "cuda":
        fn = roi_align_cuda.roi_align
    elif impl == "plain":
        fn = roi_align_plain.roi_align
    else:
        raise ValueError(f"unknown ROIAlign impl: {impl!r}")
    return fn(features[0], rois, spatial_scale=scales[0],
              output_size=output_size, sampling_ratio=sampling_ratio,
              max_samples=max_samples)


def pooler_config(cfg, head: str = "ROI_BOX_HEAD") -> dict:
    """Single source of the pooler kwargs for every ROI head."""
    h = cfg.MODEL[head]
    return dict(scales=tuple(h.POOLER_SCALES), output_size=h.POOLER_RESOLUTION,
                sampling_ratio=h.POOLER_SAMPLING_RATIO,
                max_samples=cfg.TPU.ROI_MAX_SAMPLES)
