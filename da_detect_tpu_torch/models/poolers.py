"""ROI pooling (port of ``da_detect_tpu/models/poolers.py``).

``impl`` picks the ROIAlign: "cuda" goes through the kernels' autograd
functions (``ops/roi_align_cuda.py``: forward and backward kernels), "plain"
through the plain versions (``ops/roi_align.py``, differentiated by
autograd).

Multi-level (FPN) pooling assigns each ROI its level by FPN's Eqn. 1 on the
device, with no host sync and no data-dependent shape. "cuda" pools each
ROI from its own level in one forward launch; "plain" takes the JAX
package's fixed-shape form (every ROI from every level, then a mask sum).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..ops import box_ops
from ..ops import roi_align as roi_align_plain
from ..ops import roi_align_cuda


def assign_levels(rois: torch.Tensor, k_min: int, k_max: int
                  ) -> torch.Tensor:
    """rois [..., 4] -> level index in [0, k_max - k_min] (int64):
    floor(4 + log2(sqrt(area) / 224 + 1e-6)) with the legacy +1 area, in
    float32 (a 224 x 224 ROI is canonical, on level 4)."""
    s = torch.sqrt(box_ops.box_area(rois).clamp(min=0.0))
    lvl = torch.floor(4 + torch.log2(s / 224 + 1e-6))
    return (lvl.clamp(k_min, k_max) - k_min).long()


def pool_rois(features: Sequence[torch.Tensor], rois: torch.Tensor, *,
              scales: Sequence[float], output_size: int, sampling_ratio: int,
              max_samples: int = 8, impl: str) -> torch.Tensor:
    """features: per-level [B, C, H_l, W_l] (levels past ``scales`` are not
    pooled); rois [B, R, 4] (image coords). Returns [B, R, C, P, P]."""
    if impl == "cuda":
        ops = roi_align_cuda
    elif impl == "plain":
        ops = roi_align_plain
    else:
        raise ValueError(f"unknown ROIAlign impl: {impl!r}")
    kw = dict(output_size=output_size, sampling_ratio=sampling_ratio,
              max_samples=max_samples)
    if len(scales) == 1:
        return ops.roi_align(features[0], rois, spatial_scale=scales[0], **kw)
    k_min = -int(math.log2(scales[0]))
    k_max = -int(math.log2(scales[-1]))
    levels = assign_levels(rois, k_min, k_max)                 # [B, R]
    return ops.roi_align_levels(list(features[:len(scales)]), rois, levels,
                                scales=scales, **kw)


def pooler_config(cfg, head: str = "ROI_BOX_HEAD") -> dict:
    """Single source of the pooler kwargs for every ROI head."""
    h = cfg.MODEL[head]
    return dict(scales=tuple(h.POOLER_SCALES), output_size=h.POOLER_RESOLUTION,
                sampling_ratio=h.POOLER_SAMPLING_RATIO,
                max_samples=cfg.TPU.ROI_MAX_SAMPLES)
