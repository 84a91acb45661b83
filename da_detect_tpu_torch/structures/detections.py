"""The eval forward's fixed-capacity detections (the JAX package's
``Detections`` of ``models/box_head.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4]
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int64 (1..C-1)
    valid: torch.Tensor   # [B, D]
