"""Proposal-to-GT matching, plain PyTorch (port of
``da_detect_tpu/ops/matcher.py``).

Sentinels: -1 = below the low threshold, -2 = between the thresholds. ``iou``
is [..., N_pred, G_gt]; padded GT columns are excluded through ``gt_valid``.
With ``allow_low_quality_matches`` a prediction that is some GT's best match
is restored to its own argmax match, as the reference does, except that a GT
whose best IoU is 0 restores nothing (the JAX package's deliberate deviation:
the reference would mark every zero-IoU prediction as that GT's match). With
no valid GT every prediction is -1.
"""

from __future__ import annotations

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_proposals(iou: torch.Tensor, gt_valid: torch.Tensor,
                    high_threshold: float, low_threshold: float,
                    allow_low_quality_matches: bool = False) -> torch.Tensor:
    """Returns matches [..., N] int64: GT index, -1 or -2."""
    masked = torch.where(gt_valid[..., None, :], iou, -1.0)
    # ties: the first maximum, as jnp.argmax
    matched_vals, all_matches = masked.max(dim=-1)
    matches = torch.where(matched_vals < low_threshold, BELOW_LOW_THRESHOLD,
                          all_matches)
    matches = torch.where((matched_vals >= low_threshold)
                          & (matched_vals < high_threshold),
                          BETWEEN_THRESHOLDS, matches)
    if allow_low_quality_matches:
        best_per_gt = masked.amax(dim=-2, keepdim=True)           # [..., 1, G]
        is_best = ((masked == best_per_gt) & gt_valid[..., None, :]
                   & (best_per_gt > 0))
        matches = torch.where(is_best.any(dim=-1), all_matches, matches)
    any_gt = gt_valid.any(dim=-1)[..., None]
    return torch.where(any_gt, matches, BELOW_LOW_THRESHOLD)
