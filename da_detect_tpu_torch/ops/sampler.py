"""Balanced positive/negative sampling, fixed-shape (port of
``da_detect_tpu/ops/sampler.py``).

Positives are capped at ``batch_size * positive_fraction``, negatives fill the
rest, each chosen uniformly at random as the elements with the largest iid
uniform priorities. The priorities are drawn from an explicit
``torch.Generator`` or passed in as tensors, so that a test can hand both
frameworks the same draws (PyTorch cannot reproduce JAX's streams). The
selection masks and index lists keep fixed shapes.
"""

from __future__ import annotations

from typing import Optional

import torch


def _take_random(mask: torch.Tensor, priority: torch.Tensor,
                 count: torch.Tensor, cap: int) -> torch.Tensor:
    """Select ``count`` (per row, <= cap) elements of ``mask``: those whose
    priority reaches the count-th largest. A cumulative-count cap keeps the
    selection at exactly ``count`` when priorities tie at the threshold."""
    n = mask.shape[-1]
    masked = torch.where(mask, priority, float("-inf"))
    k = min(cap, n)
    vals = torch.topk(masked, k, dim=-1).values
    idx = (count - 1).clamp(0, k - 1)
    thr = torch.gather(vals, -1, idx[..., None])[..., 0]
    sel = mask & (masked >= thr[..., None]) & (count[..., None] > 0)
    return sel & (torch.cumsum(sel, dim=-1) <= count[..., None])


def balanced_sample(labels: torch.Tensor, batch_size: int,
                    positive_fraction: float, *,
                    generator: Optional[torch.Generator] = None,
                    priorities: Optional[tuple] = None):
    """labels [..., N]: -1 ignore, 0 negative, >= 1 positive.

    Returns (pos_selected, neg_selected) bool masks [..., N] with
    |pos| = min(#pos, batch_size * fraction) and
    |neg| = min(#neg, batch_size - |pos|). ``priorities`` is a pair of
    [..., N] float tensors (positives', negatives'); without it both are
    drawn uniform from ``generator``."""
    is_pos = labels >= 1
    is_neg = labels == 0
    if priorities is None:
        priorities = tuple(
            torch.rand(labels.shape, generator=generator,
                       device=labels.device) for _ in range(2))
    pos_prio, neg_prio = priorities
    num_pos_cap = int(batch_size * positive_fraction)
    num_pos = is_pos.sum(dim=-1).clamp(max=num_pos_cap)
    num_neg = torch.minimum(is_neg.sum(dim=-1), batch_size - num_pos)
    return (_take_random(is_pos, pos_prio, num_pos, num_pos_cap),
            _take_random(is_neg, neg_prio, num_neg, batch_size))


def selection_to_indices(pos_selected: torch.Tensor,
                         neg_selected: torch.Tensor, batch_size: int):
    """Selection masks [..., N] -> a fixed-length index list [..., batch_size]:
    positives first, then negatives, each in index order, then padding
    (index 0, valid False). Returns (indices, is_pos, valid)."""
    prio = torch.where(pos_selected, 2, torch.where(neg_selected, 1, 0))
    sel, order = torch.sort(prio, dim=-1, descending=True, stable=True)
    sel, order = sel[..., :batch_size], order[..., :batch_size]
    pad = batch_size - order.shape[-1]
    if pad > 0:
        # fewer candidates than the sampling budget
        order = torch.cat([order, order.new_zeros(order.shape[:-1] + (pad,))],
                          dim=-1)
        sel = torch.cat([sel, sel.new_zeros(sel.shape[:-1] + (pad,))], dim=-1)
    valid = sel >= 1
    return torch.where(valid, order, 0), sel == 2, valid
