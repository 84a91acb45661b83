"""Elementwise losses, plain PyTorch (port of ``da_detect_tpu/ops/losses.py``).

The reductions are the JAX package's, not PyTorch's: a weighted mean divides
by ``max(sum(weights), 1e-10)``, so
``F.binary_cross_entropy_with_logits(weight=...)`` (which divides by the
element count) is a different function. ``sigmoid_focal_loss`` is
RetinaNet's focal loss; the JAX package computes it in plain ``jnp`` too
(no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def smooth_l1_loss(input: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9,
                   weights: Optional[torch.Tensor] = None,
                   reduction: str = "sum") -> torch.Tensor:
    """Huber loss with threshold ``beta``."""
    n = (input - target).abs()
    loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    if weights is not None:
        loss = loss * weights
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    reduction: str = "mean") -> torch.Tensor:
    """Numerically stable binary cross entropy on logits; a weighted mean
    divides by the weights' sum."""
    loss = (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    if weights is not None:
        loss = loss * weights
        if reduction == "mean":
            return loss.sum() / weights.sum().clamp(min=1e-10)
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """RetinaNet's focal loss summed over the classes: ``logits`` [..., N,
    C] for classes 1..C (no background column), ``targets`` [..., N] with
    0 background, c in 1..C a class and -1 ignored (no term) -> [..., N]."""
    num_classes = logits.shape[-1]
    cls_ids = torch.arange(1, num_classes + 1, device=logits.device)
    t = targets[..., None]
    p = torch.sigmoid(logits)
    pos = (t == cls_ids).to(logits.dtype)
    neg = ((t != cls_ids) & (t >= 0)).to(logits.dtype)
    term_pos = -pos * alpha * (1.0 - p) ** gamma * F.logsigmoid(logits)
    term_neg = -neg * (1.0 - alpha) * p ** gamma * F.logsigmoid(-logits)
    return (term_pos + term_neg).sum(dim=-1)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin, p: float = 2.0,
                        dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss`` semantics (``eps`` inside
    ``|x - y + eps|``): p-distance along ``dim``, hinge at ``margin`` (a float
    or a 0-d tensor), mean over the rest."""
    def dist(x, y):
        return ((x - y + eps).abs() ** p).sum(dim=dim) ** (1.0 / p)

    return (dist(anchor, positive) - dist(anchor, negative)
            + margin).clamp(min=0.0).mean()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          reduction: str = "mean") -> torch.Tensor:
    """Mean cross entropy over rows (weighted: divided by the weights' sum),
    or with ``reduction="sum"`` the (weighted) sum; labels int [...]."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if weights is not None:
        nll = nll * weights
    if reduction == "sum":
        return nll.sum()
    if weights is None:
        return nll.mean()
    return nll.sum() / weights.sum().clamp(min=1e-10)
