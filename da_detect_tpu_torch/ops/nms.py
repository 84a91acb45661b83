"""Fixed-shape greedy NMS, plain PyTorch (port of ``da_detect_tpu/ops/nms.py``).

Greedy NMS over score-sorted boxes is the unique solution of

    keep[i] = valid[i] and not OR_{j<i} (keep[j] and iou(j, i) > t)

(the suppression relation is strictly upper-triangular in score order). As in
the JAX package, it is computed chunk by chunk: each chunk resolves by fixpoint
iteration on its [C, C] suppression matrix, then its kept boxes suppress every
later box. Every function takes a leading batch dim: boxes [B, N, 4]. Widths
are legacy +1 throughout.

``nms_mask_sorted`` is the plain version of the CUDA kernel in
``ops/nms_cuda.py``; ``nms_mask``/``nms_topk`` pick one of the two with
``impl`` ("cuda" or "plain") and add the sort and the top-k around it.
"""

from __future__ import annotations

import torch

from .box_ops import box_iou

NEG_INF = -1e30
CHUNK = 256  # boxes resolved together by the plain version


def _resolve_chunk(candidates: torch.Tensor,
                   suppress: torch.Tensor) -> torch.Tensor:
    """Exact greedy keep-set of one chunk per image.

    candidates [B, C] bool; suppress [B, C, C] bool, strictly upper-triangular
    (suppress[b, j, i] when kept j would suppress i, j < i in score order).
    Fixpoint iteration; any fixpoint equals the greedy answer.
    """
    keep = candidates
    for _ in range(candidates.shape[1]):
        new = candidates & ~torch.any(keep[:, :, None] & suppress, dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_mask_sorted(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                    iou_threshold: float,
                    max_keep: int | None = None) -> torch.Tensor:
    """Keep mask over score-descending boxes [B, N, 4] -> [B, N] bool.

    Invalid rows may sit anywhere: they neither keep nor suppress. With
    ``max_keep``, the mask ends after each image's ``max_keep``-th kept box
    in score order (later boxes are not kept)."""
    if max_keep is not None and max_keep < 1:
        raise ValueError(f"max_keep must be >= 1, got {max_keep}")
    batch, n = boxes_sorted.shape[:2]
    c = min(CHUNK, max(8, n))
    n_pad = -(-n // c) * c
    bs = boxes_sorted.new_zeros((batch, n_pad, 4))
    bs[:, :n] = boxes_sorted
    vs = torch.zeros((batch, n_pad), dtype=torch.bool,
                     device=boxes_sorted.device)
    vs[:, :n] = valid_sorted
    tri = torch.ones((c, c), dtype=torch.bool,
                     device=boxes_sorted.device).triu(1)
    suppressed = torch.zeros_like(vs)
    for c0 in range(0, n_pad, c):
        b_c = bs[:, c0:c0 + c]
        sup_c = suppressed[:, c0:c0 + c]
        v_c = vs[:, c0:c0 + c] & ~sup_c
        iou_cc = box_iou(b_c, b_c)
        keep_c = _resolve_chunk(v_c, tri & (iou_cc > iou_threshold))
        # kept boxes of this chunk suppress everything later
        iou_cn = box_iou(b_c, bs[:, c0 + c:])
        hit = torch.any(keep_c[:, :, None] & (iou_cn > iou_threshold), dim=1)
        suppressed[:, c0 + c:] |= hit
        suppressed[:, c0:c0 + c] = sup_c | (v_c & ~keep_c)
    keep = (vs & ~suppressed)[:, :n]
    if max_keep is not None:
        keep &= torch.cumsum(keep, dim=1) <= max_keep
    return keep


def _sorted_keep(boxes_sorted, valid_sorted, iou_threshold, impl, max_keep):
    if impl == "cuda":
        from .nms_cuda import nms_mask_sorted as kernel
        return kernel(boxes_sorted, valid_sorted, iou_threshold, max_keep)
    if impl == "plain":
        return nms_mask_sorted(boxes_sorted, valid_sorted, iou_threshold,
                               max_keep)
    raise ValueError(f"unknown NMS impl: {impl!r}")


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, *, impl: str, presorted: bool = False,
             max_keep: int | None = None) -> torch.Tensor:
    """Greedy NMS. boxes [B, N, 4], scores [B, N], valid [B, N] bool.
    Returns the keep mask [B, N] in the *original* box order. Ties are broken
    by original index (stable sort), like the reference's kernel.

    ``presorted`` skips the sort when scores already descend among valid
    entries (e.g. straight out of the pre-NMS top-k). ``max_keep`` keeps
    only the first ``max_keep`` survivors in score order."""
    if presorted:
        return _sorted_keep(boxes, valid, iou_threshold, impl, max_keep)
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    keep_s = _sorted_keep(boxes_s, valid_s, iou_threshold, impl, max_keep)
    return torch.zeros_like(keep_s).scatter_(1, order, keep_s)


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, k: int, *, impl: str,
             presorted: bool = False):
    """NMS then the top-k survivors by score.

    Returns (indices [B, k] into the original arrays, valid_k [B, k] bool),
    the fixed-capacity analog of the reference's ``keep[:post_nms_top_n]``.
    The top k survivors are the first k in the NMS's own score order, so the
    NMS stops after k kept boxes (``max_keep``).
    """
    keep = nms_mask(boxes, scores, valid, iou_threshold, impl=impl,
                    presorted=presorted, max_keep=max(k, 1))
    return topk_survivors(keep, scores, k)


def topk_survivors(keep: torch.Tensor, scores: torch.Tensor, k: int):
    """The top-k of the kept boxes by score, ties by index: (indices [B, k],
    valid_k [B, k] bool); rows past the survivors are index 0, invalid."""
    kept_scores = torch.where(keep, scores, NEG_INF)
    k_eff = min(k, kept_scores.shape[1])
    top_scores, idx = torch.sort(kept_scores, dim=1, descending=True,
                                 stable=True)
    top_scores, idx = top_scores[:, :k_eff], idx[:, :k_eff]
    if k_eff < k:
        pad = (idx.shape[0], k - k_eff)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=1)
        top_scores = torch.cat(
            [top_scores, top_scores.new_full(pad, NEG_INF)], dim=1)
    return idx, top_scores > NEG_INF / 2
