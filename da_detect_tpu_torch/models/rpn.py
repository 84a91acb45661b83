"""Region Proposal Network head, fixed-shape proposal selection, GT append
and loss (port of ``da_detect_tpu/models/rpn.py``).

Every dynamic-shape stage (top-k -> NMS -> variable proposal counts -> GT
append) is a fixed-capacity tensor with a validity mask, as in the JAX
package. Ties in every top-k break by lower index first, as ``lax.top_k``
does: the port sorts with ``torch.sort(stable=True)`` (``torch.topk`` orders
ties arbitrarily on the card). GT boxes are appended, and RPN supervision
given, for source-domain images only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d
from ..ops import box_ops
from ..ops.losses import bce_with_logits, smooth_l1_loss
from ..ops.matcher import match_proposals
from ..ops.nms import nms_topk
from ..ops.sampler import balanced_sample
from ..parallel.ddp import global_mean


class RPNHead(nn.Module):
    """3x3 conv + twin 1x1 convs (``rpn.head`` in the state_dict). Returns
    per-level (logits [B, A, H, W], deltas [B, A*4, H, W]) in ``dtype``;
    proposal selection and the RPN loss take them to float32."""

    def __init__(self, in_channels: int, num_anchors: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1,
                           compute_dtype=dtype)
        self.cls_logits = Conv2d(in_channels, num_anchors, 1,
                                 compute_dtype=dtype)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 1,
                                compute_dtype=dtype)

    def forward(self, features: list[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.cls_logits(t))
            deltas.append(self.bbox_pred(t))
        return logits, deltas


class Proposals(NamedTuple):
    boxes: torch.Tensor   # [B, P, 4]
    scores: torch.Tensor  # [B, P] (sigmoid objectness)
    valid: torch.Tensor   # [B, P]


def _select_level(anchors, obj, deltas, image_sizes, pre_nms, post_nms,
                  nms_thresh, min_size, impl):
    """All images, one level. anchors [N, 4], obj [B, N] logits,
    deltas [B, N, 4], image_sizes [B, 2] (h, w)."""
    n = anchors.shape[0]
    k1 = min(pre_nms, n)
    scores = torch.sigmoid(obj.float())
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k1], top_idx[:, :k1]
    top_deltas = torch.gather(deltas.float(), 1,
                              top_idx[..., None].expand(-1, -1, 4))
    boxes = box_ops.decode_boxes(top_deltas, anchors[top_idx])
    boxes = box_ops.clip_boxes(boxes, image_sizes[:, 0, None],
                               image_sizes[:, 1, None])
    valid = box_ops.min_size_mask(boxes, float(min_size))
    # the sorted top-k is already score-descending -> skip the NMS sort
    keep_idx, keep_valid = nms_topk(boxes, top_scores, valid, nms_thresh,
                                    post_nms, presorted=True, impl=impl)
    kept_boxes = torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    kept_scores = torch.gather(top_scores, 1, keep_idx)
    return kept_boxes, torch.where(keep_valid, kept_scores, 0.0), keep_valid


def level_rows(logits: torch.Tensor, deltas: torch.Tensor):
    """One level's [B, A, H, W] logits and [B, A*4, H, W] deltas -> [B, N]
    and [B, N, 4], N = H*W*A in the anchors' (h, w, a) order."""
    b = logits.shape[0]
    return (logits.permute(0, 2, 3, 1).reshape(b, -1),
            deltas.permute(0, 2, 3, 1).reshape(b, -1, 4))


def select_proposals(level_anchors, level_logits, level_deltas, image_sizes,
                     *, pre_nms_top_n, post_nms_top_n, fpn_post_nms_top_n,
                     nms_thresh, min_size, is_train, impl):
    """Batched proposal selection over all levels. level_anchors: list of
    [N_l, 4]; level_logits: list of [B, A, H, W]; level_deltas: list of
    [B, A*4, H, W]. Returns Proposals with capacity post_nms_top_n (one
    level) or min(fpn_post_nms_top_n, N_all) (FPN, N_all the survivors of
    every level).

    Across levels, each level's post-NMS survivors are concatenated. Eval:
    the top fpn_post_nms_top_n of each image, scores of invalid rows 0.
    Training keeps the reference's quirk: fpn_post_nms_top_n over the whole
    batch. The threshold is the batch's fpn_post_nms_top_n-th largest score
    (ties at it all kept); each image's survivors are compacted to the front
    by a stable descending sort, with their raw scores."""
    per_level = []
    for anchors, logits, deltas in zip(level_anchors, level_logits,
                                       level_deltas):
        obj, dl = level_rows(logits, deltas)
        per_level.append(Proposals(*_select_level(
            anchors, obj, dl, image_sizes, pre_nms_top_n, post_nms_top_n,
            nms_thresh, min_size, impl)))
    if len(per_level) == 1:
        return per_level[0]
    boxes = torch.cat([p.boxes for p in per_level], dim=1)
    scores = torch.cat([p.scores for p in per_level], dim=1)
    valid = torch.cat([p.valid for p in per_level], dim=1)
    k = min(fpn_post_nms_top_n, boxes.shape[1])
    masked = torch.where(valid, scores, float("-inf"))
    if is_train:
        flat = masked.reshape(-1)
        kb = min(fpn_post_nms_top_n, flat.shape[0])
        thresh = torch.topk(flat, kb).values.min()
        sel_valid = valid & (masked >= thresh)
        _, order = torch.sort(torch.where(sel_valid, scores, float("-inf")),
                              dim=1, descending=True, stable=True)
        order = order[:, :k]
        return Proposals(
            boxes=torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            scores=torch.gather(scores, 1, order),
            valid=torch.gather(sel_valid, 1, order))
    top_scores, order = torch.sort(masked, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    finite = torch.isfinite(top_scores)
    return Proposals(
        boxes=torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
        scores=torch.where(finite, top_scores, 0.0),
        valid=finite)


def append_gt_proposals(proposals: Proposals, gt_boxes, gt_valid,
                        is_source) -> Proposals:
    """Append the GT boxes [B, G, 4] of source images as proposals with
    objectness 1; target images' GT rows are appended invalid."""
    gt_ok = gt_valid & is_source[:, None]
    return Proposals(
        boxes=torch.cat([proposals.boxes, gt_boxes], dim=1),
        scores=torch.cat([proposals.scores, gt_ok.to(proposals.scores.dtype)],
                         dim=1),
        valid=torch.cat([proposals.valid, gt_ok], dim=1))


def rpn_loss(anchors, objectness, deltas, gt_boxes, gt_valid, is_source,
             image_sizes, *, fg_iou, bg_iou, batch_per_image,
             positive_fraction, straddle_thresh, generator=None,
             priorities=None):
    """RPN losses. anchors [N, 4]; objectness [B, N] logits; deltas
    [B, N, 4]; gt_* padded [B, G]; is_source [B]; image_sizes [B, 2] (h, w).
    ``generator``/``priorities`` feed the sampler. Returns
    (loss_objectness, loss_rpn_box_reg): a BCE weighted mean over the sampled
    anchors, and the positives' smooth-L1 sum over the sampled count, both
    over the global batch (in a process group, this rank's share:
    ``parallel.global_mean``)."""
    objectness = objectness.float()
    deltas = deltas.float()
    iou = box_ops.box_iou(anchors, gt_boxes)                    # [B, N, G]
    matches = match_proposals(iou, gt_valid, fg_iou, bg_iou, True)
    labels = torch.where(matches >= 0, 1, torch.where(matches == -1, 0, -1))
    if straddle_thresh >= 0:
        sizes = image_sizes.float()
        inside = ((anchors[:, 0] >= -straddle_thresh)
                  & (anchors[:, 1] >= -straddle_thresh)
                  & (anchors[:, 2] < sizes[:, 1, None] + straddle_thresh)
                  & (anchors[:, 3] < sizes[:, 0, None] + straddle_thresh))
        labels = torch.where(inside, labels, -1)
    # target-domain images contribute no RPN supervision
    labels = torch.where(is_source[:, None], labels, -1)
    matched_gt = torch.gather(
        gt_boxes, 1, matches.clamp(min=0)[..., None].expand(-1, -1, 4))
    reg_targets = box_ops.encode_boxes(matched_gt, anchors)
    pos_mask, neg_mask = balanced_sample(
        labels, batch_per_image, positive_fraction, generator=generator,
        priorities=priorities)
    sampled = pos_mask | neg_mask
    box_loss = global_mean(
        smooth_l1_loss(deltas, reg_targets, beta=1.0 / 9,
                       weights=pos_mask[..., None].float(), reduction="sum"),
        sampled.sum(), 1)
    w = sampled.float()
    obj_loss = global_mean(
        bce_with_logits(objectness, (labels == 1).float(), weights=w,
                        reduction="none").sum(), w.sum(), 1e-10)
    return obj_loss, box_loss


def rpn_config(cfg, is_train: bool) -> dict:
    rpn = cfg.MODEL.RPN
    return dict(
        pre_nms_top_n=(rpn.PRE_NMS_TOP_N_TRAIN if is_train
                       else rpn.PRE_NMS_TOP_N_TEST),
        post_nms_top_n=(rpn.POST_NMS_TOP_N_TRAIN if is_train
                        else rpn.POST_NMS_TOP_N_TEST),
        fpn_post_nms_top_n=(rpn.FPN_POST_NMS_TOP_N_TRAIN if is_train
                            else rpn.FPN_POST_NMS_TOP_N_TEST),
        nms_thresh=rpn.NMS_THRESH,
        min_size=rpn.MIN_SIZE,
        is_train=is_train,
    )
