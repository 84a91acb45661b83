"""ROI box head: the C4 feature extractor, the predictor, training-time
sampling and losses, and the detection post-processing (port of
``da_detect_tpu/models/box_head.py``).

Sampling carries a per-ROI domain mask (True on source images) and makes
every proposal of a target image background, so target images sample an
unsupervised subset; the classification and regression losses count source
rows only. The extractors are the C4 res5 head and the FPN two-layer MLP
(``FPN2MLPFeatureExtractor``, whose fc6 reads the pooled [C, P, P] map
flattened in maskrcnn-benchmark's (C, H, W) order); the FPN conv head
(``FPNXconv1fcFeatureExtractor``) is a later slice and raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import box_ops
from ..ops.losses import smooth_l1_loss, softmax_cross_entropy
from ..ops.matcher import match_proposals
from ..ops.nms import nms_topk
from ..ops.sampler import balanced_sample, selection_to_indices
from .backbone.resnet import ResNetHead
from .poolers import pool_rois, pooler_config


class ResNet50Conv5ROIFeatureExtractor(nn.Module):
    """C4: pool 14x14 from the single C4 map, run res5 ->
    [B, R, 2048, 7, 7] (reference roi_box_feature_extractors.py:13-45)."""

    def __init__(self, pooler: dict, depth: int = 50, num_groups: int = 1,
                 width_per_group: int = 64, res2_out_channels: int = 256,
                 stride_in_1x1: bool = True, dilation: int = 1):
        super().__init__()
        self.pooler = pooler
        self.head = ResNetHead(depth=depth, num_groups=num_groups,
                               width_per_group=width_per_group,
                               res2_out_channels=res2_out_channels,
                               stride_in_1x1=stride_in_1x1,
                               first_stride=2 if dilation == 1 else 1,
                               dilation=dilation)

    def forward(self, features, rois, *, impl: str):
        x = pool_rois(features, rois, **self.pooler, impl=impl)
        b, r = x.shape[:2]
        x = x.reshape((b * r,) + x.shape[2:]).contiguous(
            memory_format=torch.channels_last)
        x = self.head(x)
        return x.reshape((b, r) + x.shape[1:])


class FPN2MLPFeatureExtractor(nn.Module):
    """FPN: pool P x P from the assigned level, flatten (C, H, W), then
    fc6 and fc7 with ReLU -> [B, R, mlp_dim] (reference
    roi_box_feature_extractors.py:48-79)."""

    def __init__(self, pooler: dict, in_channels: int, mlp_dim: int = 1024):
        super().__init__()
        self.pooler = pooler
        p = pooler["output_size"]
        self.fc6 = nn.Linear(in_channels * p * p, mlp_dim)
        self.fc7 = nn.Linear(mlp_dim, mlp_dim)

    def forward(self, features, rois, *, impl: str):
        x = pool_rois(features, rois, **self.pooler, impl=impl)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    """C4 predictor: global average pool + linear cls/bbox heads."""

    def __init__(self, in_channels: int, num_classes: int,
                 cls_agnostic: bool = False):
        super().__init__()
        num_bbox = 2 if cls_agnostic else num_classes
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_bbox * 4)

    def forward(self, x):
        # x [B, R, C, 7, 7] -> average pool
        x = x.mean(dim=(-2, -1))
        return self.cls_score(x), self.bbox_pred(x)


class FPNPredictor(nn.Module):
    """FPN predictor: linear cls/bbox heads on the MLP features."""

    def __init__(self, in_channels: int, num_classes: int,
                 cls_agnostic: bool = False):
        super().__init__()
        num_bbox = 2 if cls_agnostic else num_classes
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_bbox * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class SampledRois(NamedTuple):
    rois: torch.Tensor         # [B, S, 4]
    valid: torch.Tensor        # [B, S]
    labels: torch.Tensor       # [B, S] int64 class (0 = background)
    reg_targets: torch.Tensor  # [B, S, 4]
    domain_mask: torch.Tensor  # [B, S] bool (True = source image)


def _take(x, idx):
    """x [B, P, ...] rows at idx [B, S]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def subsample_proposals(proposals_boxes, proposals_valid, gt_boxes,
                        gt_labels, gt_valid, is_source, *, fg_iou, bg_iou,
                        batch_per_image, positive_fraction, reg_weights,
                        generator=None, priorities=None) -> SampledRois:
    """Match proposals [B, P] to GT [B, G], label them, and sample
    S = batch_per_image per image, positives first. ``generator`` or
    ``priorities`` (a pair of [B, P] tensors) feed the sampler."""
    iou = box_ops.box_iou(proposals_boxes, gt_boxes)              # [B, P, G]
    iou = torch.where(proposals_valid[..., None], iou, -1.0)
    matches = match_proposals(iou, gt_valid, fg_iou, bg_iou, False)
    safe = matches.clamp(min=0)
    matched_gt = _take(gt_boxes, safe)
    labels = torch.gather(gt_labels.long(), 1, safe)
    labels = torch.where(matches == -1, 0, labels)        # below low -> bg
    labels = torch.where(matches == -2, -1, labels)       # between -> ignore
    labels = torch.where(proposals_valid, labels, -1)     # padded -> ignore
    # a target image: every proposal is background, so sampling picks an
    # unsupervised subset
    labels = torch.where(is_source[:, None], labels,
                         torch.where(proposals_valid, 0, -1))
    reg = box_ops.encode_boxes(matched_gt, proposals_boxes, reg_weights)
    pos_m, neg_m = balanced_sample(labels, batch_per_image, positive_fraction,
                                   generator=generator, priorities=priorities)
    idx, is_pos, valid = selection_to_indices(pos_m, neg_m, batch_per_image)
    return SampledRois(
        rois=_take(proposals_boxes, idx),
        valid=valid,
        labels=torch.where(is_pos, torch.gather(labels, 1, idx), 0),
        reg_targets=_take(reg, idx),
        domain_mask=is_source[:, None] & valid)


def fast_rcnn_loss(class_logits, box_regression, sampled: SampledRois,
                   cls_agnostic: bool = False):
    """Classification and box losses over source rows only, each normalized
    by the number of source rows. class_logits [B, S, K], box_regression
    [B, S, 4K] (or [B, S, 8] class-agnostic)."""
    logits = class_logits.reshape(-1, class_logits.shape[-1]).float()
    deltas = box_regression.reshape(-1, box_regression.shape[-1]).float()
    labels = sampled.labels.reshape(-1)
    reg_targets = sampled.reg_targets.reshape(-1, 4)
    dom = (sampled.domain_mask & sampled.valid).reshape(-1)
    w = dom.float()
    cls_loss = softmax_cross_entropy(logits, labels, w)
    pos = dom & (labels > 0)
    if cls_agnostic:
        pos_deltas = deltas[:, 4:8]
    else:
        idx = 4 * labels[:, None] + torch.arange(4, device=labels.device)
        pos_deltas = torch.gather(deltas, 1, idx)
    n_dom = w.sum().clamp(min=1.0)
    box_loss = smooth_l1_loss(pos_deltas, reg_targets, beta=1.0,
                              weights=pos[:, None].float(),
                              reduction="sum") / n_dom
    return cls_loss, box_loss


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4]
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int64 (1..C-1)
    valid: torch.Tensor   # [B, D]


def postprocess_detections(class_logits, box_regression, proposal_boxes,
                           proposal_valid, image_sizes, *, score_thresh,
                           nms_thresh, detections_per_img, reg_weights,
                           cls_agnostic=False, pre_nms_candidates=2048,
                           impl: str):
    """Softmax -> per-class decode -> threshold -> per-class NMS (one NMS over
    class-offset boxes, equivalent to the reference's per-class loop) -> top
    detections_per_img. Batched over images; inputs [B, P, ...]."""
    b, p, num_classes = class_logits.shape
    probs = torch.softmax(class_logits.float(), dim=-1)            # [B, P, C]
    deltas = box_regression.float()
    if cls_agnostic:
        boxes1 = box_ops.decode_boxes(deltas[..., 4:8], proposal_boxes,
                                      reg_weights)
        boxes = boxes1[:, :, None, :].expand(-1, -1, num_classes, -1)
    else:
        boxes = box_ops.decode_boxes(deltas, proposal_boxes, reg_weights
                                     ).reshape(b, p, num_classes, 4)
    boxes = box_ops.clip_boxes(boxes, image_sizes[:, 0, None, None],
                               image_sizes[:, 1, None, None])

    # drop the background column, flatten (box, class) pairs
    cls_ids = torch.arange(num_classes, device=probs.device).expand(b, p, -1)
    flat_scores = probs[:, :, 1:].reshape(b, -1)
    flat_boxes = boxes[:, :, 1:, :].reshape(b, -1, 4)
    flat_cls = cls_ids[:, :, 1:].reshape(b, -1)
    flat_valid = proposal_valid[:, :, None].expand(-1, -1, num_classes - 1
                                                   ).reshape(b, -1)
    flat_valid = flat_valid & (flat_scores > score_thresh)

    k = min(pre_nms_candidates, flat_scores.shape[1])
    top_scores, top_idx = torch.sort(
        torch.where(flat_valid, flat_scores, -1.0), dim=1, descending=True,
        stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    cand_boxes = torch.gather(flat_boxes, 1,
                              top_idx[..., None].expand(-1, -1, 4))
    cand_cls = torch.gather(flat_cls, 1, top_idx)
    cand_valid = top_scores > 0.0
    # per-class NMS via coordinate offset; offset unit = max coordinate + 1
    # (a huge constant would eat float32 precision for high classes)
    unit = torch.where(cand_valid[..., None], cand_boxes, 0.0
                       ).amax(dim=(1, 2)) + 1.0                    # [B]
    offset = cand_cls.float()[..., None] * unit[:, None, None]
    keep_idx, keep_valid = nms_topk(cand_boxes + offset, top_scores,
                                    cand_valid, nms_thresh,
                                    min(detections_per_img, k), impl=impl)
    return Detections(
        boxes=torch.gather(cand_boxes, 1,
                           keep_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep_valid, torch.gather(top_scores, 1, keep_idx),
                           0.0),
        labels=torch.where(keep_valid, torch.gather(cand_cls, 1, keep_idx),
                           0),
        valid=keep_valid)


def make_box_feature_extractor(cfg, in_channels: int):
    """Returns (extractor, its output channels); ``in_channels`` is the
    backbone's (the FPN levels' width)."""
    name = cfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR
    h = cfg.MODEL.ROI_BOX_HEAD
    r = cfg.MODEL.RESNETS
    if h.USE_GN:
        raise NotImplementedError("GroupNorm box heads are a later slice")
    pooler = pooler_config(cfg, "ROI_BOX_HEAD")
    if name == "ResNet50Conv5ROIFeatureExtractor":
        return ResNet50Conv5ROIFeatureExtractor(
            pooler, depth=50, num_groups=r.NUM_GROUPS,
            width_per_group=r.WIDTH_PER_GROUP,
            res2_out_channels=r.RES2_OUT_CHANNELS,
            stride_in_1x1=r.STRIDE_IN_1X1, dilation=h.DILATION
        ), r.RES2_OUT_CHANNELS * 8
    if name == "FPN2MLPFeatureExtractor":
        return FPN2MLPFeatureExtractor(pooler, in_channels, h.MLP_HEAD_DIM
                                       ), h.MLP_HEAD_DIM
    raise NotImplementedError(
        f"feature extractor {name}: the port builds "
        "ResNet50Conv5ROIFeatureExtractor and FPN2MLPFeatureExtractor; the "
        "others are later slices")


_PREDICTORS = {"FastRCNNPredictor": FastRCNNPredictor,
               "FPNPredictor": FPNPredictor}


def make_box_predictor(cfg, in_channels: int):
    name = cfg.MODEL.ROI_BOX_HEAD.PREDICTOR
    if name not in _PREDICTORS:
        raise NotImplementedError(
            f"predictor {name}: the port builds {', '.join(_PREDICTORS)}")
    return _PREDICTORS[name](in_channels, cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
                             cls_agnostic=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG)
