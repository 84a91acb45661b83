"""RetinaNet (port of ``da_detect_tpu/models/retinanet.py``; reference
modeling/rpn/retinanet/).

A single-stage detector over the P3-P7 pyramid (``R-*-FPN-RETINANET``
bodies): shared 4-conv class and box towers, the focal loss, per-level
candidate selection and one class-offset NMS an image. Semantics follow
the JAX package: the matcher at FG 0.5 / BG 0.4 with low-quality matches,
the straddle mask, the focal loss over ``num_pos + B``, smooth-L1 at beta
0.11 over ``num_pos * BBOX_REG_WEIGHT``, the prior-probability bias on the
class logits.

Candidate selection is exact: each level's top ``PRE_NMS_TOP_N`` (location,
class) scores with ties to the lower flat index, as ``lax.top_k`` orders
them: a stable descending sort, as the RPN's selection takes its top-k
(``rpn.py::_select_level``; ``torch.topk`` orders ties arbitrarily on the
card). The JAX package's ``TPU.APPROX_TOPK`` takes an
approximate top-k there, on the TPU only; the port has no such mode, so it
equals the JAX package with the key off. The final NMS runs on the card's
NMS kernel (``impl`` "cuda"); the training step launches no kernel.

State-dict names: ``backbone.body``, ``backbone.fpn`` (``fpn_p6``,
``fpn_p7``) and ``rpn.head`` (``cls_tower{i}``, ``bbox_tower{i}``,
``cls_logits``, ``bbox_pred``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, compute_dtype
from ..ops import box_ops
from ..ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ..ops.matcher import match_proposals
from ..ops.nms import nms_topk
from ..parallel.ddp import global_mean
from ..structures.image_batch import ImageBatch
from .anchors import AnchorGenerator, make_anchor_generator_retinanet
from .box_head import Detections
from .detector import Detector

REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class RetinaNetHead(nn.Module):
    """``num_convs`` 3x3 convs with ReLU a tower (class, box), shared by the
    levels, then the 3x3 ``cls_logits`` (A x classes) and ``bbox_pred``
    (A x 4): per level [B, A*K, H, W] and [B, A*4, H, W] in ``dtype``."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 num_convs: int = 4, prior_prob: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        # the class logits' initial bias (``init_retinanet``)
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        for tower in ("cls_tower", "bbox_tower"):
            for i in range(num_convs):
                self.add_module(f"{tower}{i}", Conv2d(
                    in_channels, in_channels, 3, padding=1,
                    compute_dtype=dtype))
        self.cls_logits = Conv2d(in_channels, num_anchors * num_classes, 3,
                                 padding=1, compute_dtype=dtype)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 3, padding=1,
                                compute_dtype=dtype)

    def _tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"{name}{i}")(x))
        return x

    def forward(self, features):
        logits = [self.cls_logits(self._tower("cls_tower", f))
                  for f in features]
        regs = [self.bbox_pred(self._tower("bbox_tower", f))
                for f in features]
        return logits, regs


def level_rows(logits: torch.Tensor, regs: torch.Tensor):
    """One level's [B, A*K, H, W] logits and [B, A*4, H, W] deltas ->
    [B, H*W*A, K] and [B, H*W*A, 4], rows in the anchors' (h, w, a)
    order."""
    b, k = logits.shape[0], logits.shape[1] // (regs.shape[1] // 4)
    return (logits.permute(0, 2, 3, 1).reshape(b, -1, k),
            regs.permute(0, 2, 3, 1).reshape(b, -1, 4))


def retinanet_loss(anchors, cls_logits, box_regression, gt_boxes, gt_labels,
                   gt_valid, image_sizes, *, fg_iou=0.5, bg_iou=0.4,
                   gamma=2.0, alpha=0.25, bbox_reg_beta=0.11,
                   regress_norm=4.0, straddle_thresh=0):
    """(focal classification loss, box regression loss). anchors [N, 4];
    cls_logits [B, N, K]; box_regression [B, N, 4]; gt_* padded [B, G];
    image_sizes [B, 2] (h, w). Anchors matched at ``fg_iou`` / ``bg_iou``
    with low-quality matches take their GT's label, those between the
    thresholds and those straddling the image by more than
    ``straddle_thresh`` (negative: none dropped) are ignored; the focal
    loss over the non-ignored anchors is divided by ``num_pos + B``, the
    positives' smooth-L1 by ``max(num_pos * regress_norm, 1)``, both over
    the global batch (``parallel.global_mean``)."""
    b = cls_logits.shape[0]
    cls_logits = cls_logits.float()
    box_regression = box_regression.float()
    iou = box_ops.box_iou(anchors, gt_boxes)                     # [B, N, G]
    matches = match_proposals(iou, gt_valid, fg_iou, bg_iou, True)
    safe = matches.clamp(min=0)
    labels = torch.where(matches >= 0,
                         torch.gather(gt_labels.long(), 1, safe), 0)
    labels = torch.where(matches == -2, -1, labels)
    if straddle_thresh >= 0:
        sizes = image_sizes.float()
        inside = ((anchors[:, 0] >= -straddle_thresh)
                  & (anchors[:, 1] >= -straddle_thresh)
                  & (anchors[:, 2] < sizes[:, 1, None] + straddle_thresh)
                  & (anchors[:, 3] < sizes[:, 0, None] + straddle_thresh))
        labels = torch.where(inside, labels, -1)
    matched_gt = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    reg_targets = box_ops.encode_boxes(matched_gt, anchors, REG_WEIGHTS)
    pos = labels > 0
    num_pos = pos.sum()
    per_anchor = sigmoid_focal_loss(cls_logits, labels, gamma, alpha)
    cls_loss = global_mean(torch.where(labels >= 0, per_anchor, 0.0).sum(),
                           (num_pos + b).float(), 1.0)
    reg_loss = global_mean(
        smooth_l1_loss(box_regression, reg_targets, beta=bbox_reg_beta,
                       weights=pos[..., None].float(), reduction="sum"),
        num_pos.float() * regress_norm, 1.0)
    return cls_loss, reg_loss


def retinanet_candidates(level_anchors, level_logits, level_regs,
                         image_sizes, *, pre_nms_thresh=0.05,
                         pre_nms_top_n=1000, min_size=0):
    """Per level, batched over images: the sigmoid scores of every
    (location, class), those above ``pre_nms_thresh`` ranked by a stable
    descending sort (the others at -1), the top ``pre_nms_top_n``
    decoded with REG_WEIGHTS and clipped. ``level_logits`` [B, A*K, H, W]
    and ``level_regs`` [B, A*4, H, W] a level, ``level_anchors``
    [H*W*A, 4], ``image_sizes`` [B, 2] (h, w). Returns the levels'
    candidates concatenated: (boxes [B, N, 4], scores [B, N] (0 where
    invalid), classes [B, N] (1..K), valid [B, N])."""
    boxes, scores, classes, valid = [], [], [], []
    for anchors, logits, regs in zip(level_anchors, level_logits,
                                     level_regs):
        logits, regs = level_rows(logits, regs)
        b, _, k_cls = logits.shape
        flat = torch.sigmoid(logits.float()).reshape(b, -1)
        k = min(pre_nms_top_n, flat.shape[1])
        top, idx = torch.sort(torch.where(flat > pre_nms_thresh, flat, -1.0),
                              dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        loc = idx // k_cls
        lvl_boxes = box_ops.decode_boxes(
            torch.gather(regs.float(), 1, loc[..., None].expand(-1, -1, 4)),
            anchors[loc], REG_WEIGHTS)
        lvl_boxes = box_ops.clip_boxes(lvl_boxes, image_sizes[:, 0, None],
                                       image_sizes[:, 1, None])
        ok = (top > 0) & box_ops.min_size_mask(lvl_boxes, float(min_size))
        boxes.append(lvl_boxes)
        scores.append(torch.where(ok, top, 0.0))
        classes.append(idx % k_cls + 1)
        valid.append(ok)
    return (torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(classes, 1),
            torch.cat(valid, 1))


def retinanet_inference(level_anchors, level_logits, level_regs, image_sizes,
                        *, pre_nms_thresh=0.05, pre_nms_top_n=1000,
                        nms_thresh=0.4, detections_per_img=100, min_size=0,
                        impl: str) -> Detections:
    """``retinanet_candidates``, then one NMS an image over the candidates
    offset by ``class * (largest valid coordinate + 1)`` (per-class NMS in
    one call) at ``nms_thresh``, keeping ``detections_per_img``."""
    boxes, scores, classes, valid = retinanet_candidates(
        level_anchors, level_logits, level_regs, image_sizes,
        pre_nms_thresh=pre_nms_thresh, pre_nms_top_n=pre_nms_top_n,
        min_size=min_size)
    unit = torch.where(valid[..., None], boxes, 0.0).amax(dim=(1, 2)) + 1.0
    offset = classes.float()[..., None] * unit[:, None, None]
    keep_idx, keep_valid = nms_topk(boxes + offset, scores, valid,
                                    nms_thresh, detections_per_img,
                                    impl=impl)
    return Detections(
        boxes=torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep_valid, torch.gather(scores, 1, keep_idx),
                           0.0),
        labels=torch.where(keep_valid, torch.gather(classes, 1, keep_idx),
                           0),
        valid=keep_valid)


class RetinaNet(Detector):
    """The meta-architecture: an FPN P3-P7 backbone and ``RetinaNetHead``.
    ``forward`` returns Detections; ``train_forward`` the two losses, for
    the source batch alone (RetinaNet has no DA heads). ``impl`` picks the
    NMS: "cuda" (the kernel) or "plain"; a call that names none takes the
    model's ``impl`` when set, else the model's device's."""

    # no DA heads and no mask head (``parallel.unused_parameters`` asks)
    da_heads = None
    mask_head = None

    def __init__(self, backbone: nn.Module, head: RetinaNetHead, *,
                 anchor_generator: AnchorGenerator, loss_cfg: dict,
                 infer_cfg: dict,
                 pixel_mean=(102.9801, 115.9465, 122.7717),
                 pixel_std=(1.0, 1.0, 1.0), to_bgr255: bool = True):
        super().__init__(anchor_generator, pixel_mean, pixel_std, to_bgr255)
        self.backbone = backbone
        self.rpn = nn.ModuleDict({"head": head})
        self.loss_cfg = loss_cfg
        self.infer_cfg = infer_cfg

    def _forward(self, batch: ImageBatch, impl: str):
        feats = self.backbone(self.images(batch), impl=impl)
        logits, regs = self.rpn["head"](feats)
        return logits, regs, self.anchors(feats)

    @torch.no_grad()
    def forward(self, batch: ImageBatch, impl: Optional[str] = None,
                with_masks: bool = False,
                with_keypoints: bool = False) -> Detections:
        if with_masks or with_keypoints:
            raise ValueError("with_masks needs a mask head and "
                             "with_keypoints a keypoint head (MODEL.MASK_ON, "
                             "MODEL.KEYPOINT_ON); RetinaNet has neither")
        impl = impl or self.default_impl()
        logits, regs, anchors = self._forward(batch, impl)
        return retinanet_inference(anchors, logits, regs, batch.sizes.float(),
                                   **self.infer_cfg, impl=impl)

    def train_forward(self, batch_s: ImageBatch, targets_s, da_state,
                      *unused_domains, aligned: bool = False,
                      deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      impl: Optional[str] = None):
        """Returns ({"loss_retina_cls", "loss_retina_reg"}, ``da_state``
        unchanged) for the source batch. The target batches, ``aligned``,
        ``deterministic`` and ``generator`` (no sampling, no dropout) are
        taken and not used, so the trainer drives it as it drives the
        two-stage detector."""
        impl = impl or self.default_impl()
        logits, regs, anchors = self._forward(batch_s, impl)
        rows = [level_rows(l, r) for l, r in zip(logits, regs)]
        cls_loss, reg_loss = retinanet_loss(
            torch.cat(anchors), torch.cat([c for c, _ in rows], 1),
            torch.cat([r for _, r in rows], 1), targets_s.boxes,
            targets_s.labels, targets_s.valid, batch_s.sizes.float(),
            **self.loss_cfg)
        return {"loss_retina_cls": cls_loss,
                "loss_retina_reg": reg_loss}, da_state


def init_retinanet(model: RetinaNet, generator: torch.Generator) -> None:
    """Random init from ``generator`` with the JAX package's initializer
    scales: the body's convs lecun-normal (std 1/sqrt(fan_in)), the FPN's
    kaiming-uniform with a=1 (bound sqrt(3/fan_in)), the head's towers and
    output convs normal(0.01); biases 0 but the class logits', the prior
    constant -log((1 - PRIOR_PROB) / PRIOR_PROB); FrozenBN scale 1 and
    bias 0 (set at construction)."""
    with torch.no_grad():
        for m in model.backbone.body.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=generator)
        for m in model.backbone.fpn.children():
            if isinstance(m, nn.Conv2d):
                bound = (3.0 / m.weight[0].numel()) ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
        head = model.rpn["head"]
        for m in head.children():
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.zero_()
        head.cls_logits.bias.fill_(head.prior_bias)


def build_retinanet(cfg, seed: int = 0) -> RetinaNet:
    """The RetinaNet of ``cfg`` on the CPU, random weights from ``seed``."""
    from .backbone import build_backbone

    dtype = compute_dtype(cfg)
    backbone, spec = build_backbone(cfg)
    r = cfg.MODEL.RETINANET
    gen = make_anchor_generator_retinanet(cfg)
    model = RetinaNet(
        backbone,
        RetinaNetHead(spec.out_channels, r.NUM_CLASSES - 1,
                      gen.num_anchors_per_location, r.NUM_CONVS,
                      r.PRIOR_PROB, dtype),
        anchor_generator=gen,
        loss_cfg=dict(fg_iou=r.FG_IOU_THRESHOLD, bg_iou=r.BG_IOU_THRESHOLD,
                      gamma=r.LOSS_GAMMA, alpha=r.LOSS_ALPHA,
                      bbox_reg_beta=r.BBOX_REG_BETA,
                      regress_norm=r.BBOX_REG_WEIGHT,
                      straddle_thresh=r.STRADDLE_THRESH),
        infer_cfg=dict(pre_nms_thresh=r.INFERENCE_TH,
                       pre_nms_top_n=r.PRE_NMS_TOP_N, nms_thresh=r.NMS_TH,
                       detections_per_img=cfg.TEST.DETECTIONS_PER_IMG),
        pixel_mean=cfg.INPUT.PIXEL_MEAN, pixel_std=cfg.INPUT.PIXEL_STD,
        to_bgr255=cfg.INPUT.TO_BGR255)
    init_retinanet(model, torch.Generator().manual_seed(seed))
    return model
