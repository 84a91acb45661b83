"""GeneralizedRCNN: the eval forward and the training forward (port of
``da_detect_tpu/models/detector.py``), for the C4, FPN and FBNet Faster and
Mask R-CNN bodies and Keypoint R-CNN, with deformable stages
(X-101-32x8d-FPN-DCN) or without, with and without the domain-adaptation
heads. ``build_detection_model``
builds RetinaNet (``models/retinanet.py``) for ``MODEL.RETINANET_ON``.
Module names follow maskrcnn-benchmark's state_dict: ``backbone.body``,
``rpn.head``, ``roi_heads.box.feature_extractor``,
``roi_heads.box.predictor``, ``roi_heads.mask.feature_extractor``,
``roi_heads.mask.predictor``, ``roi_heads.keypoint.feature_extractor``,
``roi_heads.keypoint.predictor`` and ``da_heads``.

With a mask head (``MODEL.MASK_ON``) the eval forward can run it over the
final detections (``with_masks``), and the training forward adds
``loss_mask`` from the source batch's sampled ROIs (0, without running the
head, when the batch carries no GT masks: the DA loaders' batches).
With a keypoint head (``MODEL.KEYPOINT_ON``) the eval forward can run it over
the final detections (``with_keypoints``), and the training forward adds
``loss_kp`` when the source batch carries GT keypoints (the DA loaders'
batches do not, and their losses have no ``loss_kp``).

``train_forward`` takes the domains as separate batches of k images each:
source only, + positive target (classic 2-domain DA), + negative target (the
triplet). Detection losses and RPN supervision come from the source batch;
the target's RPN runs only to select proposals, and the negative batch runs
only the backbone. The DA instance features reuse the detection pass's
pooled features, as the JAX package does.

``impl`` picks the kernels: "cuda" runs NMS, ROIAlign (forward and
backward) and the deformable convolutions' row gathers through the
hand-written CUDA kernels' wrappers (the gathers' backward through the
scatter-add kernel), "plain" through their plain versions. A call that
names none takes the model's ``impl`` when it is set, else the model's
device's: "cuda" on the card, "plain" on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers import DeformConv2d, compute_dtype
from ..structures.image_batch import ImageBatch
from .anchors import AnchorGenerator, make_anchor_generator
from .backbone.fbnet import FBNetRPNHead, make_fbnet_rpn_head
from .backbone.vgg import VGG16
from .box_head import (Detections, FPN2MLPFeatureExtractor,
                       FPNXconv1fcFeatureExtractor, fast_rcnn_loss,
                       make_box_feature_extractor,
                       make_box_predictor, postprocess_detections,
                       subsample_proposals)
from .da import DAState, make_da_heads
from .keypoint_head import (KeypointHead, heatmaps_to_keypoints,
                            keypoint_layers, keypoint_rcnn_loss,
                            make_keypoint_head)
from .mask_head import MaskHead, make_mask_head, mask_layers, mask_rcnn_loss
from .rpn import (RPNHead, append_gt_proposals, level_rows, rpn_config,
                  rpn_loss, select_proposals)


def _interleave(a_s: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    """[k, ...] source and target rows -> [2k, ...] as (s0, t0, s1, t1, ...),
    the JAX package's row order for the DA heads."""
    return torch.stack([a_s, a_t], dim=1).reshape((2 * a_s.shape[0],)
                                                  + a_s.shape[1:])


class Detector(nn.Module):
    """What the two meta-architectures (``GeneralizedRCNN``, and
    ``retinanet.RetinaNet``) share: the input normalization, the anchors of
    each feature shape (cached a device) and the kernels' route."""

    def __init__(self, anchor_generator: AnchorGenerator, pixel_mean,
                 pixel_std, to_bgr255: bool):
        super().__init__()
        self.anchor_generator = anchor_generator
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.to_bgr255 = to_bgr255
        self._anchors = {}  # (feature shapes, device) -> anchors per level
        self.impl: Optional[str] = None  # None: by the parameters' device

    def images(self, batch: ImageBatch) -> torch.Tensor:
        return batch.normalized(self.pixel_mean, self.pixel_std,
                                self.to_bgr255)

    def anchors(self, feats) -> list[torch.Tensor]:
        shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        key = (shapes, feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(a).to(feats[0].device)
                for a in self.anchor_generator.anchors_for_shapes(shapes)]
        return self._anchors[key]

    def default_impl(self) -> str:
        if self.impl is not None:
            return self.impl
        dev = next(self.parameters()).device
        return "cuda" if dev.type == "cuda" else "plain"


class GeneralizedRCNN(Detector):
    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 feature_extractor: Optional[nn.Module],
                 predictor: Optional[nn.Module], *, rpn_only: bool,
                 anchor_generator: AnchorGenerator, rpn_test: dict,
                 post_cfg: dict, da_heads: Optional[nn.Module] = None,
                 rpn_train: Optional[dict] = None,
                 rpn_loss_cfg: Optional[dict] = None,
                 sample_cfg: Optional[dict] = None,
                 share_positive_pool: bool = False,
                 mask_head: Optional[MaskHead] = None,
                 keypoint_head: Optional[KeypointHead] = None,
                 pixel_mean=(102.9801, 115.9465, 122.7717),
                 pixel_std=(1.0, 1.0, 1.0), to_bgr255: bool = True):
        super().__init__(anchor_generator, pixel_mean, pixel_std, to_bgr255)
        self.backbone = backbone
        self.rpn = nn.ModuleDict({"head": rpn_head})
        box = {} if rpn_only else {"feature_extractor": feature_extractor,
                                   "predictor": predictor}
        self.roi_heads = nn.ModuleDict({"box": nn.ModuleDict(box)})
        if mask_head is not None:
            self.roi_heads["mask"] = mask_head
        if keypoint_head is not None:
            self.roi_heads["keypoint"] = keypoint_head
        self.da_heads = da_heads
        self.rpn_only = rpn_only
        self.rpn_test = rpn_test
        self.rpn_train = rpn_train
        self.rpn_loss_cfg = rpn_loss_cfg
        self.sample_cfg = sample_cfg
        self.share_positive_pool = share_positive_pool
        self.post_cfg = post_cfg

    @property
    def mask_head(self) -> Optional[MaskHead]:
        return self.roi_heads["mask"] if "mask" in self.roi_heads else None

    @property
    def keypoint_head(self) -> Optional[KeypointHead]:
        return self.roi_heads["keypoint"] if "keypoint" in self.roi_heads \
            else None

    @torch.no_grad()
    def forward(self, batch: ImageBatch, impl: Optional[str] = None,
                with_masks: bool = False, with_keypoints: bool = False):
        """Detections; with ``with_masks`` (a model with a mask head, else
        ValueError), (detections, mask probabilities [B, D, Hm, Wm]
        float32): the head run over the final detections (every slot, the
        invalid ones too), each slot's class channel taken, cast to float32,
        then the sigmoid; with ``with_keypoints`` (a model with a keypoint
        head, else ValueError) and not ``with_masks``, (detections,
        keypoints [B, D, K, 3] float32 (x, y, score)): the keypoint head
        over the final detections, decoded by ``heatmaps_to_keypoints``."""
        if with_masks and self.mask_head is None:
            raise ValueError("with_masks needs a mask head (MODEL.MASK_ON)")
        if with_keypoints and self.keypoint_head is None:
            raise ValueError("with_keypoints needs a keypoint head "
                             "(MODEL.KEYPOINT_ON)")
        impl = impl or self.default_impl()
        feats = self.backbone(self.images(batch), impl=impl)
        logits, deltas = self.rpn["head"](feats)
        sizes = batch.sizes.float()
        props = select_proposals(self.anchors(feats), logits, deltas, sizes,
                                 **self.rpn_test, impl=impl)
        if self.rpn_only:
            # proposals-as-detections (reference RPN_ONLY eval path)
            return Detections(boxes=props.boxes, scores=props.scores,
                              labels=props.valid.long(), valid=props.valid)
        box = self.roi_heads["box"]
        x = box["feature_extractor"](feats, props.boxes, impl=impl)
        cls_logits, box_deltas = box["predictor"](x)
        dets = postprocess_detections(cls_logits, box_deltas, props.boxes,
                                      props.valid, sizes, **self.post_cfg,
                                      impl=impl)
        if with_masks:
            return dets, self.mask_probs(feats, dets, impl)
        if with_keypoints:
            return dets, self.keypoints(feats, dets, impl)
        return dets

    def keypoints(self, feats, dets: Detections, impl: str) -> torch.Tensor:
        """The keypoint head over ``dets`` (a second pass over the final
        detections, every slot): [B, D, K, 3] float32 (x, y, score) in the
        canvas's frame."""
        logits = self.keypoint_head(feats, dets.boxes, impl=impl)
        b, d = logits.shape[:2]
        return heatmaps_to_keypoints(
            logits.float().reshape((b * d,) + logits.shape[2:]),
            dets.boxes.reshape(b * d, 4)).reshape(b, d, -1, 3)

    def mask_probs(self, feats, dets: Detections, impl: str) -> torch.Tensor:
        """The mask head over ``dets`` (a second pass over the final
        detections, as the reference's mask head runs on the box head's
        results): [B, D, Hm, Wm] float32 sigmoid probabilities of each
        detection's class channel."""
        mask = self.mask_head
        shared = (self.roi_heads["box"]["feature_extractor"](
            feats, dets.boxes, impl=impl)
            if mask.feature_extractor is None else None)
        logits = mask(feats, dets.boxes, shared, impl=impl)  # [B,D,K,H,W]
        cls = dets.labels.clamp(min=0)[:, :, None, None, None].expand(
            -1, -1, 1, *logits.shape[3:])
        return torch.sigmoid(torch.gather(logits, 2, cls)[:, :, 0].float())

    # -- training ----------------------------------------------------------
    def _rpn_and_proposals(self, batch, targets, *, append_gt: bool,
                           with_rpn_loss: bool, impl: str):
        """Backbone, RPN head and proposal selection of one domain's batch.
        Selection runs on detached logits and deltas; a batch that takes no
        RPN loss runs its RPN head without autograd."""
        feats = self.backbone(self.images(batch), impl=impl)
        with torch.set_grad_enabled(with_rpn_loss
                                    and torch.is_grad_enabled()):
            logits, deltas = self.rpn["head"](feats)
        props = select_proposals(
            self.anchors(feats), [l.detach() for l in logits],
            [d.detach() for d in deltas], batch.sizes.float(),
            **self.rpn_train, impl=impl)
        if append_gt:
            props = append_gt_proposals(props, targets.boxes, targets.valid,
                                        batch.is_source)
        return feats, logits, deltas, props

    def _subsample_and_extract(self, feats, props, targets, is_source,
                               generator, impl):
        sampled = subsample_proposals(
            props.boxes, props.valid, targets.boxes, targets.labels,
            targets.valid, is_source, **self.sample_cfg, generator=generator)
        x = self.roi_heads["box"]["feature_extractor"](feats, sampled.rois,
                                                       impl=impl)
        return sampled, x

    def train_forward(self, batch_s: ImageBatch, targets_s: Targets,
                      da_state: DAState, batch_t: Optional[ImageBatch] = None,
                      targets_t: Optional[Targets] = None,
                      batch_n: Optional[ImageBatch] = None,
                      targets_n: Optional[Targets] = None, *,
                      aligned: bool = False, deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      impl: Optional[str] = None):
        """Returns (losses dict of 0-d tensors, new DAState).

        Only ``batch_s``: source-only training; + ``batch_t``: 2-domain DA;
        + ``batch_n``: the triplet. With ``aligned`` the triplet's instance
        member re-pools the positive batch's proposals from each domain's
        features. ``generator`` draws the sampling priorities and the DA
        dropout (on the model's device); ``deterministic`` turns dropout off.
        """
        impl = impl or self.default_impl()
        b = batch_s.images.shape[0]
        dev = batch_s.images.device
        ones = torch.ones(b, dtype=torch.bool, device=dev)
        zeros = torch.zeros(b, dtype=torch.bool, device=dev)

        feats_s, logits_s, deltas_s, props_s = self._rpn_and_proposals(
            batch_s, targets_s, append_gt=True, with_rpn_loss=True, impl=impl)
        # RPN supervision comes from the source batch alone: every level's
        # anchors, logits and deltas in (h, w, a) order, levels in order
        obj, dl = (torch.cat(rows, dim=1) for rows in zip(
            *map(level_rows, logits_s, deltas_s)))
        loss_obj, loss_rpn_box = rpn_loss(
            torch.cat(self.anchors(feats_s)), obj, dl, targets_s.boxes,
            targets_s.valid, ones, batch_s.sizes.float(),
            **self.rpn_loss_cfg, generator=generator)
        if self.rpn_only:
            return {"loss_objectness": loss_obj,
                    "loss_rpn_box_reg": loss_rpn_box}, da_state

        box = self.roi_heads["box"]
        sampled_s, x_s = self._subsample_and_extract(
            feats_s, props_s, targets_s, ones, generator, impl)
        cls_logits, box_deltas = box["predictor"](x_s)
        loss_cls, loss_box = fast_rcnn_loss(
            cls_logits, box_deltas, sampled_s,
            cls_agnostic=self.post_cfg["cls_agnostic"])
        losses = {"loss_objectness": loss_obj,
                  "loss_rpn_box_reg": loss_rpn_box,
                  "loss_classifier": loss_cls,
                  "loss_box_reg": loss_box}
        if self.mask_head is not None:
            losses["loss_mask"] = mask_rcnn_loss(
                self.mask_head, feats_s, sampled_s, targets_s,
                shared_box_features=x_s, impl=impl)
        if self.keypoint_head is not None and targets_s.keypoints is not None:
            losses["loss_kp"] = keypoint_rcnn_loss(
                self.keypoint_head, feats_s, sampled_s, targets_s.keypoints,
                targets_s, impl=impl)
        if self.da_heads is None or batch_t is None:
            return losses, da_state

        feats_t, _, _, props_t = self._rpn_and_proposals(
            batch_t, targets_t, append_gt=False, with_rpn_loss=False,
            impl=impl)
        sampled_t, x_t = self._subsample_and_extract(
            feats_t, props_t, targets_t, zeros, generator, impl)
        img_fea_set = da_ins_set = None
        if batch_n is not None:
            feats_n = self.backbone(self.images(batch_n), impl=impl)
            img_fea_set = (feats_s[0], feats_t[0], feats_n[0])
            if aligned and self.da_heads.triplet_ins_weight > 0:
                # the positive batch's proposals pooled from each domain's
                # features, an independent subsample each; with
                # share_positive_pool the positive member reuses x_t
                da_ins_set = []
                for fd, tg, src, is_pos in ((feats_s, targets_s, ones, False),
                                            (feats_t, targets_t, zeros, True),
                                            (feats_n, targets_n, zeros,
                                             False)):
                    if self.share_positive_pool and is_pos:
                        da_ins_set.append(x_t)
                        continue
                    _, x = self._subsample_and_extract(
                        fd, props_t, tg, src, generator, impl)
                    da_ins_set.append(x)
        da_losses, new_state = self.da_heads(
            [_interleave(fs, ft) for fs, ft in zip(feats_s, feats_t)],
            _interleave(x_s, x_t),
            _interleave(sampled_s.valid, torch.zeros_like(sampled_t.valid)),
            _interleave(sampled_s.valid, sampled_t.valid),
            da_ins_set, img_fea_set, _interleave(ones, zeros), da_state,
            deterministic=deterministic, generator=generator)
        losses.update(da_losses)
        return losses, new_state


def _check_supported(cfg) -> None:
    m = cfg.MODEL
    if cfg.TPU.COMPUTE_DTYPE not in ("bfloat16", "float32"):
        raise NotImplementedError(
            f"TPU.COMPUTE_DTYPE={cfg.TPU.COMPUTE_DTYPE!r}: the PyTorch port "
            "computes in bfloat16 or float32, as the JAX package does")
    if m.RPN.RPN_HEAD not in ("SingleConvRPNHead", "FBNet.rpn_head"):
        raise KeyError(f"unknown RPN_HEAD: {m.RPN.RPN_HEAD}")


def init_parameters(model: GeneralizedRCNN,
                    generator: torch.Generator) -> None:
    """Random init from ``generator``, with the JAX package's initializer
    scales: convs of the body and res5 head lecun-normal (std
    1/sqrt(fan_in)), the VGG-16 body's too with their biases 0, the RPN
    head normal(0.01), the predictor's cls_score
    normal(0.01) and bbox_pred normal(0.001), the DA heads' convs
    normal(0.001) and fc1/fc2/fc3 normal(0.01/0.01/0.05), biases 0, FrozenBN
    scale 1 and bias 0; the mask head's convs (``mask_fcn*``,
    ``conv5_mask``, ``mask_fcn_logits``) and the keypoint head's
    (``conv_fcn*``, ``kps_score_lowres``) kaiming normal over Flax's
    fan-out (std sqrt(2 / (out channels x kernel area)); a transposed
    conv's out channels are its weight's second axis), biases 0; deformable
    convs he-normal (std sqrt(2/fan_in)) with their offset predictors
    zero; the FPN convs and the MLP head's fc6/fc7
    kaiming-uniform with a=1 (bound sqrt(3/fan_in)), biases 0; the conv
    head's convs normal(0.01) and its fc6 kaiming-uniform; GroupNorm scale 1
    and bias 0 (set at construction)."""
    vgg = set(model.backbone.modules()) \
        if isinstance(model.backbone, VGG16) else set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d) and (m.bias is None or m in vgg):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, DeformConv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                                 generator=generator)
                m.conv_offset.weight.zero_()
                m.conv_offset.bias.zero_()
        uniform = []
        if getattr(model.backbone, "fpn", None) is not None:
            uniform += [m for m in model.backbone.fpn.children()
                        if isinstance(m, nn.Conv2d)]
        ext = None if model.rpn_only \
            else model.roi_heads["box"]["feature_extractor"]
        if isinstance(ext, FPN2MLPFeatureExtractor):
            uniform += [ext.fc6, ext.fc7]
        if isinstance(ext, FPNXconv1fcFeatureExtractor):
            uniform.append(ext.fc6)
        for layer in uniform:
            bound = (3.0 / layer.weight[0].numel()) ** 0.5
            layer.weight.uniform_(-bound, bound, generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()
        head = model.rpn["head"]
        if isinstance(head, FBNetRPNHead):
            layers = [(c, c.weight[0].numel() ** -0.5)
                      for c in (head.cls_logits, head.bbox_pred)]
        else:
            layers = [(head.conv, 0.01), (head.cls_logits, 0.01),
                      (head.bbox_pred, 0.01)]
        if isinstance(ext, FPNXconv1fcFeatureExtractor):
            layers += [(getattr(ext, f"xconvs{i}"), 0.01)
                       for i in range(ext.num_stacked_convs)]
        if not model.rpn_only:
            pred = model.roi_heads["box"]["predictor"]
            layers += [(pred.cls_score, 0.01), (pred.bbox_pred, 0.001)]
        if model.da_heads is not None:
            img, ins = model.da_heads.imghead, model.da_heads.inshead
            layers += [(img.conv1_da, 0.001), (img.conv2_da, 0.001),
                       (ins.fc1_da, 0.01), (ins.fc2_da, 0.01),
                       (ins.fc3_da, 0.05)]
        kaiming = []
        if model.mask_head is not None:
            kaiming += mask_layers(model.mask_head)
        if model.keypoint_head is not None:
            kaiming += keypoint_layers(model.keypoint_head)
        for conv in kaiming:
            w = conv.weight
            out_ch = w.shape[1] if isinstance(conv, nn.ConvTranspose2d) \
                else w.shape[0]
            layers.append((conv, (2.0 / (out_ch * w[0, 0].numel())) ** 0.5))
        for layer, std in layers:
            layer.weight.normal_(0.0, std, generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()


def build_detection_model(cfg, seed: int = 0) -> GeneralizedRCNN:
    """The model for ``cfg`` (with DA heads when
    ``MODEL.DOMAIN_ADAPTATION_ON``), on the CPU, with random weights drawn
    from ``torch.Generator().manual_seed(seed)``. Move it with ``.to(device)``;
    load trained or bridged weights with ``utils.weights``. With
    ``MODEL.RETINANET_ON``, the RetinaNet (no DA heads: with
    ``DOMAIN_ADAPTATION_ON`` too it raises ``ValueError``, as the JAX
    package does)."""
    from .backbone import build_backbone

    _check_supported(cfg)
    if cfg.MODEL.RETINANET_ON:
        if cfg.MODEL.DOMAIN_ADAPTATION_ON:
            raise ValueError(
                "MODEL.RETINANET_ON and MODEL.DOMAIN_ADAPTATION_ON are "
                "mutually exclusive: the RetinaNet meta-architecture has no "
                "domain-adaptation heads (same as the reference)")
        from .retinanet import build_retinanet
        return build_retinanet(cfg, seed)
    dtype = compute_dtype(cfg)
    backbone, spec = build_backbone(cfg)
    da_heads = None
    ext_ch = None
    if cfg.MODEL.RPN_ONLY:
        extractor, predictor = None, None
    else:
        extractor, ext_ch = make_box_feature_extractor(
            cfg, spec.out_channels, dtype)
        predictor = make_box_predictor(cfg, ext_ch, dtype)
        if cfg.MODEL.DOMAIN_ADAPTATION_ON:
            da_heads = make_da_heads(cfg, spec.out_channels, ext_ch, dtype)
    mask = (make_mask_head(cfg, spec.out_channels, ext_ch, dtype)
            if cfg.MODEL.MASK_ON else None)
    keypoint = (make_keypoint_head(cfg, spec.out_channels, dtype)
                if cfg.MODEL.KEYPOINT_ON else None)
    gen = make_anchor_generator(cfg)
    rpn = cfg.MODEL.RPN
    roi = cfg.MODEL.ROI_HEADS
    rpn_head = (make_fbnet_rpn_head(cfg, spec.out_channels,
                                    gen.num_anchors_per_location, dtype)
                if rpn.RPN_HEAD == "FBNet.rpn_head"
                else RPNHead(spec.out_channels, gen.num_anchors_per_location,
                             dtype))
    model = GeneralizedRCNN(
        backbone, rpn_head,
        extractor, predictor,
        rpn_only=cfg.MODEL.RPN_ONLY,
        anchor_generator=gen,
        rpn_test=rpn_config(cfg, False),
        rpn_train=rpn_config(cfg, True),
        rpn_loss_cfg=dict(
            fg_iou=rpn.FG_IOU_THRESHOLD, bg_iou=rpn.BG_IOU_THRESHOLD,
            batch_per_image=rpn.BATCH_SIZE_PER_IMAGE,
            positive_fraction=rpn.POSITIVE_FRACTION,
            straddle_thresh=rpn.STRADDLE_THRESH),
        sample_cfg=dict(
            fg_iou=roi.FG_IOU_THRESHOLD, bg_iou=roi.BG_IOU_THRESHOLD,
            batch_per_image=roi.BATCH_SIZE_PER_IMAGE,
            positive_fraction=roi.POSITIVE_FRACTION,
            reg_weights=tuple(roi.BBOX_REG_WEIGHTS)),
        da_heads=da_heads,
        share_positive_pool=cfg.TPU.SHARE_POSITIVE_POOL,
        mask_head=mask,
        keypoint_head=keypoint,
        post_cfg=dict(
            score_thresh=roi.SCORE_THRESH, nms_thresh=roi.NMS,
            detections_per_img=roi.DETECTIONS_PER_IMG,
            reg_weights=tuple(roi.BBOX_REG_WEIGHTS),
            cls_agnostic=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG),
        pixel_mean=cfg.INPUT.PIXEL_MEAN,
        pixel_std=cfg.INPUT.PIXEL_STD,
        to_bgr255=cfg.INPUT.TO_BGR255,
    )
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model
