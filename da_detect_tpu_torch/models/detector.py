"""GeneralizedRCNN eval forward (port of ``da_detect_tpu/models/detector.py``).

Backbone -> RPN -> proposal selection -> box head -> detections, for the C4
Faster R-CNN bodies, with and without the domain-adaptation heads (those act
in training only, the next slice). Module names follow maskrcnn-benchmark's
state_dict: ``backbone.body``, ``rpn.head``, ``roi_heads.box.feature_extractor``
and ``roi_heads.box.predictor``.

``impl`` picks the kernels: "cuda" runs NMS and ROIAlign through the
hand-written CUDA kernels' wrappers, "plain" through their plain versions.
The default is resolved from the model's device: "cuda" on the card, "plain"
on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..structures.image_batch import ImageBatch
from .anchors import AnchorGenerator, make_anchor_generator
from .box_head import (Detections, make_box_feature_extractor,
                       make_box_predictor, postprocess_detections)
from .rpn import RPNHead, rpn_config, select_proposals


class GeneralizedRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 feature_extractor: Optional[nn.Module],
                 predictor: Optional[nn.Module], *, rpn_only: bool,
                 anchor_generator: AnchorGenerator, rpn_test: dict,
                 post_cfg: dict, pixel_mean=(102.9801, 115.9465, 122.7717),
                 pixel_std=(1.0, 1.0, 1.0), to_bgr255: bool = True):
        super().__init__()
        self.backbone = backbone
        self.rpn = nn.ModuleDict({"head": rpn_head})
        box = {} if rpn_only else {"feature_extractor": feature_extractor,
                                   "predictor": predictor}
        self.roi_heads = nn.ModuleDict({"box": nn.ModuleDict(box)})
        self.rpn_only = rpn_only
        self.anchor_generator = anchor_generator
        self.rpn_test = rpn_test
        self.post_cfg = post_cfg
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.to_bgr255 = to_bgr255
        self._anchors = {}  # (feature shapes, device) -> anchors per level

    def anchors(self, feats) -> list[torch.Tensor]:
        shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        key = (shapes, feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(a).to(feats[0].device)
                for a in self.anchor_generator.anchors_for_shapes(shapes)]
        return self._anchors[key]

    def default_impl(self) -> str:
        dev = next(self.parameters()).device
        return "cuda" if dev.type == "cuda" else "plain"

    @torch.no_grad()
    def forward(self, batch: ImageBatch,
                impl: Optional[str] = None) -> Detections:
        impl = impl or self.default_impl()
        images = batch.normalized(self.pixel_mean, self.pixel_std,
                                  self.to_bgr255)
        feats = self.backbone(images)
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
        return postprocess_detections(cls_logits, box_deltas, props.boxes,
                                      props.valid, sizes, **self.post_cfg,
                                      impl=impl)


def _check_supported(cfg) -> None:
    m = cfg.MODEL
    if cfg.TPU.COMPUTE_DTYPE != "float32":
        raise NotImplementedError(
            f"TPU.COMPUTE_DTYPE={cfg.TPU.COMPUTE_DTYPE!r}: the PyTorch port "
            "computes in float32 only; bfloat16 compute is the ROADMAP item "
            "'bf16 compute in the port' (Queue 1). Set "
            "TPU.COMPUTE_DTYPE float32.")
    for key in ("RETINANET_ON", "MASK_ON", "KEYPOINT_ON"):
        if m[key]:
            raise NotImplementedError(
                f"MODEL.{key}: that head is a later slice of the port")
    if m.RPN.USE_FPN or m.ROI_HEADS.USE_FPN:
        raise NotImplementedError("FPN models are a later slice of the port")
    if m.RPN.RPN_HEAD != "SingleConvRPNHead":
        raise NotImplementedError(f"RPN_HEAD {m.RPN.RPN_HEAD}: later slice")


def init_parameters(model: GeneralizedRCNN,
                    generator: torch.Generator) -> None:
    """Random init from ``generator``, with the JAX package's initializer
    scales: convs of the body and res5 head lecun-normal (std
    1/sqrt(fan_in)), the RPN head normal(0.01), the predictor's cls_score
    normal(0.01) and bbox_pred normal(0.001), biases 0, FrozenBN scale 1 and
    bias 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d) and m.bias is None:
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        head = model.rpn["head"]
        layers = [(head.conv, 0.01), (head.cls_logits, 0.01),
                  (head.bbox_pred, 0.01)]
        if not model.rpn_only:
            pred = model.roi_heads["box"]["predictor"]
            layers += [(pred.cls_score, 0.01), (pred.bbox_pred, 0.001)]
        for layer, std in layers:
            layer.weight.normal_(0.0, std, generator=generator)
            layer.bias.zero_()


def build_detection_model(cfg, seed: int = 0) -> GeneralizedRCNN:
    """The eval model for ``cfg``, on the CPU, with random weights drawn from
    ``torch.Generator().manual_seed(seed)``. Move it with ``.to(device)``;
    load trained or bridged weights with ``utils.weights``."""
    from .backbone import build_backbone

    _check_supported(cfg)
    backbone, spec = build_backbone(cfg)
    if cfg.MODEL.RPN_ONLY:
        extractor, predictor = None, None
    else:
        extractor, ext_ch = make_box_feature_extractor(cfg)
        predictor = make_box_predictor(cfg, ext_ch)
    gen = make_anchor_generator(cfg)
    roi = cfg.MODEL.ROI_HEADS
    model = GeneralizedRCNN(
        backbone,
        RPNHead(spec.out_channels, gen.num_anchors_per_location),
        extractor, predictor,
        rpn_only=cfg.MODEL.RPN_ONLY,
        anchor_generator=gen,
        rpn_test=rpn_config(cfg, False),
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
