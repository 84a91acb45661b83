"""Domain-adaptation heads and losses (port of ``da_detect_tpu/models/da.py``).

* ``DAImgHead``: per-pixel domain classifier, 1x1 conv to 512, ReLU, 1x1 conv
  to 1 (``conv1_da``, ``conv2_da``; init normal(0.001)).
* ``DAInsHead``: instance MLP 1024-1024-1 with dropout 0.5 (``fc1_da``,
  ``fc2_da``, ``fc3_da``). Dropout draws from an explicit generator; it is
  off with ``deterministic=True``.
* AdvGRL: when the detached probe loss is at or below BCE([0.7, 0.3], [1, 0])
  the GRL weight becomes ``-w_adv * min(threshold, 1 / loss)``, chosen on the
  device with ``torch.where`` (never read on the host).
* The domain-level triplet losses. The image margin adapts: it grows by
  ``lr`` whenever the previous step's image triplet loss was exactly 0 and
  ``floor(margin) != floor(max_margin)``. Margins and last losses are the
  explicit ``DAState`` a train step threads through.
* The consistency loss: L1 between each instance's domain probability and
  its own image's mean image-level probability.
* In a process group (``parallel/ddp.py``) each loss is this rank's share
  of the global batch's, and the AdvGRL probe losses and the last triplet
  losses are the global ones, so every rank takes the same GRL weights and
  keeps the same ``DAState``.

The heads compute in ``dtype`` (``TPU.COMPUTE_DTYPE``); every loss, the
triplet distances and the consistency probabilities in float32.

Layouts: image features are logical NCHW, instance features [B, S, C, 7, 7]
(the C4 extractor's output); the JAX package's NHWC axes map onto these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, Linear
from ..ops.grl import gradient_scalar
from ..ops.losses import bce_with_logits, triplet_margin_loss
from ..parallel.ddp import global_average, global_mean

# BCE([0.7, 0.3], [1, 0]), the AdvGRL activation threshold
ADVGRL_BCE_THRESHOLD = 0.62877065
# the Adv_GRL_Optimized band: BCE([0.6, 0.4], [1, 0]) and
# BCE([0.55, 0.45], [1, 0])
ADVGRL_BCE_MIN = 0.6752516
ADVGRL_BCE_MAX = 0.69937071


@dataclasses.dataclass
class DAState:
    """Cross-step state of the adaptive triplet margins: four 0-d float32
    tensors on the model's device, never read on the host by a step."""

    margin_img: torch.Tensor
    margin_ins: torch.Tensor
    last_triplet_img: torch.Tensor
    last_triplet_ins: torch.Tensor

    @classmethod
    def create(cls, margin_img: float = 1.0, margin_ins: float = 1.0,
               device="cpu") -> "DAState":
        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=device)
        return cls(scalar(margin_img), scalar(margin_ins), scalar(1.0),
                   scalar(1.0))

    def replace(self, **kw) -> "DAState":
        return dataclasses.replace(self, **kw)


class DAImgHead(nn.Module):
    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1_da = Conv2d(in_channels, 512, 1, compute_dtype=dtype)
        self.conv2_da = Conv2d(512, 1, 1, compute_dtype=dtype)

    def forward(self, features: list[torch.Tensor]) -> list[torch.Tensor]:
        return [self.conv2_da(F.relu(self.conv1_da(f))) for f in features]


def _dropout(x: torch.Tensor, deterministic: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout 0.5 (keep with probability 0.5, scale kept values by 2)."""
    if deterministic:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 0.5
    return torch.where(keep, x / 0.5, 0.0)


class DAInsHead(nn.Module):
    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1_da = Linear(in_channels, 1024, compute_dtype=dtype)
        self.fc2_da = Linear(1024, 1024, compute_dtype=dtype)
        self.fc3_da = Linear(1024, 1, compute_dtype=dtype)

    def forward(self, x, deterministic: bool = False, generator=None):
        x = _dropout(F.relu(self.fc1_da(x)), deterministic, generator)
        x = _dropout(F.relu(self.fc2_da(x)), deterministic, generator)
        return self.fc3_da(x)


def da_img_loss(da_img_logits: list[torch.Tensor],
                is_source: torch.Tensor) -> torch.Tensor:
    """BCE over every pixel of every level; the label is the image's
    domain. Every rank's batch has the same pixel count, so the local mean
    is the rank's share of the global one."""
    total, count = 0.0, 0
    for lvl in da_img_logits:
        lv = lvl.float().reshape(lvl.shape[0], -1)
        lab = is_source[:, None].float().expand_as(lv)
        total = total + bce_with_logits(lv, lab, reduction="sum")
        count += lv.numel()
    return total / count


def da_ins_loss(da_ins_logits, domain_mask, valid) -> torch.Tensor:
    """BCE over the sampled instances of both domains, weighted by
    validity, over the global batch."""
    w = valid.float().reshape(-1)
    return global_mean(
        bce_with_logits(da_ins_logits.float().reshape(-1),
                        domain_mask.float().reshape(-1), weights=w,
                        reduction="none").sum(), w.sum(), 1e-10)


def consistency_loss(da_img_probs: list[torch.Tensor], da_ins_probs,
                     valid) -> torch.Tensor:
    """L1 between each instance's probability and its image's mean
    image-level probability, over the valid instances of the global
    batch."""
    b, s = valid.shape
    ins = da_ins_probs.float().reshape(b, s)
    w = valid.float()
    total, count = 0.0, 0.0
    for lvl in da_img_probs:
        img_mean = lvl.float().reshape(b, -1).mean(dim=1)
        total = total + ((img_mean[:, None] - ins).abs() * w).sum()
        count = count + w.sum()
    return global_mean(total, count, 1.0)


def _boosted(probe_loss, adv_weight, threshold):
    return -adv_weight * (1.0 / probe_loss.clamp(min=1e-8)).clamp(
        max=threshold)


def adv_grl_weight(probe_loss, base_weight, adv_weight, threshold):
    """-w for plain GRL; -w_adv * min(threshold, 1 / loss) when the probe
    loss is low (the domain classifier winning). A 0-d tensor."""
    return torch.where(probe_loss <= ADVGRL_BCE_THRESHOLD,
                       _boosted(probe_loss, adv_weight, threshold),
                       -base_weight)


def adv_grl_weight_optimized(probe_loss, base_weight, adv_weight, threshold):
    """Banded variant: boost below bce_min, damp to -0.1 * adv_weight above
    bce_max, plain GRL in between."""
    return torch.where(probe_loss <= ADVGRL_BCE_MIN,
                       _boosted(probe_loss, adv_weight, threshold),
                       torch.where(probe_loss >= ADVGRL_BCE_MAX,
                                   -adv_weight * 0.1, -base_weight))


def _updated_margin(margin, last_loss, lr, max_margin):
    grow = (last_loss == 0.0) & (torch.floor(margin) != math.floor(max_margin))
    return margin + torch.where(grow, lr, 0.0)


class DomainAdaptationModule(nn.Module):
    """Triplet-capable DA module; with the triplet weights at 0 it is the
    classic 2-domain module."""

    def __init__(self, img_channels: int, ins_channels: int, *,
                 img_weight=1.0, ins_weight=1.0, cst_weight=0.1,
                 triplet_img_weight=1.0, triplet_ins_weight=1.0,
                 img_grl_weight=0.1, ins_grl_weight=0.1,
                 img_adv_grl_weight=0.1, ins_adv_grl_weight=0.1,
                 use_adv_grl=True, adv_grl_optimized=False,
                 adv_grl_threshold=30.0, triplet_margin_ins=1.0,
                 triplet_max_margin=1.0, triplet_margin_lr=0.001,
                 avgpool_ins=True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.imghead = DAImgHead(img_channels, dtype)
        self.inshead = DAInsHead(ins_channels, dtype)
        self.img_weight = img_weight
        self.ins_weight = ins_weight
        self.cst_weight = cst_weight
        self.triplet_img_weight = triplet_img_weight
        self.triplet_ins_weight = triplet_ins_weight
        self.img_grl_weight = img_grl_weight
        self.ins_grl_weight = ins_grl_weight
        self.img_adv_grl_weight = img_adv_grl_weight
        self.ins_adv_grl_weight = ins_adv_grl_weight
        self.use_adv_grl = use_adv_grl
        self.adv_grl_optimized = adv_grl_optimized
        self.adv_grl_threshold = adv_grl_threshold
        self.triplet_margin_ins = triplet_margin_ins
        self.triplet_max_margin = triplet_max_margin
        self.triplet_margin_lr = triplet_margin_lr
        self.avgpool_ins = avgpool_ins

    def _flatten_ins(self, x):
        # [B, S, C, 7, 7] -> [B, S, C]: the JAX package means NHWC's (H, W)
        if self.avgpool_ins and x.dim() > 3:
            x = x.mean(dim=(-2, -1))
        return x.reshape(x.shape[0], x.shape[1], -1)

    def _grl_weight(self, probe_loss, base, adv):
        if not self.use_adv_grl:
            return -base
        fn = (adv_grl_weight_optimized if self.adv_grl_optimized
              else adv_grl_weight)
        return fn(probe_loss, base, adv, self.adv_grl_threshold)

    def forward(self, img_features, da_ins_feature, domain_mask, ins_valid,
                da_ins_feas_set, img_fea_set, is_source, da_state: DAState,
                deterministic: bool = False, generator=None):
        """Returns (losses dict, new DAState). ``img_features``: per-level
        [2k, C, H, W] and ``da_ins_feature`` [2k, S, C, 7, 7], both with the
        domains interleaved (s0, t0, s1, t1, ...); ``img_fea_set``: the
        (source, positive, negative) level-0 maps for the image triplet;
        ``da_ins_feas_set``: the aligned instance triple or None."""
        losses = {}
        new_state = da_state
        ins_kw = dict(deterministic=deterministic, generator=generator)

        if self.triplet_ins_weight > 0 and da_ins_feas_set is not None:
            # the instance margin stays at its configured value
            fs, fp, fn = [self._flatten_ins(f.float())
                          for f in da_ins_feas_set]
            loss_ti = triplet_margin_loss(fs, fp, fn, self.triplet_margin_ins)
            losses["triplet_loss_instance"] = (self.triplet_ins_weight
                                               * loss_ti)
            new_state = new_state.replace(
                last_triplet_ins=global_average(loss_ti.detach()))

        if self.triplet_img_weight > 0 and img_fea_set is not None:
            margin = _updated_margin(da_state.margin_img,
                                     da_state.last_triplet_img,
                                     self.triplet_margin_lr,
                                     self.triplet_max_margin)
            fs, fp, fn = [f.float() for f in img_fea_set]
            # reduces W, the last axis of NCHW (the JAX package: NHWC axis 2)
            loss_tim = triplet_margin_loss(fs, fp, fn, margin, dim=-1)
            losses["triplet_loss_image"] = self.triplet_img_weight * loss_tim
            # the global loss, so that every rank moves its margin alike
            new_state = new_state.replace(
                margin_img=margin.detach(),
                last_triplet_img=global_average(loss_tim.detach()))

        if self.img_weight > 0:
            with torch.no_grad():  # the detached probe pass for AdvGRL
                probe_loss = global_average(da_img_loss(
                    self.imghead([f.detach() for f in img_features]),
                    is_source))
            w = self._grl_weight(probe_loss, self.img_grl_weight,
                                 self.img_adv_grl_weight)
            loss_img = da_img_loss(
                self.imghead([gradient_scalar(f, w) for f in img_features]),
                is_source)
            losses["loss_da_image"] = self.img_weight * loss_img

        if self.ins_weight > 0:
            ins_flat = self._flatten_ins(da_ins_feature)
            with torch.no_grad():
                probe_loss = global_average(da_ins_loss(
                    self.inshead(ins_flat.detach(), **ins_kw), domain_mask,
                    ins_valid))
            w = self._grl_weight(probe_loss, self.ins_grl_weight,
                                 self.ins_adv_grl_weight)
            ins_logits = self.inshead(gradient_scalar(ins_flat, w), **ins_kw)
            losses["loss_da_instance"] = self.ins_weight * da_ins_loss(
                ins_logits, domain_mask, ins_valid)

        if self.cst_weight > 0:
            ins_flat = self._flatten_ins(da_ins_feature)
            img_c = self.imghead([gradient_scalar(f, self.img_grl_weight)
                                  for f in img_features])
            ins_c = self.inshead(gradient_scalar(ins_flat,
                                                 self.ins_grl_weight),
                                 **ins_kw)
            img_probs = [torch.sigmoid(f.float()) for f in img_c]
            ins_probs = torch.sigmoid(ins_c.float())
            losses["loss_da_consistency"] = self.cst_weight * consistency_loss(
                img_probs, ins_probs[..., 0], ins_valid)

        return losses, new_state


def make_da_heads(cfg, img_channels: int, ins_channels: int,
                  dtype: torch.dtype = torch.float32
                  ) -> DomainAdaptationModule:
    """The triplet-capable module from ``cfg.MODEL.DA_HEADS``; with
    ``TRIPLET_USE`` off the triplet weights are 0 (the classic module).
    ``DA_ADV_GRL`` is honoured in every mode, as in the JAX package."""
    da = cfg.MODEL.DA_HEADS
    is_resnet = not cfg.MODEL.BACKBONE.CONV_BODY.startswith("V")
    c4 = (cfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR
          == "ResNet50Conv5ROIFeatureExtractor")
    return DomainAdaptationModule(
        img_channels, ins_channels,
        img_weight=da.DA_IMG_LOSS_WEIGHT,
        ins_weight=da.DA_INS_LOSS_WEIGHT,
        cst_weight=da.DA_CST_LOSS_WEIGHT,
        triplet_img_weight=(da.DA_TRIPLET_IMG_WEIGHT if da.TRIPLET_USE
                            else 0.0),
        triplet_ins_weight=(da.DA_TRIPLET_INS_WEIGHT if da.TRIPLET_USE
                            else 0.0),
        img_grl_weight=da.DA_IMG_GRL_WEIGHT,
        ins_grl_weight=da.DA_INS_GRL_WEIGHT,
        img_adv_grl_weight=da.DA_IMG_advGRL_WEIGHT,
        ins_adv_grl_weight=da.DA_INS_advGRL_WEIGHT,
        use_adv_grl=da.DA_ADV_GRL,
        adv_grl_optimized=da.DA_ADV_GRL_OPTIMIZED,
        adv_grl_threshold=float(da.DA_ADV_GRL_THRESHOLD),
        triplet_margin_ins=da.TRIPLET_MARGIN_INS,
        triplet_max_margin=da.TRIPLET_MAX_MARGIN,
        triplet_margin_lr=da.TRIPLET_MARGIN_LR,
        avgpool_ins=is_resnet and c4, dtype=dtype)
