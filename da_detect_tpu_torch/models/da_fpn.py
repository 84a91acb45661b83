"""Multi-level (FPN) domain-adaptation heads (port of
``da_detect_tpu/models/da_fpn.py``; the reference's da_heads_fpn.py design
sketch): a joint 1x1 image domain classifier applied to every level through
the gradient reversal, and a scale discriminator that classifies which
pyramid level a globally pooled feature came from. Opt-in building blocks:
the detectors' DA method is ``models/da.py``.

Maps are logical NCHW; the convs compute in ``dtype``, the scale
discriminator's linears in float32 (Flax's ``Dense`` without a dtype
promotes to its float32 parameters). Init as the JAX package's: the joint
convs normal(0.001), biases 0; the discriminator's linears lecun normal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d
from ..ops.grl import gradient_scalar
from ..ops.losses import bce_with_logits, softmax_cross_entropy


def _lecun_(linear: nn.Linear) -> None:
    std = (1.0 / linear.in_features) ** 0.5 / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, std, -2 * std, 2 * std)
        linear.bias.zero_()


class DAJointScaleHead(nn.Module):
    """A shared 1x1 tower (``conv1_joint`` to 512, ReLU, ``conv2_joint`` to
    1) applied to each level: per-level logits [B, 1, H_l, W_l]."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1_joint = Conv2d(in_channels, 512, 1, compute_dtype=dtype)
        self.conv2_joint = Conv2d(512, 1, 1, compute_dtype=dtype)
        with torch.no_grad():
            for conv in (self.conv1_joint, self.conv2_joint):
                conv.weight.normal_(0.0, 0.001)
                conv.bias.zero_()

    def forward(self, features: list) -> list:
        return [self.conv2_joint(F.relu(self.conv1_joint(f.to(self.dtype))))
                for f in features]


class ScaleDiscriminator(nn.Module):
    """The levels' maps averaged over space, stacked level-major [L*B, C],
    ``fc1`` (256, ReLU) and ``fc2`` (one logit a level)."""

    def __init__(self, in_channels: int, num_levels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_channels, 256)
        self.fc2 = nn.Linear(256, num_levels)
        _lecun_(self.fc1)
        _lecun_(self.fc2)

    def forward(self, features: list) -> torch.Tensor:
        pooled = [f.to(self.dtype).mean(dim=(2, 3)) for f in features]
        x = torch.cat(pooled, dim=0).float()
        return self.fc2(F.relu(self.fc1(x)))


class MultiLevelDAModule(nn.Module):
    """Per-level image DA (``scale_head`` on each level through a gradient
    reversal of ``grl_weight``; binary cross entropy of every pixel's logit
    against the image's domain, summed over levels and divided by the
    number of logits) and, with ``scale_weight`` > 0, the scale
    discriminator (``scale_disc``, on the levels as they are) with its
    cross entropy times ``scale_weight``. Returns the losses
    (``loss_da_image_mlvl``, ``loss_scale_disc``)."""

    def __init__(self, in_channels: int, num_levels: int,
                 grl_weight: float = 0.1, scale_weight: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grl_weight = grl_weight
        self.scale_weight = scale_weight
        self.scale_head = DAJointScaleHead(in_channels, dtype)
        self.scale_disc = (ScaleDiscriminator(in_channels, num_levels, dtype)
                           if scale_weight > 0 else None)

    def forward(self, features: list, is_source: torch.Tensor) -> dict:
        losses = {}
        grl_feas = [gradient_scalar(f, -self.grl_weight) for f in features]
        total, count = 0.0, 0.0
        for lvl in self.scale_head(grl_feas):
            lv = lvl.float().reshape(lvl.shape[0], -1)
            lab = is_source[:, None].float().expand_as(lv)
            total = total + bce_with_logits(lv, lab, reduction="sum")
            count = count + lv.numel()
        losses["loss_da_image_mlvl"] = total / count
        if self.scale_disc is not None:
            sl = self.scale_disc(features)
            b = features[0].shape[0]
            level_labels = torch.arange(
                len(features), device=sl.device).repeat_interleave(b)
            losses["loss_scale_disc"] = self.scale_weight \
                * softmax_cross_entropy(sl.float(), level_labels)
        return losses
