"""KPN deraining network (port of ``da_detect_tpu/models/derain.py``).

EfficientDeRain's kernel prediction network: a U-Net predicts per-pixel
filter kernels that are applied to the rainy input. ``KPN`` is the JAX
package's own net (base 32, softmaxed 5x5 kernels), ``KPNRef`` its
reference-exact EfficientDeRain KPN (3x3 kernels at rates 1-4, no softmax,
a 3x3 conv over the four predictions). Images are logical NCHW, float32:
the JAX trainer builds ``KPN()`` in float32, and on the card the
convolutions run in full float32 (``utils/env.py::reference_numerics``,
TF32 off), as the trainer sets it. The per-pixel filtering is stock
PyTorch, a sum over shifted copies as in the JAX package: no TPU kernel
stands behind it.

Resizes: ``jax.image.resize(..., "bilinear")`` (half-pixel centres; at an
edge the taps outside the map drop out and the rest renormalise) is
``F.interpolate(size=..., mode="bilinear", align_corners=False)`` (which
clamps the source index at an edge), also where the skip's size is not
twice the map's (``nn.avg_pool`` floors an odd size). State-dict names are
the JAX package's module paths (``enc1.conv0.weight`` for
``enc1/conv0/kernel``): ``utils/weights.py::load_jax_variables`` carries
them over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def apply_per_pixel_kernels(x: torch.Tensor, kernels: torch.Tensor,
                            ksize: int = 5) -> torch.Tensor:
    """x [B, C, H, W]; kernels [B, K*K, H, W] (softmaxed) -> filtered x:
    each output pixel the kernel-weighted sum of its K x K neighbourhood
    (zero padding), taps in row-major (dy, dx) order, summed in that
    order."""
    pad = ksize // 2
    xp = F.pad(x, (pad, pad, pad, pad))
    h, w = x.shape[2:]
    out = torch.zeros_like(x)
    idx = 0
    for dy in range(ksize):
        for dx in range(ksize):
            shifted = xp[:, :, dy:dy + h, dx:dx + w]
            out = out + shifted * kernels[:, idx:idx + 1]
            idx += 1
    return out


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


def _up2(t: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of ``t`` to ``skip``'s spatial size, 2x where the
    encoder's pool did not floor (the JAX package's
    ``jax.image.resize(..., "bilinear")``, half-pixel centres)."""
    return F.interpolate(t, size=skip.shape[2:], mode="bilinear",
                         align_corners=False)


class ConvBlock(nn.Module):
    """Two 3x3 conv + ReLU (``conv0``, ``conv1``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = _conv3(cin, features)
        self.conv1 = _conv3(features, features)

    def forward(self, x):
        return F.relu(self.conv1(F.relu(self.conv0(x))))


class KPN(nn.Module):
    """U-Net encoder/decoder emitting per-pixel K x K kernels (softmaxed)
    that filter the rainy image: [B, 3, H, W] -> [B, 3, H, W]."""

    def __init__(self, ksize: int = 5, base: int = 32):
        super().__init__()
        self.ksize = ksize
        b = base
        self.enc1 = ConvBlock(3, b)
        self.enc2 = ConvBlock(b, 2 * b)
        self.enc3 = ConvBlock(2 * b, 4 * b)
        self.mid = ConvBlock(4 * b, 8 * b)
        self.dec3 = ConvBlock(8 * b + 4 * b, 4 * b)
        self.dec2 = ConvBlock(4 * b + 2 * b, 2 * b)
        self.dec1 = ConvBlock(2 * b + b, b)
        self.kernel_head = _conv3(b, ksize * ksize)

    def forward(self, rainy: torch.Tensor) -> torch.Tensor:
        x = rainy.float()
        e1 = self.enc1(x)
        e2 = self.enc2(F.avg_pool2d(e1, 2, 2))
        e3 = self.enc3(F.avg_pool2d(e2, 2, 2))
        mid = self.mid(F.avg_pool2d(e3, 2, 2))

        def up(t, skip, block):
            return block(torch.cat([_up2(t, skip), skip], dim=1))

        d3 = up(mid, e3, self.dec3)
        d2 = up(d3, e2, self.dec2)
        d1 = up(d2, e1, self.dec1)
        kernels = torch.softmax(self.kernel_head(d1).float(), dim=1)
        return apply_per_pixel_kernels(x, kernels, self.ksize)


class BasicRef(nn.Module):
    """The reference's ``Basic`` block (attention off): three 3x3 conv +
    ReLU (``conv0``..``conv2``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = _conv3(cin, features)
        self.conv1 = _conv3(features, features)
        self.conv2 = _conv3(features, features)

    def forward(self, x):
        for conv in (self.conv0, self.conv1, self.conv2):
            x = F.relu(conv(x))
        return x


def kernel_conv_ref(x: torch.Tensor, core: torch.Tensor, ksize: int,
                    rate: int) -> torch.Tensor:
    """The reference's ``KernelConv`` on a 4D frame: per-channel K x K
    per-pixel kernels at dilation ``rate``, zero padding, no softmax.

    x [B, C, H, W]; core [B, C*K*K, H, W] with channel c * K*K + tap
    (c-major, tap-minor; the JAX package's [B, H, W, C*K*K] core), tap =
    dy * K + dx."""
    k2 = ksize * ksize
    b, c, h, w = x.shape
    pad = (ksize // 2) * rate
    xp = F.pad(x, (pad, pad, pad, pad))
    taps = torch.stack(
        [xp[:, :, dy * rate:dy * rate + h, dx * rate:dx * rate + w]
         for dy in range(ksize) for dx in range(ksize)], dim=2)
    # taps [B, C, K*K, H, W] against core [B, C, K*K, H, W]
    return (taps * core.reshape(b, c, k2, h, w)).sum(dim=2)


class KPNRef(nn.Module):
    """The reference-exact EfficientDeRain KPN with the vendored train.py
    defaults (colour, burst length 1, blind estimation, kernel size 3, no
    separable convs, attention or core bias): [B, 3, H, W] -> [B, 3, H, W]."""

    def __init__(self, ksize: int = 3):
        super().__init__()
        self.ksize = ksize
        out_ch = 3 * ksize * ksize
        self.conv1 = BasicRef(3, 64)
        self.conv2 = BasicRef(64, 128)
        self.conv3 = BasicRef(128, 256)
        self.conv4 = BasicRef(256, 512)
        self.conv5 = BasicRef(512, 512)
        self.conv6 = BasicRef(512 + 512, 512)
        self.conv7 = BasicRef(256 + 512, 256)
        self.conv8 = BasicRef(128 + 256, out_ch)
        self.outc = nn.Conv2d(out_ch, out_ch, 1)
        self.conv_final = _conv3(4 * 3, 3)

    def forward(self, rainy: torch.Tensor) -> torch.Tensor:
        x = rainy.float()

        def pool(t):
            return F.avg_pool2d(t, 2, 2)

        c1 = self.conv1(x)
        c2 = self.conv2(pool(c1))
        c3 = self.conv3(pool(c2))
        c4 = self.conv4(pool(c3))
        c5 = self.conv5(pool(c4))
        c6 = self.conv6(torch.cat([c4, _up2(c5, c4)], dim=1))
        c7 = self.conv7(torch.cat([c3, _up2(c6, c3)], dim=1))
        c8 = self.conv8(torch.cat([c2, _up2(c7, c2)], dim=1))
        core = self.outc(_up2(c8, x)).float()
        preds = [kernel_conv_ref(x, core, self.ksize, rate)
                 for rate in (1, 2, 3, 4)]
        return self.conv_final(torch.cat(preds, dim=1))


def derain_loss(pred: torch.Tensor, clean: torch.Tensor,
                l1_weight: float = 1.0) -> torch.Tensor:
    """L2 plus the L1 of the image gradients' difference (NCHW: H is dim 2,
    W dim 3)."""
    l2 = torch.mean((pred - clean) ** 2)
    dy = (torch.diff(pred, dim=2) - torch.diff(clean, dim=2)).abs().mean()
    dx = (torch.diff(pred, dim=3) - torch.diff(clean, dim=3)).abs().mean()
    return l2 + l1_weight * (dx + dy)
