"""SSIM and PSNR image-quality metrics (port of ``da_detect_tpu/ops/ssim.py``).

Images are logical NCHW in [0, 1]. SSIM takes an 11-tap, sigma-1.5
Gaussian window applied depthwise with zero padding, C1 = 0.01^2 and
C2 = 0.03^2 (the reference's pytorch_ssim); the deraining trainer uses it as
an optional loss term (1 - SSIM) and as a validation metric beside PSNR.
Plain PyTorch: no TPU kernel stands behind either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float,
                     device=None) -> torch.Tensor:
    g = torch.tensor([math.exp(-((x - window_size // 2) ** 2)
                               / (2.0 * sigma ** 2))
                      for x in range(window_size)], dtype=torch.float32,
                     device=device)
    g = g / g.sum()
    return torch.outer(g, g)                    # [W, W]


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    k = window[None, None].expand(c, 1, -1, -1)
    return F.conv2d(x, k, padding=window.shape[0] // 2, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, *, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """img1/img2 [B, C, H, W] in [0, 1]. Returns a scalar (``size_average``)
    or the per-image SSIM [B]."""
    img1, img2 = img1.float(), img2.float()
    w = _gaussian_window(window_size, sigma, img1.device)
    mu1 = _depthwise_blur(img1, w)
    mu2 = _depthwise_blur(img2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, w) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over unit-range images."""
    mse = torch.mean((img1.float() - img2.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))
