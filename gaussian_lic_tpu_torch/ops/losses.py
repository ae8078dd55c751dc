"""Losses and image metrics: L1, PSNR, SSIM (separable blur), training loss.

Parity targets (the JAX package's `ops/losses.py`):
  * l1_loss: mean |a-b|                      (loss_utils.h:30-33)
  * psnr:    10*log10(1/mse)                 (loss_utils.h:35-39)
  * ssim:    11-tap Gaussian window sigma=1.5, zero "same" padding,
             C1=0.01^2, C2=0.03^2            (loss_utils.h:51-128)
  * training loss: (1-l)*L1 + l*(1-SSIM), l=0.2 (gaussian.cpp:691)

The blur is 2x11 shifted multiply-adds, not a convolution: cuDNN runs float32
convolutions in TF32 by default, whose rounding breaks the
sigma^2 = blur(x^2) - mu^2 cancellation on smooth regions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01**2
C2 = 0.03**2
_WINDOW_SIZE = 11
_SIGMA = 1.5


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse)


def _gaussian_window(window_size: int = _WINDOW_SIZE, sigma: float = _SIGMA) -> np.ndarray:
    """Normalized 1D Gaussian taps (loss_utils.h:51-65 uses x - ws//2)."""
    x = np.arange(window_size, dtype=np.float64) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


_TAPS = [float(v) for v in _gaussian_window()]


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable depthwise 11x11 Gaussian blur, zero 'same' padding, every tap
    in f32. img: (C, H, W)."""
    C, H, W = img.shape
    r = _WINDOW_SIZE // 2
    xp = F.pad(img, (0, 0, r, r))
    out = _TAPS[0] * xp[:, 0:H, :]
    for k in range(1, _WINDOW_SIZE):
        out = out + _TAPS[k] * xp[:, k:k + H, :]
    xp = F.pad(out, (r, r, 0, 0))
    out = _TAPS[0] * xp[:, :, 0:W]
    for k in range(1, _WINDOW_SIZE):
        out = out + _TAPS[k] * xp[:, :, k:k + W]
    return out


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map for (C, H, W) images in [0,1]."""
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1) - mu1_sq
    sigma2_sq = _blur(img2 * img2) - mu2_sq
    sigma12 = _blur(img1 * img2) - mu1_mu2
    return ((2.0 * mu1_mu2 + C1) * (2.0 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM."""
    return ssim_map(img1, img2).mean()


def training_loss(
    rendered: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2
) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM)  (gaussian.cpp:685-691)."""
    return (1.0 - lambda_dssim) * l1_loss(rendered, gt) + lambda_dssim * (
        1.0 - ssim(rendered, gt)
    )
