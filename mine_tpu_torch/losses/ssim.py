"""Gaussian-window SSIM (counterpart of mine_tpu/losses/ssim.py).

11x11 gaussian window (sigma 1.5), zero padding of window//2, depthwise
filtering, C1 = 0.01^2, C2 = 0.03^2, mean over the full map. The five
blurred maps come from one depthwise convolution over the stacked
[img1, img2, img1^2, img2^2, img1*img2].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    """1D gaussian, normalised to sum 1."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """SSIM of two (B, H, W, C) images in [0, 1]: a scalar, or per-image
    (B,) means when not size_average."""
    c1, c2 = 0.01**2, 0.03**2
    c = img1.shape[-1]
    x1, x2 = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    stacked = torch.cat([x1, x2, x1 * x1, x2 * x2, x1 * x2], dim=1)
    g = _gaussian_window(window_size, sigma)
    kernel = torch.from_numpy(np.outer(g, g)).to(stacked)
    kernel = kernel.expand(5 * c, 1, window_size, window_size)
    blurred = F.conv2d(stacked, kernel, padding=window_size // 2, groups=5 * c)
    mu1, mu2, m11, m22, m12 = torch.split(blurred, c, dim=1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))
