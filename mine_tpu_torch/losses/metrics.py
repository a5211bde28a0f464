"""Image metrics and the sparse-point scale calibration (counterpart of
mine_tpu/losses/metrics.py)."""

from __future__ import annotations

import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor, size_average: bool = True) -> torch.Tensor:
    """Mean (or per-image (B,)) PSNR of (B, H, W, C) images in [0, 1]: the
    mean of per-image PSNRs, not the PSNR of the pooled MSE."""
    mse = torch.mean((img1 - img2) ** 2, dim=(1, 2, 3))
    per_image = 20.0 * torch.log10(1.0 / torch.sqrt(mse))
    return torch.mean(per_image) if size_average else per_image


def compute_scale_factor(disparity_syn_pt3d: torch.Tensor,
                         pt3d_disp: torch.Tensor) -> torch.Tensor:
    """Per-image scale exp(mean(log d_syn - log d_gt)) between synthesised
    and sparse-point disparities, both (B, N, 1) or (B, N). Returns (B,)."""
    log_ratio = torch.log(disparity_syn_pt3d) - torch.log(pt3d_disp)
    return torch.exp(torch.mean(log_ratio.reshape(log_ratio.shape[0], -1), dim=1))


def log_disparity_loss(disparity_syn_pt3d: torch.Tensor, pt3d_disp: torch.Tensor,
                       scale_factor: torch.Tensor, size_average: bool = True) -> torch.Tensor:
    """L1 in log space between the scale-calibrated synthesised disparity
    and the sparse-point disparity. A scalar, or per-image (B,)."""
    b = disparity_syn_pt3d.shape[0]
    scaled = disparity_syn_pt3d.reshape(b, -1) / scale_factor[:, None]
    per_image = torch.mean(torch.abs(torch.log(scaled) - torch.log(pt3d_disp.reshape(b, -1))), dim=1)
    return torch.mean(per_image) if size_average else per_image
