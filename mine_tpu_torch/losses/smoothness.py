"""Edge-aware disparity smoothness losses (counterpart of
mine_tpu/losses/smoothness.py).

v1: Sobel gradients (replicate padding; divided by 8 for the image, raw for
disparity), instance-normalised disparity gradients hinged at `gmin`, masked
away from image edges. v2: the mean-normalised first-difference smoothness.
Images are (B, H, W, C), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)


def spatial_gradient(x: torch.Tensor, normalized: bool = True):
    """Sobel x/y gradients of (B, H, W, C), replicate-padded: cross-correlation
    with [[-1,0,1],[-2,0,2],[-1,0,1]] and its transpose, each divided by 8
    when `normalized`. Returns (grad_x, grad_y), both (B, H, W, C)."""
    kx = _SOBEL_X / 8.0 if normalized else _SOBEL_X
    c = x.shape[-1]
    kernel = torch.from_numpy(np.stack([kx, kx.T])[:, None]).to(x)  # (2, 1, 3, 3)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    out = F.conv2d(xp, kernel.repeat(c, 1, 1, 1), groups=c)  # (B, 2C, H, W): [x, y] per channel
    out = out.reshape(out.shape[0], c, 2, *out.shape[2:]).permute(0, 3, 4, 1, 2)
    return out[..., 0], out[..., 1]


def _instance_norm(x: torch.Tensor, eps: float = 1.0e-5) -> torch.Tensor:
    """Per-(B, C) spatial standardisation with the biased variance, as
    jnp.var (torch.var defaults to the unbiased one)."""
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.var(x, dim=(1, 2), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def edge_aware_loss(img: torch.Tensor, disp: torch.Tensor, gmin: float,
                    grad_ratio: float = 0.1, size_average: bool = True) -> torch.Tensor:
    """Hinged, edge-masked smoothness. img (B, H, W, 3); disp (B, H, W, 1).
    A scalar, or per-image (B,) means when not size_average."""
    gx, gy = spatial_gradient(img, normalized=True)
    grad_img_x = torch.sum(torch.abs(gx), dim=-1, keepdim=True)
    grad_img_y = torch.sum(torch.abs(gy), dim=-1, keepdim=True)
    max_x = torch.amax(grad_img_x, dim=(1, 2, 3), keepdim=True)
    max_y = torch.amax(grad_img_y, dim=(1, 2, 3), keepdim=True)
    edge_mask_x = torch.clamp(grad_img_x / (max_x * grad_ratio), max=1.0)
    edge_mask_y = torch.clamp(grad_img_y / (max_y * grad_ratio), max=1.0)

    dx, dy = spatial_gradient(disp, normalized=False)
    grad_disp_x = _instance_norm(torch.abs(dx)) - gmin
    grad_disp_y = _instance_norm(torch.abs(dy)) - gmin

    loss_x = torch.clamp(grad_disp_x, min=0.0) * (1.0 - edge_mask_x)
    loss_y = torch.clamp(grad_disp_y, min=0.0) * (1.0 - edge_mask_y)
    if size_average:
        return torch.mean(loss_x + loss_y)
    return torch.mean(loss_x + loss_y, dim=(1, 2, 3))


def edge_aware_loss_v2(img: torch.Tensor, disp: torch.Tensor,
                       size_average: bool = True) -> torch.Tensor:
    """monodepth2-style mean-normalised smoothness. img (B, H, W, 3); disp
    (B, H, W, 1). A scalar, or per-image (B,) means when not size_average."""
    mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
    disp = disp / (mean_disp + 1.0e-7)
    grad_disp_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    grad_disp_y = torch.abs(disp[:, :-1] - disp[:, 1:])
    grad_img_x = torch.mean(torch.abs(img[:, :, :-1] - img[:, :, 1:]), dim=-1, keepdim=True)
    grad_img_y = torch.mean(torch.abs(img[:, :-1] - img[:, 1:]), dim=-1, keepdim=True)
    term_x = grad_disp_x * torch.exp(-grad_img_x)
    term_y = grad_disp_y * torch.exp(-grad_img_y)
    if size_average:
        return torch.mean(term_x) + torch.mean(term_y)
    return torch.mean(term_x, dim=(1, 2, 3)) + torch.mean(term_y, dim=(1, 2, 3))
