"""LPIPS perceptual metric (VGG16 backbone), eval-only (counterpart of
mine_tpu/losses/lpips.py).

  * VGG16 features tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
    relu5_3;
  * per-tap unit normalisation over channels (+1e-10 under the root),
    squared difference, non-negative per-channel "lin" weights, spatial mean,
    sum over taps;
  * the lpips scaling layer's shift/scale constants, applied to the images
    as given: the reference feeds [0, 1] images to an LPIPS configured for
    [-1, 1], a quirk kept for comparable numbers.

Weights are the JAX package's converted .npz (tools/convert_lpips.py: conv
kernels HWIO, lin weights flattened to (C,)). With no path set the metric is
off and reports 0.0; a path that is set but missing raises. The convolutions
are cuDNN's (F.conv2d): LPIPS is no Pallas kernel in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# channels per VGG16 conv layer; "M" marks 2x2 maxpools
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
# taps: conv index (conv-only numbering) after which LPIPS reads features
_TAP_AFTER_CONV = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_TAP_CHANNELS = (64, 128, 256, 512, 512)
# lpips.ScalingLayer constants (input nominally in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def load_lpips_params(path: str | None,
                      device: torch.device | str | None = None) -> dict | None:
    """Converted LPIPS weights on `device`, or None when `path` is unset
    (the metric then reports 0.0). A set but missing path raises."""
    if not path:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(f"LPIPS weights not found: {path!r}")
    n_conv = sum(1 for c in _VGG16_CFG if c != "M")
    with np.load(path) as data:
        conv_w = [torch.from_numpy(np.transpose(data[f"conv{i}_w"], (3, 2, 0, 1)).copy())
                  for i in range(n_conv)]  # HWIO -> OIHW
        conv_b = [torch.from_numpy(data[f"conv{i}_b"].copy()) for i in range(n_conv)]
        lin_w = [torch.from_numpy(data[f"lin{i}_w"].copy()) for i in range(len(_TAP_AFTER_CONV))]
    for i, (w, c) in enumerate(zip(lin_w, _TAP_CHANNELS)):
        if tuple(w.shape) != (c,):
            raise ValueError(f"lin{i}_w shape {tuple(w.shape)} != ({c},) in {path!r}")
    move = lambda ts: [t.to(device=device, dtype=torch.float32) for t in ts]  # noqa: E731
    return {"conv_w": move(conv_w), "conv_b": move(conv_b), "lin_w": move(lin_w)}


def _vgg_taps(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    taps, conv_i = [], 0
    for c in _VGG16_CFG:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = torch.relu(F.conv2d(x, params["conv_w"][conv_i], params["conv_b"][conv_i], padding=1))
        if conv_i in _TAP_AFTER_CONV:
            taps.append(x)
        conv_i += 1
    return taps


def lpips(params: dict, img1: torch.Tensor, img2: torch.Tensor,
          size_average: bool = True) -> torch.Tensor:
    """Mean (or per-image (B,), when not size_average) LPIPS distance between
    (B, H, W, 3) image batches."""
    b = img1.shape[0]
    shift = img1.new_tensor(_SHIFT)
    scale = img1.new_tensor(_SCALE)
    # one VGG pass over both batches
    x = ((torch.cat([img1, img2], dim=0) - shift) / scale).permute(0, 3, 1, 2)
    total = img1.new_zeros((b,))
    for tap, lin_w in zip(_vgg_taps(params, x), params["lin_w"]):
        n1 = tap[:b] * torch.rsqrt(torch.sum(tap[:b] ** 2, dim=1, keepdim=True) + 1.0e-10)
        n2 = tap[b:] * torch.rsqrt(torch.sum(tap[b:] ** 2, dim=1, keepdim=True) + 1.0e-10)
        weighted = torch.sum((n1 - n2) ** 2 * lin_w[None, :, None, None], dim=1)  # (B, H, W)
        total = total + torch.mean(weighted, dim=(1, 2))
    return torch.mean(total) if size_average else total
