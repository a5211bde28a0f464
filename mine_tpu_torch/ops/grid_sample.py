"""Bilinear sampling at pixel coordinates with border padding (counterpart of
mine_tpu/ops/grid_sample.py::grid_sample_pixel).

torch's grid_sample(padding_mode="border", align_corners=False) on
coordinates normalised as (p + 0.5) / (0.5 * size) - 1 samples at the raw
pixel coordinate p, so this samples at pixel coordinates directly through the
warp kernel (ops/kernels/warp.py). One kernel serves every source size.
"""

from __future__ import annotations

import torch

from mine_tpu_torch.ops.kernels.warp import warp_bilinear


def grid_sample_pixel(src: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """src (B, H, W, C); coords (B, Ho, Wo, 2) as (x, y) in src pixel units.
    Returns (B, Ho, Wo, C)."""
    out = warp_bilinear(
        src.permute(0, 3, 1, 2).contiguous(),
        coords[..., 0].contiguous(),
        coords[..., 1].contiguous(),
    )
    return out.permute(0, 2, 3, 1)
