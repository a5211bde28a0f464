"""Planar homography sample coordinates (counterpart of
mine_tpu/ops/homography.py).

The plane at depth d with normal n = [0, 0, 1] in the source frame induces
H_tgt_src = K_tgt (R - t n^T / -d) K_src^-1; its closed-form inverse pulls
every target pixel back to a source-pixel sample location.
"""

from __future__ import annotations

import torch

from mine_tpu_torch.ops.geometry import (
    apply_3x3,
    homogeneous_pixel_grid,
    inverse_3x3,
    matmul3,
)


def build_plane_homography(g_tgt_src: torch.Tensor, k_src_inv: torch.Tensor,
                           k_tgt: torch.Tensor, plane_depth: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) H_tgt_src for fronto-parallel planes at `plane_depth` (B,)."""
    r = g_tgt_src[:, :3, :3]
    t = g_tgt_src[:, :3, 3]
    t_nt = torch.zeros_like(r)
    t_nt[:, :, 2] = t  # t n^T with n = [0, 0, 1]
    r_tnd = r - t_nt / (-plane_depth[:, None, None])
    return matmul3(matmul3(k_tgt, r_tnd), k_src_inv)


def homography_sample_coords(
    plane_depth: torch.Tensor,
    g_tgt_src: torch.Tensor,
    k_src_inv: torch.Tensor,
    k_tgt: torch.Tensor,
    h_src: int,
    w_src: int,
    tgt_height: int | None = None,
    tgt_width: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-pixel sample locations for every target pixel, plus validity.

    plane_depth: (B,); g_tgt_src (B, 4, 4); k_src_inv / k_tgt (B, 3, 3).
    Returns src_xy (B, Ht, Wt, 2), fp32 (float64 for float64 poses), and
    valid (B, Ht, Wt) bool: the target pixels that land inside the open
    interval (-1, W) x (-1, H).
    """
    h_tgt = tgt_height or h_src
    w_tgt = tgt_width or w_src
    h_src_tgt = inverse_3x3(
        build_plane_homography(g_tgt_src, k_src_inv, k_tgt, plane_depth)
    )
    # coordinates are at least fp32 whatever the payload's dtype
    h_src_tgt = h_src_tgt.to(torch.promote_types(h_src_tgt.dtype, torch.float32))
    grid = homogeneous_pixel_grid(h_tgt, w_tgt, h_src_tgt.device)
    src_homo = apply_3x3(h_src_tgt, grid[..., 0], grid[..., 1])  # (B, Ht, Wt, 3)
    # guard the perspective divide: |z| < 1e-8 (a plane edge-on to the target
    # camera) is pushed to +-1e-8, which sends the pixel far out of bounds
    # where the border clamp and the validity mask handle it
    z = src_homo[..., 2:3]
    z = torch.where(z.abs() < 1.0e-8, torch.where(z < 0, -1.0e-8, 1.0e-8), z)
    src_xy = src_homo[..., :2] / z
    valid = (
        (src_xy[..., 0] > -1.0)
        & (src_xy[..., 0] < w_src)
        & (src_xy[..., 1] > -1.0)
        & (src_xy[..., 1] < h_src)
    )
    return src_xy, valid
