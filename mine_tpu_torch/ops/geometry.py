"""Camera geometry primitives (counterpart of mine_tpu/ops/geometry.py).

Every 3x3 product here is written out as fp32 multiply-adds instead of a
matmul: the products feed pixel coordinates up to ~1000, and a matmul could
run in TF32 on the card (three decimal digits, half-pixel warp errors). The
JAX package pins Precision.HIGHEST for the same reason.
"""

from __future__ import annotations

import torch


def inverse_3x3(m: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Closed-form (adjugate / determinant) inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c

    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / (det[..., None, None] + eps)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as fp32 multiply-adds (never TF32)."""
    return a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :] \
        + a[..., :, 2:3] * b[..., 2:3, :]


def apply_3x3(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """m (B, 3, 3) applied to the homogeneous points [x, y, 1]; x/y broadcast
    against (B, H, W). Returns (B, H, W, 3), each row summed in the order
    m[i,0]*x + m[i,1]*y + m[i,2]."""
    rows = [
        m[:, i, 0, None, None] * x + m[:, i, 1, None, None] * y + m[:, i, 2, None, None]
        for i in range(3)
    ]
    return torch.stack(rows, dim=-1)


def homogeneous_pixel_grid(height: int, width: int,
                           device: torch.device | str | None = None) -> torch.Tensor:
    """(H, W, 3) grid [x, y, 1] of integer pixel coordinates, fp32."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def src_xyz_from_plane_disparity(mpi_disparity: torch.Tensor, k_inv: torch.Tensor,
                                 height: int, width: int) -> torch.Tensor:
    """Per-plane source-frame xyz of every pixel: depth * K^-1 [x, y, 1].
    mpi_disparity (B, S), k_inv (B, 3, 3) -> (B, S, H, W, 3)."""
    grid = homogeneous_pixel_grid(height, width, k_inv.device)
    rays = apply_3x3(k_inv, grid[..., 0], grid[..., 1])  # (B, H, W, 3)
    return rays[:, None] * (1.0 / mpi_disparity)[:, :, None, None, None]


def scale_intrinsics(k: torch.Tensor, scale: int) -> torch.Tensor:
    """Divide K by 2**scale, keeping K[2,2] = 1 (the loss pyramid's
    intrinsics at scale `scale`)."""
    k = k / (2.0**scale)
    k[..., 2, 2] = 1.0
    return k
