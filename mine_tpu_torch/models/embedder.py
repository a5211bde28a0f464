"""NeRF positional encoding of scalar plane disparities (counterpart of
mine_tpu/models/embedder.py)."""

from __future__ import annotations

import torch


def embed_dim(multires: int, input_dims: int = 1) -> int:
    return input_dims + 2 * multires * input_dims


def positional_encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(..., D) -> (..., D + 2*multires*D), laid out
    [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with f_k = 2**k."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]  # (..., F, D)
    sc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)  # (..., F, 2, D)
    return torch.cat([x, sc.reshape(*x.shape[:-1], -1)], dim=-1)
