"""Plane disparity placement for inference (counterpart of the fixed branch
of mine_tpu/ops/sampling.py)."""

from __future__ import annotations

import numpy as np
import torch


def fixed_disparity_linspace(batch_size: int, num_bins: int, start: float, end: float,
                             device: torch.device | str | None = None) -> torch.Tensor:
    """Deterministic plane disparities, near plane first. Returns (B, S) fp32."""
    d = torch.from_numpy(np.linspace(start, end, num_bins).astype(np.float32))
    return d.to(device)[None, :].expand(batch_size, num_bins)
