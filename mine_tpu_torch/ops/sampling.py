"""Plane disparity placement and sparse-point gathering (counterpart of
mine_tpu/ops/sampling.py).

The stratified samplers draw from an explicit `torch.Generator`, one draw of
S uniforms per batch row in row order, so row i is the same whatever the
batch size (the JAX package's per-row fold_in keys give it the same
property). Both also take the (B, S) uniforms directly, so that a caller can
feed both packages the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def stratified_uniform(batch_size: int, num_bins: int,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, S) uniforms in [0, 1) from `generator`, drawn row by row on the
    generator's device."""
    device = generator.device if generator is not None else None
    return torch.stack([
        torch.rand(num_bins, generator=generator, device=device)
        for _ in range(batch_size)
    ])


def uniform_disparity_from_linspace_bins(
    batch_size: int, num_bins: int, start: float, end: float,
    generator: torch.Generator | None = None, uniforms: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """One uniform draw inside each of S linspace bins over [start, end],
    start > end (descending disparity, near plane first). Returns (B, S)."""
    if not start > end:
        raise ValueError("disparity must descend (near plane first)")
    if uniforms is None:
        uniforms = stratified_uniform(batch_size, num_bins, generator)
    edges = torch.from_numpy(np.linspace(start, end, num_bins + 1).astype(np.float32))
    edges = edges.to(device if device is not None else uniforms.device)
    interval = edges[1] - edges[0]  # negative
    return edges[None, :-1] + interval * uniforms.to(edges.device)


def uniform_disparity_from_bins(
    batch_size: int, disparity_edges, generator: torch.Generator | None = None,
    uniforms: torch.Tensor | None = None, device: torch.device | str | None = None,
) -> torch.Tensor:
    """Stratified samples from explicit (S+1,) bin edges, descending.
    Returns (B, S)."""
    edges = torch.as_tensor(np.asarray(disparity_edges, np.float32))
    s = edges.shape[0] - 1
    if uniforms is None:
        uniforms = stratified_uniform(batch_size, s, generator)
    edges = edges.to(device if device is not None else uniforms.device)
    interval = edges[1:] - edges[:-1]
    return edges[None, :-1] + interval[None, :] * uniforms.to(edges.device)


def fixed_disparity_linspace(batch_size: int, num_bins: int, start: float, end: float,
                             device: torch.device | str | None = None,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Deterministic plane disparities, near plane first. Returns (B, S)."""
    d = torch.from_numpy(np.linspace(start, end, num_bins)).to(dtype)
    return d.to(device)[None, :].expand(batch_size, num_bins)


def gather_pixel_by_pxpy(img: torch.Tensor, pxpy: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel lookup of img (B, H, W, C) at pixel coords pxpy
    (B, N, 2) -> (B, N, C). Indices are rounded half to even (as jnp.round),
    clamped, and carry no gradient; the gather is differentiable in img."""
    b, h, w, c = img.shape
    idx = torch.round(pxpy.detach()).long()
    ix = idx[..., 0].clamp(0, w - 1)
    iy = idx[..., 1].clamp(0, h - 1)
    flat = img.reshape(b, h * w, c)
    return torch.gather(flat, 1, (iy * w + ix)[..., None].expand(b, -1, c))
