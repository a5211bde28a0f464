"""Plane disparity placement and sparse-point gathering (counterpart of
mine_tpu/ops/sampling.py).

The stratified samplers draw from an explicit `torch.Generator`, one draw of
S uniforms per batch row in row order, so row i is the same whatever the
batch size (the JAX package's per-row fold_in keys give it the same
property). Both also take the (B, S) uniforms directly, so that a caller can
feed both packages the same numbers; so does `sample_pdf`, the inverse-CDF
sampler of coarse-to-fine plane placement.
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


def sample_pdf(values: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: torch.Generator | None = None,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling of the piecewise distribution weights = p(values)
    (coarse-to-fine plane placement). values/weights (B, N, S) -> (B, N,
    n_samples). The uniforms are `u` (B, N, n_samples) when given (tests feed
    the JAX package's jax.random.uniform draws), else drawn in fp32 from
    `generator` on its device. Bins whose CDF interval is degenerate
    (<= 1e-4) sample their midpoint."""
    b, n, s = weights.shape
    # midpoints as interior bin edges, the end values as outer edges
    mid = 0.5 * (values[..., 1:] + values[..., :-1])
    edges = torch.cat([values[..., :1], mid, values[..., -1:]], dim=-1)  # (B, N, S+1)
    pdf = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1.0e-5)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (B, N, S+1)
    if u is None:
        device = generator.device if generator is not None else None
        u = torch.rand((b, n, n_samples), generator=generator, device=device)
    u = u.to(device=weights.device, dtype=weights.dtype)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = torch.clamp(idx - 1, 0, s)
    hi = torch.clamp(idx, 0, s)
    cdf_lo, cdf_hi = torch.gather(cdf, -1, lo), torch.gather(cdf, -1, hi)
    bin_lo, bin_hi = torch.gather(edges, -1, lo), torch.gather(edges, -1, hi)
    cdf_interval = cdf_hi - cdf_lo
    t = (u - cdf_lo) / torch.clamp(cdf_interval, min=1.0e-5)
    t = torch.where(cdf_interval <= 1.0e-4, torch.full_like(t, 0.5), t)
    return bin_lo + t * (bin_hi - bin_lo)
