"""Plane-axis (S) sharded MPI compositing (counterpart of
mine_tpu/parallel/plane_sharding.py).

Each rank of a plane group holds a contiguous block of S_local planes,
nearest first by rank (rank p owns planes [p S_local, (p+1) S_local)).
Compositing is a prefix product over planes, so it runs in two levels: the
local cumulative product over the rank's planes, then the exclusive product
of the ranks' totals before it, from one all_gather of (B, H, W, 1)
transmittances. The (B, S_local, H, W, .) slabs never move; only (B, H, W, .)
statistics and the B first-plane depths (the halo) cross ranks.

The composited outputs are all-reduced and every rank of the group consumes
them identically (each computes the same loss), so those sums pass the local
cotangent back (parallel/comm.py all_reduce_replicated); the prefix and the
halo are real dependencies across ranks, and their gathers reduce-scatter
the cotangents. Masks that differ between the last rank and the others are
tensors, not branches, so that every rank builds the same graph and calls
the same collectives in the same order.

The target render runs the warp kernel (K1) on the rank's planes in the
dense compositor, with its backward kernel (K2); the streaming compositor
runs K5 on them with the halo plane (ops/mpi_render.py stream_scan) and the
chunked K1/K2 recompute in its backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from mine_tpu_torch.ops.kernels.warp import BG_DIST
from mine_tpu_torch.ops.mpi_render import (
    DEFAULT_STREAM_CHUNK,
    Compositor,
    _finalize_depth,
    _shifted_exclusive,
    plane_tgt_xyz,
    ray_norms,
    stream_scan,
    warp_mpi_to_tgt,
)
from mine_tpu_torch.parallel.comm import all_gather, all_reduce_replicated, group_rank, group_size


@dataclass(frozen=True)
class PlaneAxis:
    """The plane group of this rank (None on one rank), its index in it and
    the group's size."""

    group: object
    index: int
    size: int

    @classmethod
    def of(cls, group) -> "PlaneAxis":
        return cls(group, group_rank(group), group_size(group))

    def is_last(self, like: torch.Tensor) -> torch.Tensor:
        """Whether this rank holds the MPI's last plane, as a tensor."""
        return torch.tensor(self.index == self.size - 1, device=like.device)


def _exclusive_device_prefix(local_total: torch.Tensor, axis: PlaneAxis) -> torch.Tensor:
    """Product of the plane totals of the ranks before this one.
    local_total (...) -> (...)."""
    gathered = all_gather(local_total, axis.group)  # (n, ...)
    n = gathered.shape[0]
    mask = (torch.arange(n, device=gathered.device) < axis.index).reshape(
        (n,) + (1,) * local_total.dim())
    return torch.prod(torch.where(mask, gathered, 1.0), dim=0)


def _halo_next_first_plane(x: torch.Tensor, axis: PlaneAxis, fill: torch.Tensor) -> torch.Tensor:
    """The next rank's first plane of x (B, S_local, ...) -> (B, ...); the
    last rank gets `fill`."""
    gathered = all_gather(x[:, 0], axis.group)
    recv = gathered[(axis.index + 1) % gathered.shape[0]]
    return torch.where(axis.is_last(x), fill, recv)


def sharded_alpha_composition(alpha, value, axis: PlaneAxis):
    """Plane-sharded over-compositing (twin of ops alpha_composition).
    alpha (B, S_local, H, W, 1), value (B, S_local, H, W, C) -> composed
    (B, H, W, C), the same on every rank, and the local weights."""
    trans_local = torch.cumprod(1.0 - alpha, dim=1)
    prefix = _exclusive_device_prefix(trans_local[:, -1], axis)
    weights = alpha * (_shifted_exclusive(trans_local) * prefix[:, None])
    composed = all_reduce_replicated(torch.sum(value * weights, dim=1), axis.group)
    return composed, weights


def _bg_mask(axis: PlaneAxis, like: torch.Tensor) -> torch.Tensor:
    """(1, S_local, 1, 1, 1): the MPI's last plane, on the last rank only."""
    s_local = like.shape[1]
    last = (torch.arange(s_local, device=like.device) == s_local - 1).reshape(1, s_local, 1, 1, 1)
    return torch.logical_and(axis.is_last(like), last)


def _composite_sigma(rgb, sigma, xyz, xyz_next, axis: PlaneAxis, is_bg_depth_inf: bool):
    """Volume rendering of the local planes whose successor points are
    xyz[:, 1:] and, for the last, xyz_next (B, H, W, 3)."""
    diff = torch.cat([xyz, xyz_next[:, None]], dim=1).diff(dim=1)
    # the background slot's diff is replaced BEFORE the norm: the norm's
    # gradient at the zero vector is 0/0
    bg = _bg_mask(axis, xyz)
    diff = torch.where(bg, 1.0, diff)
    dist = torch.where(bg, BG_DIST, torch.linalg.vector_norm(diff, dim=-1, keepdim=True))
    transparency = torch.exp(-sigma * dist)
    alpha = 1.0 - transparency
    trans_local = torch.cumprod(transparency + 1.0e-6, dim=1)
    prefix = _exclusive_device_prefix(trans_local[:, -1], axis)
    transparency_acc = _shifted_exclusive(trans_local) * prefix[:, None]
    weights = transparency_acc * alpha
    rgb_out, depth_out = sharded_weighted_sum_mpi(rgb, xyz, weights, axis, is_bg_depth_inf)
    return rgb_out, depth_out, transparency_acc, weights


def sharded_plane_volume_rendering(rgb, sigma, xyz, axis: PlaneAxis,
                                   is_bg_depth_inf: bool = False):
    """Plane-sharded volume rendering (twin of plane_volume_rendering).
    rgb/xyz (B, S_local, H, W, 3), sigma (B, S_local, H, W, 1). Returns
    (rgb (B, H, W, 3), depth (B, H, W, 1)), the same on every rank, and the
    local transmittance and weights. The inter-plane distance at the block's
    end needs the next rank's first xyz (a (B, H, W, 3) halo)."""
    xyz_next = _halo_next_first_plane(xyz, axis, xyz[:, -1])
    return _composite_sigma(rgb, sigma, xyz, xyz_next, axis, is_bg_depth_inf)


def sharded_weighted_sum_mpi(rgb, xyz, weights, axis: PlaneAxis, is_bg_depth_inf: bool = False):
    """Plane-sharded expectation under compositing weights."""
    weights_sum = all_reduce_replicated(torch.sum(weights, dim=1), axis.group)
    rgb_out = all_reduce_replicated(torch.sum(weights * rgb, dim=1), axis.group)
    z_term = all_reduce_replicated(torch.sum(weights * xyz[..., 2:3], dim=1), axis.group)
    if is_bg_depth_inf:
        return rgb_out, z_term + (1.0 - weights_sum) * 1000.0
    return rgb_out, z_term / (weights_sum + 1.0e-5)


def sharded_render(rgb, sigma, xyz, axis: PlaneAxis, use_alpha: bool = False,
                   is_bg_depth_inf: bool = False):
    """Sigma or alpha compositing of local plane blocks (twin of render)."""
    if not use_alpha:
        return sharded_plane_volume_rendering(rgb, sigma, xyz, axis, is_bg_depth_inf)
    imgs_syn, weights = sharded_alpha_composition(sigma, rgb, axis)
    depth_syn, _ = sharded_alpha_composition(sigma, xyz[..., 2:3], axis)
    return imgs_syn, depth_syn, torch.zeros_like(rgb), weights


def _halo_depth(mpi_disparity, axis: PlaneAxis) -> torch.Tensor:
    """(B,) depth of the next rank's first plane (the last rank: its own
    last, a value no distance uses)."""
    depth = 1.0 / mpi_disparity
    return _halo_next_first_plane(depth[:, :, None], axis, depth[:, -1:])[:, 0]


def sharded_render_src(rgb, sigma, mpi_disparity, k_inv, axis: PlaneAxis,
                       use_alpha: bool = False, is_bg_depth_inf: bool = False):
    """Plane-sharded source-pose compositing (twin of render_src). The
    inter-plane distance at the block's end needs only the next rank's first
    plane depth."""
    if use_alpha:
        imgs_syn, weights = sharded_alpha_composition(sigma, rgb, axis)
        z = (1.0 / mpi_disparity)[:, :, None, None, None].expand(sigma.shape)
        depth_syn, _ = sharded_alpha_composition(sigma, z, axis)
        return imgs_syn, depth_syn, torch.zeros_like(rgb), weights
    h, w = rgb.shape[2], rgb.shape[3]
    depth = 1.0 / mpi_disparity
    depth_ext = torch.cat([depth, _halo_depth(mpi_disparity, axis)[:, None]], dim=1)
    ddiff = torch.abs(depth_ext[:, 1:] - depth_ext[:, :-1])
    dist = ddiff[:, :, None, None, None] * ray_norms(k_inv, h, w)[:, None]
    dist = torch.where(_bg_mask(axis, rgb), BG_DIST, dist)
    transparency = torch.exp(-sigma * dist)
    alpha = 1.0 - transparency
    trans_local = torch.cumprod(transparency + 1.0e-6, dim=1)
    prefix = _exclusive_device_prefix(trans_local[:, -1], axis)
    transparency_acc = _shifted_exclusive(trans_local) * prefix[:, None]
    weights = transparency_acc * alpha
    rgb_out, depth_out = sharded_weighted_sum_src(rgb, mpi_disparity, weights, axis,
                                                  is_bg_depth_inf)
    return rgb_out, depth_out, transparency_acc, weights


def sharded_weighted_sum_src(rgb, mpi_disparity, weights, axis: PlaneAxis,
                             is_bg_depth_inf: bool = False):
    """Plane-sharded weighted_sum_src: per-plane z is the plane depth."""
    z = (1.0 / mpi_disparity)[:, :, None, None, None]
    weights_sum = all_reduce_replicated(torch.sum(weights, dim=1), axis.group)
    rgb_out = all_reduce_replicated(torch.sum(weights * rgb, dim=1), axis.group)
    z_term = all_reduce_replicated(torch.sum(weights * z, dim=1), axis.group)
    if is_bg_depth_inf:
        return rgb_out, z_term + (1.0 - weights_sum) * 1000.0
    return rgb_out, z_term / (weights_sum + 1.0e-5)


def _plane_count(valid: torch.Tensor, axis: PlaneAxis) -> torch.Tensor:
    """The in-FoV plane count (B, H, W) summed over the group (no gradient)."""
    return all_reduce_replicated(valid, axis.group).detach()


def sharded_render_tgt_rgb_depth(mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src,
                                 k_src_inv, k_tgt, axis: PlaneAxis, use_alpha: bool = False,
                                 is_bg_depth_inf: bool = False):
    """Plane-sharded dense target render (twin of render_tgt_rgb_depth): the
    warp (K1 forward, K2 backward) runs on the rank's planes; the next
    rank's first plane enters as its depth, whose target-frame point is
    analytic (plane_tgt_xyz)."""
    h, w = mpi_rgb_src.shape[2:4]
    tgt_rgb, tgt_sigma, tgt_xyz, valid = warp_mpi_to_tgt(
        mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt)
    if use_alpha:
        rgb, depth, _, _ = sharded_render(tgt_rgb, tgt_sigma, tgt_xyz, axis, True,
                                          is_bg_depth_inf)
    else:
        xyz_next = plane_tgt_xyz(_halo_depth(mpi_disparity_src, axis), g_tgt_src, k_src_inv,
                                 k_tgt, h, w)
        rgb, depth, _, _ = _composite_sigma(tgt_rgb, tgt_sigma, tgt_xyz, xyz_next, axis,
                                            is_bg_depth_inf)
    mask = _plane_count(torch.sum(valid.to(mpi_rgb_src.dtype), dim=1), axis)
    return rgb, depth, mask[..., None]


def sharded_render_tgt_streaming(mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src,
                                 k_src_inv, k_tgt, axis: PlaneAxis, use_alpha: bool = False,
                                 is_bg_depth_inf: bool = False,
                                 chunk_planes: int = DEFAULT_STREAM_CHUNK):
    """Plane-sharded streaming target render (twin of
    render_tgt_rgb_depth_streaming): each rank scans its planes from a
    transmittance of 1 (K5 with the next rank's first plane as its halo;
    the last rank puts the background there), then the exclusive prefix of
    the ranks before it scales the partial sums, which are linear in the
    incoming transmittance."""
    rgb_p, z_p, w_p, m_p, t_total = stream_scan(
        mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt,
        halo_depth=_halo_depth(mpi_disparity_src, axis), bg_on_last=axis.index == axis.size - 1,
        use_alpha=use_alpha, chunk_planes=chunk_planes)
    prefix = _exclusive_device_prefix(t_total, axis)
    rgb_out = all_reduce_replicated(prefix * rgb_p, axis.group)
    z_sum = all_reduce_replicated(prefix * z_p, axis.group)
    w_sum = all_reduce_replicated(prefix * w_p, axis.group)
    mask = _plane_count(m_p, axis)
    return rgb_out, _finalize_depth(z_sum, w_sum, use_alpha, is_bg_depth_inf), mask[..., None]


def plane_compositor(axis: PlaneAxis, streaming: bool = False,
                     chunk_planes: int = DEFAULT_STREAM_CHUNK) -> Compositor:
    """The plane-sharded Compositor, a drop-in for the unsharded ones in the
    loss graph (training/step.py): the same signatures, the rank's plane
    block in, the whole composite out."""
    if streaming:
        tgt = partial(_render_tgt_streaming_kw, axis, chunk_planes)
    else:
        tgt = partial(_render_tgt_kw, axis)
    return Compositor(partial(_render_src_kw, axis), partial(_weighted_sum_src_kw, axis), tgt)


def _render_src_kw(axis, rgb, sigma, disparity, k_inv, use_alpha=False, is_bg_depth_inf=False):
    return sharded_render_src(rgb, sigma, disparity, k_inv, axis, use_alpha, is_bg_depth_inf)


def _weighted_sum_src_kw(axis, rgb, disparity, weights, is_bg_depth_inf=False):
    return sharded_weighted_sum_src(rgb, disparity, weights, axis, is_bg_depth_inf)


def _render_tgt_kw(axis, mpi_rgb, mpi_sigma, disparity, g, k_src_inv, k_tgt, use_alpha=False,
                   is_bg_depth_inf=False):
    return sharded_render_tgt_rgb_depth(mpi_rgb, mpi_sigma, disparity, g, k_src_inv, k_tgt,
                                        axis, use_alpha, is_bg_depth_inf)


def _render_tgt_streaming_kw(axis, chunk_planes, mpi_rgb, mpi_sigma, disparity, g, k_src_inv,
                             k_tgt, use_alpha=False, is_bg_depth_inf=False):
    return sharded_render_tgt_streaming(mpi_rgb, mpi_sigma, disparity, g, k_src_inv, k_tgt,
                                        axis, use_alpha, is_bg_depth_inf, chunk_planes)
