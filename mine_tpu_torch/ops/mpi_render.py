"""MPI compositing (counterpart of mine_tpu/ops/mpi_render.py without the
plane-sharded twins).

Layout is channel-last (B, S, H, W, C) as in the JAX package; the plane axis
S is axis 1 and every cumulative product runs over it.

Two target compositors:
  * dense: warp every plane into the target camera (warp kernel, through
    grid_sample_pixel), then composite the warped stack;
  * streaming: B*S tiny per-plane matrices in torch, then the fused
    warp-composite kernel, which computes each plane's coordinates from them,
    reads the MPI in place and never materialises a warped plane or an
    (S, H, W) coordinate array. Its backward recomputes the chunked scan
    through the warp kernel and its backward (RenderTgtStreaming); alpha MPIs
    take that scan forward and backward.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mine_tpu_torch.obs.attrib import scope, scoped
from mine_tpu_torch.ops.geometry import (
    apply_3x3,
    homogeneous_pixel_grid,
    inverse_3x3,
    matmul3,
)
from mine_tpu_torch.ops.grid_sample import grid_sample_pixel
from mine_tpu_torch.ops.homography import build_plane_homography, homography_sample_coords
from mine_tpu_torch.ops.kernels.warp import BG_DIST, warp_composite


def _shifted_exclusive(x: torch.Tensor, fill: float = 1.0) -> torch.Tensor:
    """[a, b, c] -> [fill, a, b] along the plane axis (dim 1)."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


@scoped("composite")
def alpha_composition(alpha: torch.Tensor, value: torch.Tensor):
    """Over-compositing of K planes, nearest first. alpha (B, K, H, W, 1),
    value (B, K, H, W, C) -> composed (B, H, W, C), weights (B, K, H, W, 1)."""
    preserve = _shifted_exclusive(torch.cumprod(1.0 - alpha, dim=1))
    weights = alpha * preserve
    return torch.sum(value * weights, dim=1), weights


@scoped("composite")
def weighted_sum_mpi(rgb, xyz, weights, is_bg_depth_inf: bool = False):
    """Expectation of rgb and depth under compositing weights.
    rgb/xyz (B, S, H, W, 3); weights (B, S, H, W, 1)."""
    weights_sum = torch.sum(weights, dim=1)
    rgb_out = torch.sum(weights * rgb, dim=1)
    z = xyz[..., 2:3]
    if is_bg_depth_inf:
        depth_out = torch.sum(weights * z, dim=1) + (1.0 - weights_sum) * 1000.0
    else:
        depth_out = torch.sum(weights * z, dim=1) / (weights_sum + 1.0e-5)
    return rgb_out, depth_out


@scoped("composite")
def plane_volume_rendering(rgb, sigma, xyz, is_bg_depth_inf: bool = False):
    """Volume rendering across depth planes: per-pixel inter-plane distances
    turn sigma into transparency exp(-sigma * dist); transmittance is a
    shifted cumprod over planes. Returns (rgb, depth, transmittance, weights)."""
    dist = torch.linalg.vector_norm(xyz[:, 1:] - xyz[:, :-1], dim=-1, keepdim=True)
    dist = torch.cat([dist, torch.full_like(dist[:, :1], BG_DIST)], dim=1)
    transparency = torch.exp(-sigma * dist)
    alpha = 1.0 - transparency
    transparency_acc = _shifted_exclusive(torch.cumprod(transparency + 1.0e-6, dim=1))
    weights = transparency_acc * alpha
    rgb_out, depth_out = weighted_sum_mpi(rgb, xyz, weights, is_bg_depth_inf)
    return rgb_out, depth_out, transparency_acc, weights


def render(rgb, sigma, xyz, use_alpha: bool = False, is_bg_depth_inf: bool = False):
    """Sigma- or alpha-compositing. Returns (imgs, depth, blend_weights,
    weights); with use_alpha the blend weights are zeros."""
    if not use_alpha:
        return plane_volume_rendering(rgb, sigma, xyz, is_bg_depth_inf)
    imgs_syn, weights = alpha_composition(sigma, rgb)
    depth_syn, _ = alpha_composition(sigma, xyz[..., 2:3])
    return imgs_syn, depth_syn, torch.zeros_like(rgb), weights


# -- source pose: distances factor into an (S,) vector times an (H, W) map ----


def ray_norms(k_inv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """||K^-1 [x, y, 1]|| per pixel: (B, 3, 3) -> (B, H, W, 1)."""
    grid = homogeneous_pixel_grid(h, w, k_inv.device)
    rays = apply_3x3(k_inv, grid[..., 0], grid[..., 1])
    return torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def _src_dists(mpi_disparity, k_inv, h: int, w: int) -> torch.Tensor:
    """(B, S) disparities -> (B, S, H, W, 1) source-sweep inter-plane
    distances, background pseudo-distance in the last slot."""
    depth = 1.0 / mpi_disparity
    ddiff = torch.abs(depth[:, 1:] - depth[:, :-1])
    dist = ddiff[:, :, None, None, None] * ray_norms(k_inv, h, w)[:, None]
    return torch.cat([dist, torch.full_like(dist[:, :1], BG_DIST)], dim=1)


@scoped("composite")
def weighted_sum_src(rgb, mpi_disparity, weights, is_bg_depth_inf: bool = False):
    """weighted_sum_mpi at the source pose, where per-plane z is the plane
    depth 1/disparity (normalised intrinsics, K[2,2] = 1)."""
    z = (1.0 / mpi_disparity)[:, :, None, None, None]
    weights_sum = torch.sum(weights, dim=1)
    rgb_out = torch.sum(weights * rgb, dim=1)
    if is_bg_depth_inf:
        depth_out = torch.sum(weights * z, dim=1) + (1.0 - weights_sum) * 1000.0
    else:
        depth_out = torch.sum(weights * z, dim=1) / (weights_sum + 1.0e-5)
    return rgb_out, depth_out


@scoped("composite")
def render_src(rgb, sigma, mpi_disparity, k_inv, use_alpha: bool = False,
               is_bg_depth_inf: bool = False):
    """`render` at the source pose from disparities + intrinsics alone.
    rgb (B, S, H, W, 3); sigma (B, S, H, W, 1); mpi_disparity (B, S);
    k_inv (B, 3, 3). Returns (imgs, depth, blend_weights, weights)."""
    h, w = rgb.shape[2], rgb.shape[3]
    if use_alpha:
        imgs_syn, weights = alpha_composition(sigma, rgb)
        z = (1.0 / mpi_disparity)[:, :, None, None, None].expand(sigma.shape)
        depth_syn, _ = alpha_composition(sigma, z)
        return imgs_syn, depth_syn, torch.zeros_like(rgb), weights
    dist = _src_dists(mpi_disparity, k_inv, h, w)
    transparency = torch.exp(-sigma * dist)
    alpha = 1.0 - transparency
    transparency_acc = _shifted_exclusive(torch.cumprod(transparency + 1.0e-6, dim=1))
    weights = transparency_acc * alpha
    rgb_out, depth_out = weighted_sum_src(rgb, mpi_disparity, weights, is_bg_depth_inf)
    return rgb_out, depth_out, transparency_acc, weights


@scoped("composite")
def plane_contributions(sigma, mpi_disparity, k_inv, use_alpha: bool = False,
                        vis_dilate_px: int = 8) -> torch.Tensor:
    """Per-plane maximum compositing weight, the pruning quantity of the
    serving cache (serving/compress.py): alpha times the accumulated
    transmittance, the transmittance first dilated by a (2 vis_dilate_px +
    1)^2 max window over (H, W) so that a plane hidden at the source pose
    but revealed by parallax within that radius survives; then the max over
    batch and pixels. sigma (B, S, H, W, 1); mpi_disparity (B, S); k_inv
    (B, 3, 3). Returns (S,).

    The transmittance is the compositors' own, +1e-6 cumprod epsilon
    included. F.max_pool2d pads with -inf, as the JAX package's SAME
    reduce_window does, so the border takes the max over the in-image part
    of its window."""
    h, w = sigma.shape[2], sigma.shape[3]
    if use_alpha:
        alpha = sigma
        transparency = 1.0 - alpha
    else:
        transparency = torch.exp(-sigma * _src_dists(mpi_disparity, k_inv, h, w))
        alpha = 1.0 - transparency
    transparency_acc = _shifted_exclusive(torch.cumprod(transparency + 1.0e-6, dim=1))
    if vis_dilate_px > 0:
        d = 2 * int(vis_dilate_px) + 1
        # (B, S, H, W, 1) -> (B, S, H, W): the planes ride the channel axis
        transparency_acc = F.max_pool2d(transparency_acc[..., 0], kernel_size=d, stride=1,
                                         padding=int(vis_dilate_px))[..., None]
    weights = transparency_acc * alpha
    return torch.amax(weights, dim=(0, 2, 3, 4))


# -- target pose -----------------------------------------------------------------


def _affine_tgt_xyz(src_xy, depth, g_flat, k_inv_flat, h: int, w: int) -> torch.Tensor:
    """Target-frame plane xyz evaluated at the clamped warp coords: per plane
    xyz is affine in source pixel coords, so this replaces warping 3 more
    channels. src_xy (N, H, W, 2); depth (N,); g_flat (N, 4, 4);
    k_inv_flat (N, 3, 3). Returns (N, H, W, 3)."""
    qx = src_xy[..., 0].clamp(0.0, float(w - 1))
    qy = src_xy[..., 1].clamp(0.0, float(h - 1))
    m = matmul3(g_flat[:, :3, :3], k_inv_flat) * depth[:, None, None]
    return apply_3x3(m, qx, qy) + g_flat[:, None, None, :3, 3]


def _plane_coords(mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt, h: int, w: int):
    """Per-plane sample coords, validity and target-frame xyz for every
    (batch, plane) pair, flattened to B*S: (src_xy, valid, xyz)."""
    b, s = mpi_disparity_src.shape
    depth = (1.0 / mpi_disparity_src).reshape(b * s)
    g_flat = g_tgt_src.repeat_interleave(s, dim=0)
    k_inv_flat = k_src_inv.repeat_interleave(s, dim=0)
    src_xy, valid = homography_sample_coords(
        depth, g_flat, k_inv_flat, k_tgt.repeat_interleave(s, dim=0), h, w
    )
    xyz = _affine_tgt_xyz(src_xy, depth, g_flat, k_inv_flat, h, w)
    return src_xy, valid, xyz


@scoped("homography_warp")
def warp_mpi_to_tgt(mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src,
                    k_src_inv, k_tgt):
    """Homography-warp every source plane into the target camera. Only rgb +
    sigma (4 channels) go through the warp kernel; xyz is evaluated
    analytically. Returns (tgt_rgb, tgt_sigma, tgt_xyz, valid) with
    behind-camera sigma zeroed; valid is (B, S, H, W)."""
    b, s, h, w, _ = mpi_rgb_src.shape
    src_xy, valid, tgt_xyz = _plane_coords(
        mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt, h, w
    )
    payload = torch.cat([mpi_rgb_src, mpi_sigma_src], dim=-1).reshape(b * s, h, w, 4)
    warped = grid_sample_pixel(payload, src_xy).reshape(b, s, h, w, 4)
    tgt_xyz = tgt_xyz.reshape(b, s, h, w, 3)
    tgt_sigma = torch.where(tgt_xyz[..., 2:3] >= 0.0, warped[..., 3:4], 0.0)
    return warped[..., 0:3], tgt_sigma, tgt_xyz, valid.reshape(b, s, h, w)


def render_tgt_rgb_depth(mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src,
                         k_src_inv, k_tgt, use_alpha: bool = False,
                         is_bg_depth_inf: bool = False):
    """Dense target render. mpi_rgb_src (B, S, H, W, 3); mpi_sigma_src
    (B, S, H, W, 1); mpi_disparity_src (B, S); g_tgt_src (B, 4, 4);
    k_src_inv / k_tgt (B, 3, 3). Returns tgt_rgb (B, H, W, 3), tgt_depth
    (B, H, W, 1), tgt_mask (B, H, W, 1) = planes landing in the FoV."""
    tgt_rgb, tgt_sigma, tgt_xyz, valid = warp_mpi_to_tgt(
        mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt
    )
    rgb, depth, _, _ = render(
        tgt_rgb, tgt_sigma, tgt_xyz, use_alpha=use_alpha, is_bg_depth_inf=is_bg_depth_inf
    )
    return rgb, depth, torch.sum(valid.to(mpi_rgb_src.dtype), dim=1)[..., None]


def streaming_inputs(mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src,
                     k_src_inv, k_tgt) -> tuple[torch.Tensor, ...]:
    """The coordinate-form operands of one target render, as the Pallas
    kernel takes them (kernels.warp.warp_composite_plain): payload
    (B, S, 4, H, W) with sigma last, then coords_x, coords_y, dist and
    target-frame z, each (B, S, H, W), from the dense path's coordinate prep.
    The reference the matrix form (streaming_matrices) is held against."""
    b, s, h, w, _ = mpi_rgb_src.shape
    src_xy, _, xyz = _plane_coords(mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt, h, w)
    xyz = xyz.reshape(b, s, h, w, 3)
    dist = torch.linalg.vector_norm(xyz[:, 1:] - xyz[:, :-1], dim=-1)
    dist = torch.cat([dist, torch.full_like(dist[:, :1], BG_DIST)], dim=1)
    payload = torch.cat([mpi_rgb_src, mpi_sigma_src], dim=-1).permute(0, 1, 4, 2, 3)
    coords = src_xy.reshape(b, s, h, w, 2)
    return (payload.contiguous(), coords[..., 0].contiguous(),
            coords[..., 1].contiguous(), dist.contiguous(), xyz[..., 2].contiguous())


@scoped("homography_warp")
def streaming_matrices(mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt):
    """warp_composite's per-plane matrices for one target render, built as
    _plane_coords builds them: h_src_tgt (B, S, 3, 3), the inverse plane
    homographies; xyz_m (B, S, 3, 3) = G[:3, :3] K_src^-1 depth and xyz_t
    (B, 3) = G[:3, 3], the affine target-frame xyz of _affine_tgt_xyz.
    Contiguous, at least fp32."""
    b, s = mpi_disparity_src.shape
    depth = (1.0 / mpi_disparity_src).reshape(b * s)
    g_flat = g_tgt_src.repeat_interleave(s, dim=0)
    k_inv_flat = k_src_inv.repeat_interleave(s, dim=0)
    h_src_tgt = inverse_3x3(build_plane_homography(
        g_flat, k_inv_flat, k_tgt.repeat_interleave(s, dim=0), depth))
    xyz_m = matmul3(g_flat[:, :3, :3], k_inv_flat) * depth[:, None, None]

    def fp32_or_wider(t: torch.Tensor, shape) -> torch.Tensor:
        return t.to(torch.promote_types(t.dtype, torch.float32)).reshape(shape).contiguous()

    return (fp32_or_wider(h_src_tgt, (b, s, 3, 3)), fp32_or_wider(xyz_m, (b, s, 3, 3)),
            fp32_or_wider(g_tgt_src[:, :3, 3], (b, 3)))


# -- streaming target compositor -------------------------------------------------
#
# Over-compositing is a prefix product over S, so the plane axis can be
# streamed in chunks that carry only (B, H, W, .) accumulators. The forward of
# a sigma MPI is one warp_composite launch (K5); its backward, and the whole of
# an alpha MPI's render, is the chunked scan of the JAX package's _stream_scan,
# each chunk warped through warp_bilinear (K1 forward, K2 backward). Neither
# pass holds a (B, S, H, W, .) warped tensor.

DEFAULT_STREAM_CHUNK = 4


def _chunk_size(s: int, requested: int) -> int:
    """Largest divisor of the plane count <= the requested chunk size (an odd
    S degrades to smaller chunks instead of failing); >= 1 always."""
    requested = max(1, min(int(requested), s))
    for d in range(requested, 0, -1):
        if s % d == 0:
            return d
    return 1


@scoped("homography_warp")
def plane_tgt_xyz(depth, g_tgt_src, k_src_inv, k_tgt, h: int, w: int) -> torch.Tensor:
    """Target-frame xyz of ONE plane per batch item at its own warp coords,
    depth (B,) -> (B, H, W, 3): the same formulas as warp_mpi_to_tgt's xyz,
    so the streaming scan gets the next chunk's first plane (its halo) without
    touching that chunk's payload."""
    src_xy, _ = homography_sample_coords(depth, g_tgt_src, k_src_inv, k_tgt, h, w)
    return _affine_tgt_xyz(src_xy, depth, g_tgt_src, k_src_inv, h, w)


def _finalize_depth(z_sum, w_sum, use_alpha: bool, is_bg_depth_inf: bool):
    """Composited z partial sums -> depth, as the dense reductions."""
    if use_alpha:
        return z_sum
    if is_bg_depth_inf:
        return z_sum + (1.0 - w_sum) * 1000.0
    return z_sum / (w_sum + 1.0e-5)


def _stream_chunk(rgb, sigma, disparity, next_depth, t_acc, g_tgt_src, k_src_inv, k_tgt,
                  use_alpha: bool, bg_last: bool):
    """One chunk of the streaming scan (the body of the JAX package's
    _stream_scan). rgb (B, c, H, W, 3), sigma (B, c, H, W, 1), disparity
    (B, c); next_depth (B,) is the depth of the plane after the chunk's last;
    t_acc (B, H, W, 1) the transmittance entering the chunk. With bg_last the
    chunk's last plane is the MPI's last, whose distance is BG_DIST. Returns
    the chunk's (rgb, z, weight) sums, its in-FoV plane count (B, H, W) and
    the transmittance leaving it."""
    tgt_rgb, tgt_sigma, tgt_xyz, valid = warp_mpi_to_tgt(
        rgb, sigma, disparity, g_tgt_src, k_src_inv, k_tgt)
    # everything past the warp is compositing math (the warp and the halo
    # plane carry their own homography_warp scope)
    with scope("composite"):
        if use_alpha:
            alpha = tgt_sigma
            trans_local = torch.cumprod(1.0 - alpha, dim=1)
        else:
            h, w = rgb.shape[2:4]
            xyz_next = plane_tgt_xyz(next_depth, g_tgt_src, k_src_inv, k_tgt, h, w)
            diff = torch.diff(torch.cat([tgt_xyz, xyz_next[:, None]], dim=1), dim=1)
            if bg_last:
                # the background slot's diff is replaced BEFORE the norm: the
                # norm's gradient at the zero vector is 0/0
                last = torch.zeros((1, rgb.shape[1], 1, 1, 1), dtype=torch.bool,
                                   device=rgb.device)
                last[:, -1] = True
                diff = torch.where(last, 1.0, diff)
                dist = torch.where(last, BG_DIST,
                                   torch.linalg.vector_norm(diff, dim=-1, keepdim=True))
            else:
                dist = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
            transparency = torch.exp(-tgt_sigma * dist)
            alpha = 1.0 - transparency
            trans_local = torch.cumprod(transparency + 1.0e-6, dim=1)
        weights = t_acc[:, None] * _shifted_exclusive(trans_local) * alpha
        return (torch.sum(weights * tgt_rgb, dim=1),
                torch.sum(weights * tgt_xyz[..., 2:3], dim=1), torch.sum(weights, dim=1),
                torch.sum(valid.to(rgb.dtype), dim=1), t_acc * trans_local[:, -1])


def _chunk_args(mpi_rgb, mpi_sigma, disparity, chunk: int, k: int):
    """(rgb, sigma, disparity, next_depth, is_last) of chunk k; the trailing
    chunk's halo is its own last plane, whose slot holds the background."""
    n = mpi_rgb.shape[1] // chunk
    sl = slice(k * chunk, (k + 1) * chunk)
    nxt = disparity[:, (k + 1) * chunk] if k < n - 1 else disparity[:, -1]
    return mpi_rgb[:, sl], mpi_sigma[:, sl], disparity[:, sl], 1.0 / nxt, k == n - 1


def _stream_sweep(mpi_rgb, mpi_sigma, disparity, g_tgt_src, k_src_inv, k_tgt,
                  use_alpha: bool, chunk: int, n_chunks: int):
    """The scan over the first n_chunks chunks: returns the (rgb, z, weight,
    mask) sums and the transmittance entering each chunk and leaving the
    last, n_chunks + 1 tensors of (B, H, W, 1)."""
    b, _, h, w, _ = mpi_rgb.shape
    sums = None
    trans = [mpi_rgb.new_ones((b, h, w, 1))]
    for k in range(n_chunks):
        rgb, sigma, disp, nxt, last = _chunk_args(mpi_rgb, mpi_sigma, disparity, chunk, k)
        *parts, t_out = _stream_chunk(rgb, sigma, disp, nxt, trans[-1], g_tgt_src, k_src_inv,
                                      k_tgt, use_alpha, last)
        sums = parts if sums is None else [a + p for a, p in zip(sums, parts)]
        trans.append(t_out)
    return sums, trans


class RenderTgtStreaming(torch.autograd.Function):
    """The streaming target render with a chunked-recompute backward (the
    custom_vjp _render_tgt_fused of the JAX package).

    Forward: sigma MPIs run one warp_composite launch (K5), alpha MPIs the
    chunked scan, both with autograd off; only the inputs are saved. Backward:
    a sweep over all chunks but the last, with autograd off, keeps the
    transmittance entering each chunk (the sums enter later chunks with an
    identity Jacobian, so they need no carry); then the chunks in reverse, each
    recomputed with autograd on and back-propagated with the carried
    transmittance cotangent. Each chunk's warp is warp_bilinear: K1 forward,
    K2 backward, K2 without the coordinate cotangent unless a pose or
    disparity needs a gradient. Working set O(chunk H W). Outputs: the rgb
    (B, H, W, 3), z and weight (B, H, W, 1) sums and the in-FoV plane count
    (B, H, W), not differentiable."""

    @staticmethod
    def forward(ctx, mpi_rgb, mpi_sigma, disparity, g_tgt_src, k_src_inv, k_tgt,
                use_alpha: bool, chunk: int):
        ctx.save_for_backward(mpi_rgb, mpi_sigma, disparity, g_tgt_src, k_src_inv, k_tgt)
        ctx.use_alpha, ctx.chunk = use_alpha, chunk
        if use_alpha:
            (rgb, z, wsum, mask), _ = _stream_sweep(
                mpi_rgb, mpi_sigma, disparity, g_tgt_src, k_src_inv, k_tgt, True, chunk,
                mpi_rgb.shape[1] // chunk)
        else:
            matrices = streaming_matrices(disparity, g_tgt_src, k_src_inv, k_tgt)
            with scope("composite"):
                acc = warp_composite(mpi_rgb.contiguous(), mpi_sigma.contiguous(),
                                     *matrices).permute(0, 2, 3, 1)
            rgb, z, wsum, mask = acc[..., 0:3], acc[..., 3:4], acc[..., 4:5], acc[..., 5]
        ctx.mark_non_differentiable(mask)
        return rgb, z, wsum, mask

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rgb, g_z, g_w, _g_mask):
        inputs = ctx.saved_tensors
        mpi_rgb, mpi_sigma = inputs[:2]
        chunk, n = ctx.chunk, mpi_rgb.shape[1] // ctx.chunk
        _, trans = _stream_sweep(*inputs, ctx.use_alpha, chunk, n - 1)
        need_rgb, need_sigma, *need_small = ctx.needs_input_grad[:6]
        # the (B, S) and per-batch operands are leaves whose gradient sums
        # over the chunks; rgb and sigma are cut into per-chunk leaves
        small = [x.detach().requires_grad_(nd) for x, nd in zip(inputs[2:], need_small)]
        grad_rgb = torch.empty_like(mpi_rgb) if need_rgb else None
        grad_sigma = torch.empty_like(mpi_sigma) if need_sigma else None
        grad_small = [None] * 4
        g_t = None
        for k in reversed(range(n)):
            t_in = trans[k].detach().requires_grad_(k > 0)
            with torch.enable_grad():
                rgb, sigma, disp, nxt, last = _chunk_args(mpi_rgb, mpi_sigma, small[0], chunk, k)
                rgb = rgb.detach().requires_grad_(need_rgb)
                sigma = sigma.detach().requires_grad_(need_sigma)
                *sums, _, t_out = _stream_chunk(rgb, sigma, disp, nxt, t_in, *small[1:],
                                                ctx.use_alpha, last)
            outs = list(zip(sums + [t_out], [g_rgb, g_z, g_w, g_t]))
            outs = [(o, c) for o, c in outs if c is not None and o.requires_grad]
            wrt = [x for x in (rgb, sigma, *small, t_in) if x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in outs], wrt, [c for _, c in outs],
                                           allow_unused=True))
            sl = slice(k * chunk, (k + 1) * chunk)
            for leaf, dest in ((rgb, grad_rgb), (sigma, grad_sigma)):
                if leaf.requires_grad:
                    g = next(got)
                    dest[:, sl] = 0.0 if g is None else g
            for i, leaf in enumerate(small):
                if leaf.requires_grad:
                    g = next(got)
                    if g is not None:
                        grad_small[i] = g if grad_small[i] is None else grad_small[i] + g
            g_t = next(got) if t_in.requires_grad else None
        return (grad_rgb, grad_sigma, *grad_small, None, None)


def render_tgt_rgb_depth_streaming(mpi_rgb_src, mpi_sigma_src, mpi_disparity_src,
                                   g_tgt_src, k_src_inv, k_tgt, use_alpha: bool = False,
                                   is_bg_depth_inf: bool = False,
                                   chunk_planes: int = DEFAULT_STREAM_CHUNK):
    """Streaming twin of render_tgt_rgb_depth (same signature and outputs).

    Without a gradient to compute, a sigma MPI renders with one warp_composite
    launch that reads the MPI in place (the serving path). Otherwise, and for
    every alpha MPI, the render goes through RenderTgtStreaming, whose
    backward recomputes the scan chunk by chunk (chunk_planes, degraded to a
    divisor of S)."""
    operands = (mpi_rgb_src, mpi_sigma_src, mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt)
    if use_alpha or (torch.is_grad_enabled() and any(t.requires_grad for t in operands)):
        chunk = _chunk_size(mpi_rgb_src.shape[1], chunk_planes)
        # the backward's ops outside the chunk scopes (its sweep's glue, the
        # gradient slabs) take this forward op's scope
        with scope("composite"):
            rgb, z, wsum, mask = RenderTgtStreaming.apply(*operands, use_alpha, chunk)
    else:
        matrices = streaming_matrices(mpi_disparity_src, g_tgt_src, k_src_inv, k_tgt)
        with scope("composite"):
            acc = warp_composite(mpi_rgb_src.contiguous(), mpi_sigma_src.contiguous(),
                                 *matrices)
        # (B, 7, H, W): rgb sums (3), z sum, weight sum, valid count, transmittance
        acc = acc.permute(0, 2, 3, 1)
        rgb, z, wsum, mask = acc[..., 0:3], acc[..., 3:4], acc[..., 4:5], acc[..., 5]
    return rgb, _finalize_depth(z, wsum, use_alpha, is_bg_depth_inf), mask[..., None]


class Compositor(NamedTuple):
    """The S-axis reductions a render composites through."""

    render_src: Callable
    weighted_sum_src: Callable
    render_tgt_rgb_depth: Callable


DENSE_COMPOSITOR = Compositor(render_src, weighted_sum_src, render_tgt_rgb_depth)


def streaming_compositor(chunk_planes: int) -> Compositor:
    """The streaming peer of DENSE_COMPOSITOR. Only the target render
    streams: the source sweep's per-plane weights feed the source-RGB
    blending, so render_src keeps them."""
    return Compositor(render_src, weighted_sum_src,
                      partial(render_tgt_rgb_depth_streaming, chunk_planes=chunk_planes))


def compositor_from_config(cfg) -> Compositor:
    """cfg.mpi.compositor ("dense" | "streaming") -> Compositor; streaming
    scans in chunks of cfg.mpi.stream_chunk_planes planes."""
    name = cfg.mpi.compositor
    if name == "dense":
        return DENSE_COMPOSITOR
    if name == "streaming":
        return streaming_compositor(cfg.mpi.stream_chunk_planes)
    raise ValueError(f"mpi.compositor={name!r} must be 'dense' or 'streaming'")
