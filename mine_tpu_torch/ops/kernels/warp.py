"""The warp layer's hand-written CUDA kernels, their plain PyTorch versions,
and launch counts.

Counterpart of mine_tpu/ops/pallas/warp.py and of the custom_vjp in
mine_tpu/ops/grid_sample.py. Three kernels:

  * `warp_bilinear` (csrc/warp.cu): bilinear border-padded sampling,
    channels-major. Replaces warp_bilinear_chw and its banded twin
    warp_bilinear_chw_banded: device memory has no VMEM ceiling, so one
    kernel covers both source sizes.
  * `warp_bilinear_grad` (csrc/warp_grad.cu): its backward, the scatter of
    the source cotangent through a per-block source tile in shared memory
    (global atomics where a block's footprint does not fit), with the
    coordinate cotangent fused in. Replaces warp_bilinear_grad_chw and
    warp_bilinear_grad_chw_banded, plus the save_corners forward pass and
    the jnp coordinate formula of grid_sample.py::_pallas_bwd.
    `grad_path_blocks` reads how many blocks took each path.
  * `warp_composite` (csrc/warp_composite.cu): the fused per-plane warp and
    front-to-back over-composite of the streaming compositor, which computes
    each plane's sample coordinates, target-frame z and distances from
    per-plane 3x3 matrices and reads the MPI in place. Replaces
    warp_composite_chw and the coordinate prep in front of it. Forward-only
    (a call that would need a gradient raises instead of returning a detached
    result): the streaming render's backward (mpi_render.RenderTgtStreaming)
    recomputes the scan through warp_bilinear, as the JAX package's
    custom_vjp does. Its plain version is `warp_composite_matrix_plain`: the
    coordinates in torch (`composite_operands`), then `warp_composite_plain`,
    the coordinate form the Pallas kernel computes.

`warp_bilinear` is differentiable: it runs through the autograd Function
`WarpBilinear`, whose backward is `warp_bilinear_grad`. Each wrapper runs
its plain version for tensors on the CPU and its kernel for tensors on a
CUDA device; there is no other path. `launches` counts kernel launches, one
per wrapper call that reached the card.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from mine_tpu_torch.ops.geometry import apply_3x3, homogeneous_pixel_grid
from mine_tpu_torch.obs.attrib import scope
from mine_tpu_torch.ops.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "warp": {"mine_warp_bilinear_f32": [_P] * 4 + [_I] * 6 + [_P]},
    "warp_grad": {"mine_warp_bilinear_grad_f32": [_P] * 7 + [_I] * 6 + [_P, _P]},
    "warp_composite": {"mine_warp_composite_f32": [_P] * 6 + [_I] * 4 + [_P]},
}
BG_DIST = 1.0e3  # pseudo-distance behind the farthest plane (kBgDist in the kernel)

launches = {"warp_bilinear": 0, "warp_bilinear_grad": 0, "warp_composite": 0}
# per device: blocks of the backward kernel on its [shared, direct] path
_grad_paths: dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    """Zero the launch counts and the backward kernel's path counts."""
    for name in launches:
        launches[name] = 0
    for counts in _grad_paths.values():
        counts.zero_()


def grad_path_blocks() -> dict[str, int]:
    """Blocks of the backward kernel since the last reset_launches() that
    scattered through their shared-memory source tile ("shared") and that
    added straight into device memory ("direct"). Waits for the card."""
    shared = direct = 0
    for counts in _grad_paths.values():
        a, b = counts.tolist()
        shared, direct = shared + a, direct + b
    return {"shared": shared, "direct": direct}


# -- plain versions ------------------------------------------------------------


def _prep_coords(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Border clamp + corner split, as the Pallas kernel's _prep_coords:
    returns (wx, wy, x0, y0) with corners (x0, x0+1) x (y0, y0+1)."""
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0f = torch.floor(x.clamp(max=w - 2.0))
    y0f = torch.floor(y.clamp(max=h - 2.0))
    return x - x0f, y - y0f, x0f.long(), y0f.long()


def _corner(flat: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor,
            h: int, w: int) -> torch.Tensor:
    """flat (N, C, H*W) at integer corners (N, Ho, Wo) -> (N, C, Ho, Wo);
    a corner outside the image reads 0 (the Pallas kernel's tile mask)."""
    n, c, _ = flat.shape
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    vals = torch.gather(flat, 2, idx.reshape(n, 1, -1).expand(n, c, -1))
    return torch.where(valid[:, None], vals.reshape(n, c, *yi.shape[1:]), 0.0)


def warp_bilinear_plain(src: torch.Tensor, coords_x: torch.Tensor,
                        coords_y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the bilinear warp: an explicit 4-corner
    gather. src (N, C, H, W); coords (N, Ho, Wo) -> (N, C, Ho, Wo)."""
    n, c, h, w = src.shape
    wx, wy, x0, y0 = _prep_coords(coords_x, coords_y, h, w)
    flat = src.reshape(n, c, h * w)
    a00 = _corner(flat, y0, x0, h, w)
    a01 = _corner(flat, y0, x0 + 1, h, w)
    a10 = _corner(flat, y0 + 1, x0, h, w)
    a11 = _corner(flat, y0 + 1, x0 + 1, h, w)
    wx, wy = wx[:, None], wy[:, None]
    top = a00 * (1.0 - wx) + a01 * wx
    bot = a10 * (1.0 - wx) + a11 * wx
    return top * (1.0 - wy) + bot * wy


def warp_bilinear_grad_plain(g: torch.Tensor, coords_x: torch.Tensor,
                             coords_y: torch.Tensor, h: int, w: int,
                             src: torch.Tensor | None = None):
    """Plain PyTorch version of the warp's backward. g (N, C, Ho, Wo) is the
    output cotangent; coords (N, Ho, Wo). Returns (grad_src (N, C, h, w),
    grad_x, grad_y): the source cotangent is a scatter_add of g times each
    valid corner's weight; with `src` also the coordinate cotangents
    (N, Ho, Wo) of mine_tpu/ops/grid_sample.py:152-162, zero where the
    border clamp saturates. Without `src` grad_x and grad_y are None."""
    n, c = g.shape[:2]
    wx, wy, x0, y0 = _prep_coords(coords_x, coords_y, h, w)
    wx, wy = wx[:, None], wy[:, None]
    grad = g.new_zeros((n, c, h * w))
    # (dy, dx, weight) of the four corners, the Pallas kernel's products
    for dy, dx, wgt in ((0, 0, (1.0 - wx) * (1.0 - wy)), (0, 1, wx * (1.0 - wy)),
                        (1, 0, (1.0 - wx) * wy), (1, 1, wx * wy)):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = torch.where(valid[:, None], g * wgt, 0.0).reshape(n, c, -1)
        grad.scatter_add_(2, idx.expand(n, c, -1), vals)
    grad = grad.reshape(n, c, h, w)
    if src is None:
        return grad, None, None
    flat = src.reshape(n, c, h * w)
    a00 = _corner(flat, y0, x0, h, w)
    a01 = _corner(flat, y0, x0 + 1, h, w)
    a10 = _corner(flat, y0 + 1, x0, h, w)
    a11 = _corner(flat, y0 + 1, x0 + 1, h, w)
    dx = (a01 - a00) * (1.0 - wy) + (a11 - a10) * wy
    dy = (a10 - a00) * (1.0 - wx) + (a11 - a01) * wx
    in_x = (coords_x >= 0.0) & (coords_x <= w - 1.0)
    in_y = (coords_y >= 0.0) & (coords_y <= h - 1.0)
    grad_x = torch.where(in_x, torch.sum(g * dx, dim=1), 0.0)
    grad_y = torch.where(in_y, torch.sum(g * dy, dim=1), 0.0)
    return grad, grad_x, grad_y


def warp_composite_plain(src: torch.Tensor, coords_x: torch.Tensor,
                         coords_y: torch.Tensor, dist: torch.Tensor,
                         z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused warp-composite: warp each plane,
    then the over-composite recurrence, plane by plane. src (N, S, C, H, W)
    with sigma last; coords/dist/z (N, S, Ho, Wo) -> (N, C+3, Ho, Wo)."""
    n, s, c, h, w = src.shape
    ho, wo = coords_x.shape[2:]
    rgb = src.new_zeros((n, c - 1, ho, wo))
    z_sum = src.new_zeros((n, ho, wo))
    w_sum = src.new_zeros((n, ho, wo))
    valid_sum = src.new_zeros((n, ho, wo))
    trans = src.new_ones((n, ho, wo))
    for sp in range(s):
        x, y = coords_x[:, sp], coords_y[:, sp]
        vals = warp_bilinear_plain(src[:, sp], x, y)
        zz = z[:, sp]
        sigma = torch.where(zz >= 0.0, vals[:, c - 1], 0.0)
        valid = (x > -1.0) & (x < float(w)) & (y > -1.0) & (y < float(h))
        tau = torch.exp(-sigma * dist[:, sp])
        wgt = trans * (1.0 - tau)
        rgb = rgb + wgt[:, None] * vals[:, : c - 1]
        z_sum = z_sum + wgt * zz
        w_sum = w_sum + wgt
        valid_sum = valid_sum + valid.to(src.dtype)
        trans = trans * (tau + 1.0e-6)
    return torch.cat(
        [rgb, z_sum[:, None], w_sum[:, None], valid_sum[:, None], trans[:, None]],
        dim=1,
    )


def composite_operands(h_src_tgt: torch.Tensor, xyz_m: torch.Tensor,
                       xyz_t: torch.Tensor, h: int, w: int):
    """The per-plane coordinates that warp_composite's kernel computes, in
    torch and in the kernel's order of operations (that of the torch prep,
    mpi_render._plane_coords): returns coords_x, coords_y, dist and
    target-frame z, each (N, S, h, w), for an (h, w) target grid.

    h_src_tgt (N, S, 3, 3) maps target pixels [x, y, 1] to homogeneous
    source points, |z| < 1e-8 pushed to +-1e-8 before the divide; the plane's
    target-frame point is xyz_m (N, S, 3, 3) [x, y, 1] + xyz_t (N, 3) at the
    clamped sample; dist is the distance to the next plane's point, BG_DIST
    for the last plane."""
    n, s = h_src_tgt.shape[:2]
    grid = homogeneous_pixel_grid(h, w, h_src_tgt.device)
    homo = apply_3x3(h_src_tgt.reshape(n * s, 3, 3), grid[..., 0], grid[..., 1])
    hz = homo[..., 2]
    hz = torch.where(hz.abs() < 1.0e-8, torch.where(hz < 0, -1.0e-8, 1.0e-8), hz)
    x, y = homo[..., 0] / hz, homo[..., 1] / hz
    xyz = apply_3x3(xyz_m.reshape(n * s, 3, 3), x.clamp(0.0, w - 1.0), y.clamp(0.0, h - 1.0))
    xyz = (xyz + xyz_t.repeat_interleave(s, dim=0)[:, None, None]).reshape(n, s, h, w, 3)
    d = xyz[:, 1:] - xyz[:, :-1]
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    dist = torch.cat([dist, torch.full_like(xyz[:, -1:, ..., 2], BG_DIST)], dim=1)
    return x.reshape(n, s, h, w), y.reshape(n, s, h, w), dist, xyz[..., 2]


def warp_composite_matrix_plain(mpi_rgb: torch.Tensor, mpi_sigma: torch.Tensor,
                                h_src_tgt: torch.Tensor, xyz_m: torch.Tensor,
                                xyz_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of warp_composite (the matrix form): the
    coordinates by composite_operands, then warp_composite_plain on the
    channel-major payload. Same arguments and result as warp_composite."""
    h, w = mpi_rgb.shape[2:4]
    payload = torch.cat([mpi_rgb, mpi_sigma], dim=-1).permute(0, 1, 4, 2, 3)
    return warp_composite_plain(payload, *composite_operands(h_src_tgt, xyz_m, xyz_t, h, w))


# -- wrappers ------------------------------------------------------------------


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version. Raises on a call the
    kernel cannot take: mixed devices, a device that is neither the CPU nor
    CUDA, or (on CUDA) a non-fp32 or non-contiguous input."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    return True


def warp_bilinear(src: torch.Tensor, coords_x: torch.Tensor,
                  coords_y: torch.Tensor) -> torch.Tensor:
    """Bilinear border-padded sampling, channels-major, differentiable in all
    three inputs (through WarpBilinear).

    src: (N, C, H, W); coords_x/coords_y: (N, Ho, Wo) source-pixel coords.
    Returns (N, C, Ho, Wo). CUDA tensors launch csrc/warp.cu forward and
    csrc/warp_grad.cu backward; CPU tensors take the plain versions.
    """
    if src.dim() != 4 or coords_x.dim() != 3 or coords_x.shape != coords_y.shape \
            or coords_x.shape[0] != src.shape[0]:
        raise ValueError(
            f"warp_bilinear: src (N,C,H,W) and coords (N,Ho,Wo), got "
            f"{tuple(src.shape)}, {tuple(coords_x.shape)}, {tuple(coords_y.shape)}"
        )
    return WarpBilinear.apply(src, coords_x, coords_y)


def _warp_bilinear_forward(src: torch.Tensor, coords_x: torch.Tensor,
                           coords_y: torch.Tensor) -> torch.Tensor:
    """The forward launch (CUDA) or plain version (CPU) of warp_bilinear."""
    if not _route("warp_bilinear", src, coords_x, coords_y):
        return warp_bilinear_plain(src, coords_x, coords_y)
    n, c, h, w = src.shape
    _, ho, wo = coords_x.shape
    out = torch.empty((n, c, ho, wo), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    lib = build.load("warp", _SIGNATURES["warp"])
    with torch.cuda.device(src.device):
        code = lib.mine_warp_bilinear_f32(
            src.data_ptr(), coords_x.data_ptr(), coords_y.data_ptr(), out.data_ptr(),
            n, c, h, w, ho, wo, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, code, "warp_bilinear")
    launches["warp_bilinear"] += 1
    return out


def warp_bilinear_grad(g: torch.Tensor, coords_x: torch.Tensor,
                       coords_y: torch.Tensor, h: int, w: int,
                       src: torch.Tensor | None = None):
    """Backward of warp_bilinear: (grad_src (N, C, h, w), grad_x, grad_y).

    g: (N, C, Ho, Wo) output cotangent; coords: (N, Ho, Wo). With `src`
    (N, C, h, w) the coordinate cotangents (N, Ho, Wo) are computed too;
    without it they are None and the kernel skips its corner reads. CUDA
    tensors launch csrc/warp_grad.cu; CPU tensors take
    warp_bilinear_grad_plain.
    """
    n, c, ho, wo = g.shape if g.dim() == 4 else (None,) * 4
    if g.dim() != 4 or coords_x.shape != (n, ho, wo) or coords_y.shape != (n, ho, wo) \
            or (src is not None and src.shape != (n, c, h, w)):
        raise ValueError(
            f"warp_bilinear_grad: g (N,C,Ho,Wo), coords (N,Ho,Wo) and src "
            f"(N,C,{h},{w}), got {tuple(g.shape)}, {tuple(coords_x.shape)}, "
            f"{tuple(coords_y.shape)}, {None if src is None else tuple(src.shape)}"
        )
    operands = (g, coords_x, coords_y) + (() if src is None else (src,))
    if not _route("warp_bilinear_grad", *operands):
        return warp_bilinear_grad_plain(g, coords_x, coords_y, h, w, src)
    grad_src = torch.zeros((n, c, h, w), dtype=torch.float32, device=g.device)
    grad_x = grad_y = None
    if src is not None:
        grad_x = torch.zeros((n, ho, wo), dtype=torch.float32, device=g.device)
        grad_y = torch.zeros((n, ho, wo), dtype=torch.float32, device=g.device)
    if g.numel() == 0 or grad_src.numel() == 0:
        return grad_src, grad_x, grad_y
    paths = _grad_paths.get(g.device)
    if paths is None:
        paths = _grad_paths[g.device] = torch.zeros(2, dtype=torch.int64, device=g.device)
    lib = build.load("warp_grad", _SIGNATURES["warp_grad"])
    with torch.cuda.device(g.device):
        code = lib.mine_warp_bilinear_grad_f32(
            g.data_ptr(), coords_x.data_ptr(), coords_y.data_ptr(),
            None if src is None else src.data_ptr(), grad_src.data_ptr(),
            None if grad_x is None else grad_x.data_ptr(),
            None if grad_y is None else grad_y.data_ptr(),
            n, c, h, w, ho, wo, paths.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, code, "warp_bilinear_grad")
    launches["warp_bilinear_grad"] += 1
    return grad_src, grad_x, grad_y


class WarpBilinear(torch.autograd.Function):
    """warp_bilinear with its backward kernel (the counterpart of the JAX
    package's custom_vjp _grid_sample_pallas). The source is kept for the
    backward only when a coordinate needs a gradient: the source cotangent
    needs the coordinates alone."""

    @staticmethod
    def forward(ctx, src, coords_x, coords_y):
        need_coords = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.src_hw = tuple(src.shape[2:])
        ctx.save_for_backward(coords_x, coords_y, src if need_coords else None)
        return _warp_bilinear_forward(src, coords_x, coords_y)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coords_x, coords_y, src = ctx.saved_tensors
        # scoped where it runs: on the card, on the autograd engine's thread,
        # outside every forward scope (obs/attrib.py)
        with scope("homography_warp"):
            grad_src, grad_x, grad_y = warp_bilinear_grad(
                g.contiguous(), coords_x, coords_y, *ctx.src_hw, src
            )
        return (grad_src if ctx.needs_input_grad[0] else None,
                grad_x if ctx.needs_input_grad[1] else None,
                grad_y if ctx.needs_input_grad[2] else None)


def warp_composite(mpi_rgb: torch.Tensor, mpi_sigma: torch.Tensor,
                   h_src_tgt: torch.Tensor, xyz_m: torch.Tensor,
                   xyz_t: torch.Tensor) -> torch.Tensor:
    """Fused warp + over-composite of an S-plane sweep into N target views.

    mpi_rgb (N, S, H, W, 3) and mpi_sigma (N, S, H, W, 1): the MPI as the
    network gives it, read in place (on CUDA both must be contiguous fp32;
    nothing copies them). h_src_tgt (N, S, 3, 3): each plane's target pixel
    -> source pixel homography; xyz_m (N, S, 3, 3) and xyz_t (N, 3): the
    plane's target-frame point xyz_m [x, y, 1] + xyz_t at the clamped source
    sample (x, y) (see composite_operands). Returns (N, 7, H, W): 3
    rgb-weighted sums, z sum, weight sum, in-FoV plane count, final
    transmittance. CUDA tensors launch csrc/warp_composite.cu; CPU tensors
    take warp_composite_matrix_plain.
    """
    n, s = mpi_rgb.shape[:2] if mpi_rgb.dim() == 5 else (None, None)
    if mpi_rgb.dim() != 5 or mpi_rgb.shape[-1] != 3 \
            or mpi_sigma.shape != mpi_rgb.shape[:-1] + (1,) \
            or h_src_tgt.shape != (n, s, 3, 3) or xyz_m.shape != (n, s, 3, 3) \
            or xyz_t.shape != (n, 3):
        raise ValueError(
            f"warp_composite: mpi_rgb (N,S,H,W,3), mpi_sigma (N,S,H,W,1), "
            f"h_src_tgt and xyz_m (N,S,3,3), xyz_t (N,3), got "
            f"{[tuple(t.shape) for t in (mpi_rgb, mpi_sigma, h_src_tgt, xyz_m, xyz_t)]}"
        )
    operands = (mpi_rgb, mpi_sigma, h_src_tgt, xyz_m, xyz_t)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise NotImplementedError(
            "warp_composite is forward-only; a streaming render that needs a "
            "gradient goes through mpi_render.RenderTgtStreaming, whose backward "
            "recomputes the scan through warp_bilinear"
        )
    if not _route("warp_composite", *operands):
        return warp_composite_matrix_plain(*operands)
    h, w = mpi_rgb.shape[2:4]
    if h * w >= 2**31:
        raise ValueError(f"warp_composite: a {h}x{w} plane is past the kernel's 32-bit offsets")
    out = torch.empty((n, 7, h, w), dtype=torch.float32, device=mpi_rgb.device)
    if out.numel() == 0:
        return out
    lib = build.load("warp_composite", _SIGNATURES["warp_composite"])
    with torch.cuda.device(mpi_rgb.device):
        code = lib.mine_warp_composite_f32(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            n, s, h, w, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, code, "warp_composite")
    launches["warp_composite"] += 1
    return out
