"""The warp layer's hand-written CUDA kernels, their plain PyTorch versions,
and launch counts.

Counterpart of mine_tpu/ops/pallas/warp.py. Two kernels:

  * `warp_bilinear` (csrc/warp.cu): bilinear border-padded sampling,
    channels-major. Replaces warp_bilinear_chw and its banded twin
    warp_bilinear_chw_banded: device memory has no VMEM ceiling, so one
    kernel covers both source sizes.
  * `warp_composite` (csrc/warp_composite.cu): the fused per-plane warp and
    front-to-back over-composite of the streaming compositor. Replaces
    warp_composite_chw.

Each wrapper runs its plain version for tensors on the CPU and its kernel for
tensors on a CUDA device; there is no other path. Both are forward-only (the
backward kernels come with training), so a call that would need a gradient
raises instead of returning a detached result. `launches` counts kernel
launches, one per wrapper call that reached the card.
"""

from __future__ import annotations

import ctypes

import torch

from mine_tpu_torch.ops.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "warp": {"mine_warp_bilinear_f32": [_P] * 4 + [_I] * 6 + [_P]},
    "warp_composite": {"mine_warp_composite_f32": [_P] * 6 + [_I] * 7 + [_P]},
}
COMPOSITE_CHANNELS = 4  # rgb + sigma; warp_composite.cu is built for this C alone

launches = {"warp_bilinear": 0, "warp_composite": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


# -- wrappers ------------------------------------------------------------------


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version. Raises on a call the
    kernel cannot take: a gradient request, mixed devices, a device that is
    neither the CPU nor CUDA, or (on CUDA) a non-fp32 or non-contiguous
    input."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only; its backward comes with the training port"
        )
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
    """Bilinear border-padded sampling, channels-major.

    src: (N, C, H, W); coords_x/coords_y: (N, Ho, Wo) source-pixel coords.
    Returns (N, C, Ho, Wo). CUDA tensors launch csrc/warp.cu; CPU tensors
    take warp_bilinear_plain.
    """
    if src.dim() != 4 or coords_x.dim() != 3 or coords_x.shape != coords_y.shape \
            or coords_x.shape[0] != src.shape[0]:
        raise ValueError(
            f"warp_bilinear: src (N,C,H,W) and coords (N,Ho,Wo), got "
            f"{tuple(src.shape)}, {tuple(coords_x.shape)}, {tuple(coords_y.shape)}"
        )
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


def warp_composite(src: torch.Tensor, coords_x: torch.Tensor,
                   coords_y: torch.Tensor, dist: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """Fused warp + over-composite of an S-plane sweep.

    src: (N, S, 4, H, W) per-plane payload, rgb first, sigma LAST.
    coords_x/coords_y/dist/z: (N, S, Ho, Wo) sample coords, inter-plane
    distances (background pseudo-distance in the last plane's slot) and
    target-frame z. Returns (N, 7, Ho, Wo): 3 rgb-weighted sums, z sum,
    weight sum, in-FoV plane count, final transmittance. CUDA tensors launch
    csrc/warp_composite.cu; CPU tensors take warp_composite_plain.
    """
    plane_shape = coords_x.shape
    if src.dim() != 5 or len(plane_shape) != 4 or plane_shape[:2] != src.shape[:2] \
            or any(t.shape != plane_shape for t in (coords_y, dist, z)):
        raise ValueError(
            f"warp_composite: src (N,S,C,H,W) and coords/dist/z (N,S,Ho,Wo), got "
            f"{tuple(src.shape)} and "
            f"{[tuple(t.shape) for t in (coords_x, coords_y, dist, z)]}"
        )
    if src.shape[2] != COMPOSITE_CHANNELS:
        raise ValueError(
            f"warp_composite: C={src.shape[2]} outside the one channel count it "
            f"takes, {COMPOSITE_CHANNELS} (rgb + sigma)"
        )
    if not _route("warp_composite", src, coords_x, coords_y, dist, z):
        return warp_composite_plain(src, coords_x, coords_y, dist, z)
    n, s, c, h, w = src.shape
    ho, wo = plane_shape[2:]
    out = torch.empty((n, c + 3, ho, wo), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    lib = build.load("warp_composite", _SIGNATURES["warp_composite"])
    with torch.cuda.device(src.device):
        code = lib.mine_warp_composite_f32(
            src.data_ptr(), coords_x.data_ptr(), coords_y.data_ptr(),
            dist.data_ptr(), z.data_ptr(), out.data_ptr(),
            n, s, c, h, w, ho, wo, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, code, "warp_composite")
    launches["warp_composite"] += 1
    return out
