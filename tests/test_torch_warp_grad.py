"""The warp's backward in the port (mine_tpu_torch/ops/kernels/warp.py:
warp_bilinear_grad_plain and the autograd Function WarpBilinear) against the
JAX package's: the Pallas scatter kernels K2/K4 in interpret mode, the
shipped custom_vjp of gs._grid_sample_pallas, and the XLA path's vjp.

The plain version is what the wrapper runs on CPU tensors and what the CUDA
kernel (csrc/warp_grad.cu) is held against on the card, so these tests pin
the kernel's contract. Scene: that of tests/test_pallas_warp.py (N=2, C=3,
24x136 source, 16x130 output, coordinates in [-5, 145]). Tolerance 1e-4
wherever a Pallas scatter is involved: its two-term bf16 split of the
values carries ~3e-6 of the accumulated scale (test_pallas_warp.py:82-87).

Border cases: the Pallas corner pair is (floor(min(x, size-2)), +1) and the
coordinate cotangent is kept on the closed interval [0, size-1]; the XLA
path's corners are (floor(x), min(floor(x)+1, size-1)), whose coordinate
cotangent differs at exactly x = size-1. The border tests hold the port
against the Pallas backward, which the port follows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mine_tpu.ops.grid_sample as gs
from mine_tpu.ops.pallas.warp import warp_bilinear_grad_chw, warp_bilinear_grad_chw_banded
from mine_tpu_torch.ops.grid_sample import grid_sample_pixel
from mine_tpu_torch.ops.kernels import warp as kw
from torch_threads import one_torch_thread  # noqa: F401

N, C, H, W = 2, 3, 24, 136
HO, WO = 16, 130


@pytest.fixture()
def scene(rng):
    src = rng.uniform(size=(N, H, W, C)).astype(np.float32)
    coords = rng.uniform(-5, 145, size=(N, HO, WO, 2)).astype(np.float32)
    g = rng.normal(size=(N, HO, WO, C)).astype(np.float32)
    return src, coords, g


def _port_vjp(src, coords, g):
    """grid_sample_pixel's value and both cotangents through the port."""
    s = torch.from_numpy(src).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    out = grid_sample_pixel(s, c)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), s.grad.numpy(), c.grad.numpy()


def _jax_vjp(fn, src, coords, g):
    out, vjp = jax.vjp(fn, jnp.asarray(src), jnp.asarray(coords))
    d_src, d_coords = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(d_src), np.asarray(d_coords)


@pytest.mark.parametrize("kernel", [warp_bilinear_grad_chw, warp_bilinear_grad_chw_banded],
                         ids=["K2", "K4"])
def test_plain_backward_matches_pallas_scatter(scene, kernel):
    src, coords, g = scene
    cx, cy = coords[..., 0].copy(), coords[..., 1].copy()
    g_chw = np.ascontiguousarray(np.moveaxis(g, -1, 1))
    want = np.asarray(kernel(jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(g_chw), H, W,
                             interpret=True))
    got, gx, gy = kw.warp_bilinear_grad(
        torch.from_numpy(g_chw), torch.from_numpy(cx), torch.from_numpy(cy), H, W)
    assert gx is None and gy is None
    assert got.shape == (N, C, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_warp_bilinear_cotangents_match_pallas_custom_vjp(scene, monkeypatch):
    """Both cotangents against the JAX package's shipped custom_vjp pair,
    driven through jax.vjp in interpret mode."""
    monkeypatch.setattr(gs, "_INTERPRET", True)
    src, coords, g = scene
    out, d_src, d_coords = _port_vjp(src, coords, g)
    want_out, want_src, want_coords = _jax_vjp(gs._grid_sample_pallas, src, coords, g)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_src, want_src, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d_coords, want_coords, rtol=1e-4, atol=1e-4)


def test_warp_bilinear_cotangents_match_xla_vjp(scene):
    """Against the XLA path (the one the JAX package takes off the TPU).
    The random coordinates never sit exactly on a border or an integer, so
    the two corner conventions agree; 1e-5: the same fp32 arithmetic."""
    src, coords, g = scene
    out, d_src, d_coords = _port_vjp(src, coords, g)
    want_out, want_src, want_coords = _jax_vjp(gs._grid_sample_xla, src, coords, g)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_src, want_src, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_coords, want_coords, rtol=1e-5, atol=1e-5)


def _border_coords(h, w):
    """Exact grid hits, exact borders (0, size-2, size-1) and clamped
    out-of-range values in both axes."""
    xs = np.array([0.0, 1.0, 0.5, w - 2.0, w - 1.0, w / 2, -3.0, w + 4.0, w - 1.5], np.float32)
    ys = np.array([0.0, 1.0, 0.5, h - 2.0, h - 1.0, h / 2, -2.0, h + 1.0, h - 1.5], np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], -1)[None].astype(np.float32)


@pytest.mark.parametrize("h,w", [(16, 128), (1, 136), (24, 1), (1, 1)],
                         ids=["16x128", "one-pixel-rows", "one-pixel-columns", "one-pixel"])
def test_border_integer_and_one_pixel_cotangents_match_pallas(rng, monkeypatch, h, w):
    """At x = 0 and x = size-1 exactly, at integer coordinates and on
    1-pixel axes (where the corner at -1 reads 0), both cotangents follow
    the Pallas backward."""
    monkeypatch.setattr(gs, "_INTERPRET", True)
    coords = _border_coords(h, w)
    src = rng.uniform(size=(1, h, w, 2)).astype(np.float32)
    g = rng.normal(size=coords.shape[:3] + (2,)).astype(np.float32)
    out, d_src, d_coords = _port_vjp(src, coords, g)
    want_out, want_src, want_coords = _jax_vjp(gs._grid_sample_pallas, src, coords, g)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_src, want_src, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d_coords, want_coords, rtol=1e-4, atol=1e-4)
    # the clamp's mask: no coordinate gradient outside [0, size-1]
    outside_x = (coords[..., 0] < 0) | (coords[..., 0] > w - 1)
    assert np.all(d_coords[..., 0][outside_x] == 0)


def test_gradcheck_float64_away_from_the_clamp_edges():
    """torch.autograd.gradcheck of the CPU route: the hand-written backward
    against finite differences of the forward, in float64, with coordinates
    inside the image and off the integer grid (where bilinear sampling is
    not differentiable)."""
    gen = torch.Generator().manual_seed(0)
    n, c, h, w, ho, wo = 2, 3, 7, 9, 4, 5
    src = torch.rand((n, c, h, w), generator=gen, dtype=torch.float64).requires_grad_()
    frac = torch.rand((2, n, ho, wo), generator=gen, dtype=torch.float64) * 0.8 + 0.1
    base_x = torch.randint(0, w - 1, (n, ho, wo), generator=gen).double()
    base_y = torch.randint(0, h - 1, (n, ho, wo), generator=gen).double()
    cx = (base_x + frac[0]).requires_grad_()
    cy = (base_y + frac[1]).requires_grad_()
    assert torch.autograd.gradcheck(kw.warp_bilinear, (src, cx, cy))


def test_source_cotangent_alone_skips_the_coordinate_pass(scene):
    """With coordinates that need no gradient (the training path), the
    backward asks for the source cotangent only."""
    src, coords, g = scene
    s = torch.from_numpy(src).requires_grad_()
    out = grid_sample_pixel(s, torch.from_numpy(coords))
    out.backward(torch.from_numpy(g))
    _, d_src, _ = _port_vjp(src, coords, g)
    np.testing.assert_array_equal(s.grad.numpy(), d_src)


def test_backward_wrapper_refuses_bad_shapes():
    g = torch.rand(1, 2, 4, 5)
    cx = torch.rand(1, 4, 5)
    with pytest.raises(ValueError, match="warp_bilinear_grad"):
        kw.warp_bilinear_grad(g, cx[0], cx[0], 6, 7)
    with pytest.raises(ValueError, match="warp_bilinear_grad"):
        kw.warp_bilinear_grad(g, cx, cx, 6, 7, src=torch.rand(1, 2, 6, 8))
