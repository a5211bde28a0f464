"""The streaming compositor's matrix form (the per-plane matrices of
streaming_matrices, then warp_composite, whose plain version computes the
coordinates in torch) against the JAX package's fused streaming forward and
against the port's own coordinate form, at S=4, 24x40.

Poses: a gentle one; one whose forward translation puts the nearest plane
behind the target camera (its sigma must be masked); and one yawed past half
the field of view, so the planes' vanishing line crosses the image: the
homography's third coordinate changes sign there (the |z| < 1e-8 guard's
neighbourhood, coordinates far out of bounds beyond it) and each plane lies
partly behind the camera.

Tolerances. Against the coordinate form (the dense path's torch prep +
warp_composite_plain) 1e-5: the same coordinates, the distances taken as an
explicit square root instead of vector_norm. Against JAX's _fused_forward
(Pallas kernel in interpret mode) 1e-4, as the other streaming tests hold
the JAX package: both composite plane by plane in fp32, but the JAX package
builds its homographies and coordinates in its own association, and near the
edge-on pose's vanishing line a rounding of the coordinates grows (one rgb
value of 2880 lies 3.1e-5 apart there; the others within 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mine_tpu.ops.mpi_render as jmr
from mine_tpu.ops import inverse_3x3 as jinv
from mine_tpu_torch.ops import mpi_render as mr
from mine_tpu_torch.ops.geometry import apply_3x3, homogeneous_pixel_grid, inverse_3x3
from mine_tpu_torch.ops.kernels import warp as kw

B, S, H, W = 1, 4, 24, 40
POSES = {  # (tx, ty, tz, yaw)
    "gentle": (0.05, -0.02, 0.01, 0.03),
    "plane_behind": (0.1, 0.05, -1.3, 0.3),
    "edge_on": (0.02, 0.0, 0.1, 0.95),
}


def _scene(rng, pose):
    rgb = rng.uniform(size=(B, S, H, W, 3)).astype(np.float32)
    sigma = rng.uniform(0.1, 3.0, size=(B, S, H, W, 1)).astype(np.float32)
    k = np.array([[[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1.0]]], np.float32)
    disparity = np.linspace(1.0, 0.1, S, dtype=np.float32)[None]
    tx, ty, tz, yaw = POSES[pose]
    g = np.eye(4, dtype=np.float32)[None]
    c, s = np.cos(yaw), np.sin(yaw)
    g[0, 0, 0], g[0, 0, 2], g[0, 2, 0], g[0, 2, 2] = c, s, -s, c
    g[0, :3, 3] = [tx, ty, tz]
    return rgb, sigma, disparity, g, k


def _torch_args(scene):
    rgb, sigma, disparity, g, k = (torch.from_numpy(a) for a in scene)
    return rgb, sigma, disparity, g, inverse_3x3(k), k


def _jax_args(scene):
    rgb, sigma, disparity, g, k = (jnp.asarray(a) for a in scene)
    return rgb, sigma, disparity, g, jinv(k), k


def _close(got, want, tol, names):
    for g_, w_, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(g_), np.asarray(w_), rtol=tol, atol=tol,
                                   err_msg=name)


def test_scenes_reach_the_masks(rng):
    """plane_behind has its nearest plane behind the camera (z < 0) and the
    others in front; edge_on has planes with z < 0 and z >= 0 pixels and a
    homogeneous z that changes sign in the image."""
    def target_z_and_hz(pose):
        _, _, disparity, g, k_inv, k = _torch_args(_scene(rng, pose))
        mats = mr.streaming_matrices(disparity, g, k_inv, k)
        grid = homogeneous_pixel_grid(H, W)
        hz = apply_3x3(mats[0][0], grid[..., 0], grid[..., 1])[..., 2]
        return kw.composite_operands(*mats, H, W)[3][0], hz

    z, _ = target_z_and_hz("plane_behind")
    assert bool((z[0] < 0).all()) and bool((z[1:] > 0).all())
    z, hz = target_z_and_hz("edge_on")
    assert all(bool((zs < 0).any() and (zs >= 0).any()) for zs in z)
    assert bool((hz < 0).any() and (hz > 0).any())


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("is_bg_depth_inf", [False, True])
def test_matrix_form_matches_jax_fused_forward(rng, monkeypatch, pose, is_bg_depth_inf):
    scene = _scene(rng, pose)
    monkeypatch.setattr(jmr, "_FORCE_FUSED_INTERPRET", True)
    want = jmr._fused_forward(*_jax_args(scene), is_bg_depth_inf=is_bg_depth_inf)
    got = mr.render_tgt_rgb_depth_streaming(*_torch_args(scene),
                                            is_bg_depth_inf=is_bg_depth_inf)
    _close(got, want, 1e-4, ["rgb", "depth", "mask"])


@pytest.mark.parametrize("pose", sorted(POSES))
def test_matrix_form_matches_coordinate_form(rng, pose):
    rgb, sigma, disparity, g, k_inv, k = _torch_args(_scene(rng, pose))
    got = kw.warp_composite_matrix_plain(rgb, sigma, *mr.streaming_matrices(
        disparity, g, k_inv, k))
    want = kw.warp_composite_plain(*mr.streaming_inputs(rgb, sigma, disparity, g, k_inv, k))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_matrix_form_coordinates_are_the_dense_paths(rng):
    """composite_operands repeats the dense path's coordinate prep op for op:
    coordinates and z bit for bit, distances to rounding."""
    rgb, sigma, disparity, g, k_inv, k = _torch_args(_scene(rng, "edge_on"))
    got = kw.composite_operands(*mr.streaming_matrices(disparity, g, k_inv, k), H, W)
    want = mr.streaming_inputs(rgb, sigma, disparity, g, k_inv, k)[1:]
    for name, a, b in zip(("coords_x", "coords_y", "z"), got[:2] + got[3:], want[:2] + want[3:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-6)


def test_streaming_matrices_shapes():
    disparity = torch.linspace(1.0, 0.1, 5)[None].repeat(2, 1)
    g = torch.eye(4)[None].repeat(2, 1, 1)
    k = torch.tensor([[20.0, 0, 8], [0, 20.0, 4], [0, 0, 1]])[None].repeat(2, 1, 1)
    h_src_tgt, xyz_m, xyz_t = mr.streaming_matrices(disparity, g, inverse_3x3(k), k)
    assert h_src_tgt.shape == xyz_m.shape == (2, 5, 3, 3) and xyz_t.shape == (2, 3)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in (h_src_tgt, xyz_m, xyz_t))
    # the identity pose maps every target pixel to itself
    torch.testing.assert_close(h_src_tgt, torch.eye(3).expand(2, 5, 3, 3), rtol=1e-6, atol=1e-6)
