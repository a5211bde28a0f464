"""The port's geometry and homography coordinates against the JAX package.

Sample coordinates must agree to atol 1e-4 px, rtol 1e-5: both compute the
closed-form inverse and the 3x3-against-grid products in fp32, but may
associate the 3x3 chain product differently, which moves a coordinate near
x = 500 by ~1e-5 px.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mine_tpu.ops import geometry as jgeo
from mine_tpu.ops import homography as jhom
from mine_tpu_torch.ops import geometry, homography
from torch_threads import one_torch_thread  # noqa: F401


def _rotation(rng, max_angle: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(-max_angle, max_angle)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _cameras(rng, b: int, h: int, w: int):
    g = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i in range(b):
        g[i, :3, :3] = _rotation(rng, 0.1)
        g[i, :3, 3] = rng.uniform(-0.2, 0.2, 3)
    f = rng.uniform(0.8, 1.2, b) * w
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0], k[:, 1, 1] = f, f
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = w / 2, h / 2, 1.0
    depth = rng.uniform(1.0, 50.0, b).astype(np.float32)
    return g, k, depth


def test_inverse_3x3_matches_jax(rng):
    m = (rng.normal(size=(16, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    got = geometry.inverse_3x3(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgeo.inverse_3x3(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m @ got, np.broadcast_to(np.eye(3), m.shape), atol=1e-5)


def test_homogeneous_pixel_grid_matches_jax():
    np.testing.assert_array_equal(geometry.homogeneous_pixel_grid(5, 7).numpy(),
                                  np.asarray(jgeo.homogeneous_pixel_grid(5, 7)))


@pytest.mark.parametrize("h,w", [(24, 40), (384, 512)])
def test_homography_sample_coords_match_jax(rng, h, w):
    g, k, depth = _cameras(rng, 6, h, w)
    k_inv = np.array(jgeo.inverse_3x3(jnp.asarray(k)))
    want_xy, want_valid = jhom.homography_sample_coords(
        jnp.asarray(depth), jnp.asarray(g), jnp.asarray(k_inv), jnp.asarray(k), h, w
    )
    got_xy, got_valid = homography.homography_sample_coords(
        *(torch.from_numpy(a) for a in (depth, g, k_inv, k)), h, w
    )
    want_xy = np.asarray(want_xy)
    np.testing.assert_allclose(got_xy.numpy(), want_xy, rtol=1e-5, atol=1e-4)
    # the validity mask agrees wherever a coordinate is not within the
    # coordinate tolerance of the open interval's ends
    near = np.zeros(want_xy.shape[:-1], bool)
    for axis, size in ((0, w), (1, h)):
        c = want_xy[..., axis]
        near |= (np.abs(c + 1.0) < 1e-3) | (np.abs(c - size) < 1e-3)
    np.testing.assert_array_equal(got_valid.numpy()[~near], np.asarray(want_valid)[~near])
    assert near.mean() < 1e-3


def test_validity_mask_is_the_open_interval():
    """A one-pixel shift puts target column 0 at source x = -1 exactly and
    the last column at x = w - 2; target width w + 2 reaches x = w exactly.
    Both ends of (-1, W) are excluded, in both packages."""
    h, w = 6, 10
    g = np.eye(4, dtype=np.float32)[None]
    g[0, 0, 3] = 1.0  # x_tgt = x_src + 1 at depth 1 with K = I
    k = np.eye(3, dtype=np.float32)[None]
    depth = np.ones(1, np.float32)
    args = (depth, g, k, k)
    got_xy, got_valid = homography.homography_sample_coords(
        *(torch.from_numpy(a) for a in args), h, w, tgt_height=h, tgt_width=w + 2
    )
    want_xy, want_valid = jhom.homography_sample_coords(
        *(jnp.asarray(a) for a in args), h, w, tgt_height=h, tgt_width=w + 2
    )
    np.testing.assert_array_equal(got_xy.numpy(), np.asarray(want_xy))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got_xy[0, 0, 0, 0] == -1.0 and got_xy[0, 0, w + 1, 0] == w
    assert not got_valid[0, :, 0].any() and not got_valid[0, :, w + 1].any()
    assert got_valid[0, :, 1:w + 1].all()


def test_perspective_divide_guard():
    """A (non-rigid) plane map whose inverse has third row (1/8, 0, -1): the
    homogeneous z is exactly 0 at target column 8 and crosses zero there.
    The guard must push |z| < 1e-8 to +-1e-8 (finite, far out of bounds,
    invalid), exactly as the JAX package does."""
    h, w = 4, 16
    g = np.eye(4, dtype=np.float32)[None]
    g[0, 2, :] = [0.125, 0.0, 0.0, -1.0]
    k = np.eye(3, dtype=np.float32)[None]
    depth = np.ones(1, np.float32)
    args = (depth, g, k, k)
    got_xy, got_valid = homography.homography_sample_coords(
        *(torch.from_numpy(a) for a in args), h, w
    )
    want_xy, want_valid = jhom.homography_sample_coords(
        *(jnp.asarray(a) for a in args), h, w
    )
    got_xy = got_xy.numpy()
    assert np.isfinite(got_xy).all()
    np.testing.assert_allclose(got_xy, np.asarray(want_xy), rtol=1e-6)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got_xy[0, 0, 8, 0] == pytest.approx(8.0 / 1e-8, rel=1e-6)
    assert not got_valid[0, :, 8].any()
