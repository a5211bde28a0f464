"""The port's MPI compositing against the JAX package at S=4, 16x136.

render_src and the dense target render hold at rtol = atol = 1e-5: the same
fp32 arithmetic with a different association of a few products. The
streaming render (coordinate prep + the fused warp-composite) is held
against the JAX package's own streaming reference (_render_tgt_scan, the
chunked scan its fused kernel is pinned to) and its dense render at 1e-4:
the over-composite sums planes in another order than the dense cumprod.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mine_tpu.ops.mpi_render as jmr
from mine_tpu.config import Config as JaxConfig
from mine_tpu.ops import inverse_3x3 as jinv
from mine_tpu_torch.config import Config
from mine_tpu_torch.ops import mpi_render as mr
from mine_tpu_torch.ops.geometry import inverse_3x3
from torch_threads import one_torch_thread  # noqa: F401

B, S, H, W = 1, 4, 16, 136


@pytest.fixture()
def scene(rng):
    rgb = rng.uniform(size=(B, S, H, W, 3)).astype(np.float32)
    sigma = rng.uniform(0.1, 2.0, size=(B, S, H, W, 1)).astype(np.float32)
    k = np.array([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1.0]]], np.float32)
    disparity = np.linspace(1.0, 0.1, S, dtype=np.float32)[None]
    g = np.eye(4, dtype=np.float32)[None]
    g[0, :3, 3] = [0.05, -0.02, 0.01]
    c, s = np.cos(0.03), np.sin(0.03)
    g[0, 0, 0], g[0, 0, 2], g[0, 2, 0], g[0, 2, 2] = c, s, -s, c
    return rgb, sigma, disparity, g, k


def _both(scene):
    rgb, sigma, disparity, g, k = scene
    j = [jnp.asarray(a) for a in (rgb, sigma, disparity, g)]
    t = [torch.from_numpy(a) for a in (rgb, sigma, disparity, g)]
    j_k, t_k = jnp.asarray(k), torch.from_numpy(k)
    return j + [jinv(j_k), j_k], t + [inverse_3x3(t_k), t_k]


def _close(got, want, tol, names):
    for g_, w_, name in zip(got, want, names):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("is_bg_depth_inf", [False, True])
def test_render_src_matches_jax(scene, is_bg_depth_inf):
    rgb, sigma, disparity, _, k = scene
    k_inv = jinv(jnp.asarray(k))
    want = jmr.render_src(jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(disparity),
                          k_inv, is_bg_depth_inf=is_bg_depth_inf)
    got = mr.render_src(torch.from_numpy(rgb), torch.from_numpy(sigma),
                        torch.from_numpy(disparity), torch.from_numpy(np.array(k_inv)),
                        is_bg_depth_inf=is_bg_depth_inf)
    # with an infinite background the depth adds (1 - weight sum) * 1000, so
    # a 1e-7 rounding difference in the weight sum is 1e-4 in depth
    _close(got, want, 1e-4 if is_bg_depth_inf else 1e-5,
           ["rgb", "depth", "transmittance", "weights"])


@pytest.mark.parametrize("use_alpha", [False, True])
def test_dense_render_matches_jax(scene, use_alpha):
    j, t = _both(scene)
    if use_alpha:  # alpha MPIs carry alpha in [0, 1] in the sigma slot
        j[1], t[1] = j[1] / 2.0, t[1] / 2.0
    want = jmr.render_tgt_rgb_depth(*j, use_alpha=use_alpha)
    got = mr.render_tgt_rgb_depth(*t, use_alpha=use_alpha)
    _close(got, want, 1e-5, ["rgb", "depth", "mask"])


def test_warp_mpi_to_tgt_matches_jax(scene):
    j, t = _both(scene)
    got = mr.warp_mpi_to_tgt(*t)
    want = jmr.warp_mpi_to_tgt(*j)
    _close(got[:3], want[:3], 1e-5, ["rgb", "sigma", "xyz"])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("is_bg_depth_inf", [False, True])
def test_streaming_render_matches_jax(scene, is_bg_depth_inf):
    j, t = _both(scene)
    got = mr.render_tgt_rgb_depth_streaming(*t, is_bg_depth_inf=is_bg_depth_inf)
    names = ["rgb", "depth", "mask"]
    _close(got, jmr._render_tgt_scan(*j, is_bg_depth_inf=is_bg_depth_inf), 1e-4, names)
    _close(got, jmr.render_tgt_rgb_depth(*j, is_bg_depth_inf=is_bg_depth_inf), 1e-4, names)


def test_streaming_render_masks_planes_behind_the_camera(scene):
    """A pose 0.5 forward puts the first planes (depth 1.0, 1.43) behind
    the target camera: their sigma must not composite, in either path."""
    rgb, sigma, disparity, g, k = scene
    g = g.copy()
    g[0, 2, 3] = -1.5
    j, t = _both((rgb, sigma, disparity, g, k))
    assert (np.asarray(jmr.warp_mpi_to_tgt(*j)[2])[..., 2] < 0).any()
    got = mr.render_tgt_rgb_depth_streaming(*t)
    _close(got, jmr.render_tgt_rgb_depth(*j), 1e-4, ["rgb", "depth", "mask"])


def test_compositor_from_config():
    assert mr.compositor_from_config(Config()) is mr.DENSE_COMPOSITOR
    streaming = Config().replace(**{"mpi.compositor": "streaming"})
    got = mr.compositor_from_config(streaming)
    assert got.render_tgt_rgb_depth.func is mr.render_tgt_rgb_depth_streaming
    assert got.render_src is mr.DENSE_COMPOSITOR.render_src  # only the target render streams
    assert got.render_tgt_rgb_depth.keywords == {"chunk_planes": 4}
    chunk8 = streaming.replace(**{"mpi.stream_chunk_planes": 8})
    assert mr.compositor_from_config(chunk8).render_tgt_rgb_depth.keywords == {"chunk_planes": 8}
    assert JaxConfig().mpi.compositor == Config().mpi.compositor
    assert JaxConfig().mpi.stream_chunk_planes == Config().mpi.stream_chunk_planes
    with pytest.raises(ValueError, match="dense"):
        mr.compositor_from_config(Config().replace(**{"mpi.compositor": "sparse"}))
    # alpha MPIs render through the chunked scan, as the dense compositor does
    args = (torch.full((1, 2, 8, 8, 3), 0.5), torch.full((1, 2, 8, 8, 1), 0.4), torch.ones(1, 2),
            torch.eye(4)[None], torch.eye(3)[None], torch.eye(3)[None])
    _close(mr.render_tgt_rgb_depth_streaming(*args, use_alpha=True),
           mr.render_tgt_rgb_depth(*args, use_alpha=True), 1e-6, ["rgb", "depth", "mask"])


@pytest.mark.parametrize("compositor", ["dense", "streaming"])
def test_render_novel_view_with_scale_factor_matches_jax(scene, compositor):
    """render_novel_view divides the pose translation by the scale factor,
    detached: the views agree with the JAX package's (1e-5 dense, 1e-4
    streaming, as above), and no gradient reaches the factor."""
    from mine_tpu.training.step import render_novel_view as jax_render_novel_view
    from mine_tpu_torch.training.step import render_novel_view

    j, t = _both(scene)
    sf = np.array([1.7], np.float32)
    jcfg = JaxConfig().replace(**{"mpi.compositor": compositor})
    cfg = Config().replace(**{"mpi.compositor": compositor})
    want = jax_render_novel_view(jcfg, *j, scale_factor=jnp.asarray(sf))
    t_sf = torch.from_numpy(sf).requires_grad_()
    t[0].requires_grad_()
    got = render_novel_view(cfg, *t, scale_factor=t_sf)
    names = ["tgt_imgs_syn", "tgt_disparity_syn", "tgt_mask_syn"]
    tol = 1e-5 if compositor == "dense" else 1e-4
    _close([got[n].detach() for n in names], [want[n] for n in names], tol, names)
    unscaled = render_novel_view(cfg, *(x.detach() for x in t))
    assert not np.allclose(unscaled["tgt_imgs_syn"].numpy(), got["tgt_imgs_syn"].detach().numpy())
    got["tgt_imgs_syn"].sum().backward()
    assert t_sf.grad is None and t[0].grad is not None
