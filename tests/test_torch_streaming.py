"""The streaming compositor's training backward (RenderTgtStreaming: the
warp-composite forward, then the chunked scan recomputed through the warp
and its backward) against the JAX package's custom_vjp _render_tgt_fused,
whose forward is the Pallas warp-composite kernel (run in interpret mode by
monkeypatching _FORCE_FUSED_INTERPRET, as tests/test_pallas_warp.py does)
and whose backward is the vjp of its chunked scan. Alpha MPIs take the scan
both ways in both packages (_render_tgt_scan).

Tolerances, the JAX package's own for this pair: the forward rtol = atol =
1e-5; the gradients with respect to rgb and sigma rtol 1e-4, atol 1e-5.
With an infinite background the depth adds (1 - weight sum) * 1000, which
turns the weight sum's fp32 rounding (two compositing orders) into 1e-4 of
depth: that depth is held at the JAX package's atol for it, 5e-4
(tests/test_mpi_render.py), and so is the sigma gradient, which carries the
same -1000 c_depth through the weight sum (measured 4.7e-5 here, against
7e-6 without the background term); the float64 comparison with the dense
render below holds that case at 1e-5. The edge-on pose yaws past half the field of
view, so the planes' vanishing line crosses the image; right at that line
the two packages' coordinate roundings can part by a few 1e-5
(tests/test_torch_composite.py), and this pose keeps its pixels off it.
Against the port's dense render (the warp through autograd, no chunks) the
gradients of every input, disparities and pose included, hold at 1e-5 as
the JAX package holds its scan against its dense render.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mine_tpu.ops.mpi_render as jmr
from mine_tpu.ops import inverse_3x3 as jinv
from mine_tpu_torch.ops import mpi_render as mr
from mine_tpu_torch.ops.geometry import inverse_3x3

H, W = 24, 40
CASES = {  # name: (B, S, chunk, (tx, ty, tz, yaw), is_bg_depth_inf, use_alpha)
    "gentle": (2, 8, 4, (0.05, -0.02, 0.01, 0.03), False, False),
    "gentle_bg_inf": (2, 8, 4, (0.05, -0.02, 0.01, 0.03), True, False),
    "s6_chunk4": (1, 6, 4, (0.08, 0.03, -0.05, 0.1), False, False),
    "edge_on": (1, 4, 2, (0.02, 0.0, 0.1, 1.05), False, False),
    "alpha": (2, 6, 2, (0.05, -0.02, 0.01, 0.03), False, True),
}


def _scene(name, seed=0):
    b, s, _, (tx, ty, tz, yaw), _, use_alpha = CASES[name]
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(b, s, H, W, 3)).astype(np.float32)
    hi = 0.9 if use_alpha else 3.0  # alpha MPIs carry alpha in [0, 1]
    sigma = rng.uniform(0.1, hi, size=(b, s, H, W, 1)).astype(np.float32)
    k = np.tile(np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1.0]], np.float32), (b, 1, 1))
    disparity = np.tile(np.linspace(1.0, 0.1, s, dtype=np.float32), (b, 1))
    g = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    c, sn = np.cos(yaw), np.sin(yaw)
    g[:, 0, 0], g[:, 0, 2], g[:, 2, 0], g[:, 2, 2] = c, sn, -sn, c
    g[:, :3, 3] = [tx, ty, tz]
    cot = (rng.normal(size=(b, H, W, 3)).astype(np.float32),
           rng.normal(size=(b, H, W, 1)).astype(np.float32))
    return (rgb, sigma, disparity, g, k), cot


def _jax_render(name, monkeypatch):
    """(forward outputs, d rgb, d sigma) of the JAX package's streaming
    render under the loss sum(rgb * c_rgb) + sum(depth * c_depth)."""
    _, _, chunk, _, bg_inf, use_alpha = CASES[name]
    (rgb, sigma, disparity, g, k), (c_rgb, c_depth) = _scene(name)
    k_inv = jinv(jnp.asarray(k))
    rest = (jnp.asarray(disparity), jnp.asarray(g), k_inv, jnp.asarray(k))
    if use_alpha:
        def render(r, sg):
            return jmr._render_tgt_scan(r, sg, *rest, use_alpha=True, is_bg_depth_inf=bg_inf,
                                        chunk_planes=chunk)
    else:
        monkeypatch.setattr(jmr, "_FORCE_FUSED_INTERPRET", True)

        def render(r, sg):
            return jmr._render_tgt_fused(r, sg, *rest, bg_inf, jmr._chunk_size(r.shape[1], chunk))

    def loss(r, sg):
        out_rgb, out_depth, _ = render(r, sg)
        return jnp.sum(out_rgb * c_rgb) + jnp.sum(out_depth * c_depth)

    out = render(jnp.asarray(rgb), jnp.asarray(sigma))
    grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(rgb), jnp.asarray(sigma))
    return [np.asarray(o) for o in out], [np.asarray(x) for x in grads]


def _port_render(name, dtype=torch.float32, requires=(True, True, False, False)):
    """(forward outputs, input leaves) of the port's streaming render with
    the same loss back-propagated."""
    _, _, chunk, _, bg_inf, use_alpha = CASES[name]
    (rgb, sigma, disparity, g, k), (c_rgb, c_depth) = _scene(name)
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(r)
              for a, r in zip((rgb, sigma, disparity, g), requires)]
    k_t = torch.from_numpy(k).to(dtype)
    out = mr.render_tgt_rgb_depth_streaming(*leaves, inverse_3x3(k_t), k_t, use_alpha=use_alpha,
                                            is_bg_depth_inf=bg_inf, chunk_planes=chunk)
    loss = torch.sum(out[0] * torch.from_numpy(c_rgb).to(dtype)) \
        + torch.sum(out[1] * torch.from_numpy(c_depth).to(dtype))
    loss.backward()
    return out, leaves


@pytest.mark.parametrize("name", sorted(CASES))
def test_streaming_render_and_grads_match_jax(monkeypatch, name):
    want_out, want_grads = _jax_render(name, monkeypatch)
    got_out, leaves = _port_render(name)
    bg_inf = CASES[name][4]
    for got, want, what in zip(got_out, want_out, ("rgb", "depth", "mask")):
        atol = 5e-4 if (bg_inf and what == "depth") else 1e-5
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=atol,
                                   err_msg=f"{name} {what}")
    for leaf, want, what in zip(leaves, want_grads, ("d_rgb", "d_sigma")):
        got = leaf.grad.numpy()
        assert np.isfinite(got).all(), f"{name} {what} is not finite"
        atol = 5e-4 if (bg_inf and what == "d_sigma") else 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=f"{name} {what}")


def test_scenes_reach_the_cases():
    """s6_chunk4 degrades to chunks of 3; edge_on has a homography whose
    third coordinate changes sign in the image and planes partly behind the
    target camera, so its last chunk meets the background guard beside
    clamped coordinates."""
    assert mr._chunk_size(6, 4) == 3
    (_, _, disparity, g, k), _ = _scene("edge_on")
    k_t = torch.from_numpy(k)
    xyz = mr.warp_mpi_to_tgt(torch.zeros(1, 4, H, W, 3), torch.zeros(1, 4, H, W, 1),
                             torch.from_numpy(disparity), torch.from_numpy(g),
                             inverse_3x3(k_t), k_t)[2]
    assert bool((xyz[..., 2] < 0).any()) and bool((xyz[..., 2] >= 0).any())
    h_src_tgt = mr.streaming_matrices(torch.from_numpy(disparity), torch.from_numpy(g),
                                      inverse_3x3(k_t), k_t)[0]
    hz = h_src_tgt[0, -1, 2, 0] * torch.arange(W)[None] + h_src_tgt[0, -1, 2, 1] \
        * torch.arange(H)[:, None] + h_src_tgt[0, -1, 2, 2]
    assert bool((hz < 0).any()) and bool((hz > 0).any())


@pytest.mark.parametrize("name", ["gentle", "gentle_bg_inf", "edge_on", "alpha"])
def test_streaming_grads_of_every_input_match_the_dense_render(name):
    """Disparities and pose too (the coordinate cotangent through the warp's
    backward), in float64 so that the comparison holds the math: 1e-5."""
    _, _, _, _, bg_inf, use_alpha = CASES[name]
    got_out, got = _port_render(name, torch.float64, requires=(True,) * 4)
    (rgb, sigma, disparity, g, k), (c_rgb, c_depth) = _scene(name)
    want = [torch.from_numpy(a).double().requires_grad_() for a in (rgb, sigma, disparity, g)]
    k_t = torch.from_numpy(k).double()
    out = mr.render_tgt_rgb_depth(*want, inverse_3x3(k_t), k_t, use_alpha=use_alpha,
                                  is_bg_depth_inf=bg_inf)
    (torch.sum(out[0] * torch.from_numpy(c_rgb).double())
     + torch.sum(out[1] * torch.from_numpy(c_depth).double())).backward()
    for a, b, what in zip(got_out, out, ("rgb", "depth", "mask")):
        torch.testing.assert_close(a, b.detach(), rtol=1e-5, atol=1e-5, msg=f"{name} {what}")
    for a, b, what in zip(got, want, ("d_rgb", "d_sigma", "d_disparity", "d_g")):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5, msg=f"{name} {what}")


def test_backward_keeps_nothing_of_plane_stack_size():
    """Every tensor autograd saves, in the forward and in the backward's
    recompute, is one of the inputs or at most one chunk's worth of planes:
    nothing the size of the (B, S, H, W) plane stack."""
    b, s, chunk = 2, 12, 2
    rng = np.random.default_rng(1)
    rgb = torch.from_numpy(rng.uniform(size=(b, s, H, W, 3)).astype(np.float32)).requires_grad_()
    sigma = torch.from_numpy(rng.uniform(0.1, 3.0, (b, s, H, W, 1)).astype(np.float32))
    sigma.requires_grad_()
    k = torch.tensor([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1.0]]).expand(b, 3, 3)
    g = torch.eye(4).repeat(b, 1, 1)
    g[:, :3, 3] = torch.tensor([0.05, -0.02, 0.01])
    disparity = torch.linspace(1.0, 0.1, s).expand(b, s)
    inputs = {t.data_ptr() for t in (rgb, sigma)}
    saved = []

    def pack(t):
        saved.append((t.numel(), t.data_ptr() in inputs))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = mr.render_tgt_rgb_depth_streaming(rgb, sigma, disparity, g, inverse_3x3(k), k,
                                                chunk_planes=chunk)
        n_forward = len(saved)
        (out[0].sum() + out[1].sum()).backward()
    assert n_forward > 0 and len(saved) > n_forward  # the recompute saved its own
    plane_stack = b * s * H * W
    chunk_payload = b * chunk * H * W * 4  # one chunk's rgb + sigma, warped
    assert chunk_payload < plane_stack
    too_big = [n for n, is_input in saved if not is_input and n > chunk_payload]
    assert not too_big, f"saved non-input tensors of {too_big} elements (stack {plane_stack})"
    assert rgb.grad.shape == rgb.shape and sigma.grad.shape == sigma.shape


def test_no_gradient_renders_with_one_kernel_call(monkeypatch):
    """Without a gradient to compute (serving, eval) a sigma MPI renders
    through one warp_composite call and no warp at all."""
    from mine_tpu_torch.ops.kernels import warp as kw

    calls = []
    monkeypatch.setattr(mr, "warp_composite", lambda *a: calls.append(1) or kw.warp_composite(*a))
    monkeypatch.setattr(mr, "warp_mpi_to_tgt", None)  # the scan must not run
    (rgb, sigma, disparity, g, k), _ = _scene("gentle")
    k_t = torch.from_numpy(k)
    args = [torch.from_numpy(a) for a in (rgb, sigma, disparity, g)] + [inverse_3x3(k_t), k_t]
    with torch.no_grad():
        args[0].requires_grad_()
        mr.render_tgt_rgb_depth_streaming(*args)
    args[0].requires_grad_(False)
    mr.render_tgt_rgb_depth_streaming(*args)
    assert calls == [1, 1]
