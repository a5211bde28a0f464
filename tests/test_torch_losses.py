"""The port's losses, metrics and loss-side ops against the JAX package's:
values and input gradients (torch.autograd against jax.grad) on the same
seeded numpy inputs, and the stratified disparity samplers on fed uniforms.

Each gradient is that of sum(f(x) * r) for a fixed random r, so functions
with array outputs are held over every output element. Tolerance: rtol
1e-4, atol 1e-6 of the largest value (1e-5 for the convolution-based SSIM
and smoothness terms): the same fp32 formulas, summed in other orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mine_tpu import ops as jops
from mine_tpu.losses import metrics as jmetrics
from mine_tpu.losses import smoothness as jsmooth
from mine_tpu.losses import ssim as jssim
from mine_tpu.ops import sampling as jsampling
from mine_tpu_torch.losses import metrics, smoothness
from mine_tpu_torch.losses.ssim import ssim
from mine_tpu_torch.ops import sampling
from mine_tpu_torch.ops.geometry import scale_intrinsics

B, H, W = 2, 20, 28


def _inputs(rng):
    img1 = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 0.1, img1.shape), 0, 1).astype(np.float32)
    disp = rng.uniform(0.05, 1.0, size=(B, H, W, 1)).astype(np.float32)
    pts = rng.uniform(0.05, 1.0, size=(B, 16, 1)).astype(np.float32)
    pts_gt = rng.uniform(0.05, 1.0, size=(B, 16, 1)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=(B,)).astype(np.float32)
    pxpy = rng.uniform(-3, W + 3, size=(B, 16, 2)).astype(np.float32)
    pxpy[0, :4] = [[2.5, 3.5], [3.5, 2.5], [0.5, 0.5], [W - 0.5, H - 1.5]]  # ties
    k = np.tile(np.array([[30.0, 0, 14], [0, 30.0, 10], [0, 0, 1]], np.float32), (B, 1, 1))
    return dict(img1=img1, img2=img2, disp=disp, pts=pts, pts_gt=pts_gt, scale=scale,
                pxpy=pxpy, k=k)


# (name, jax fn, port fn, input names, names differentiated, gradient atol scale)
CASES = [
    ("ssim", lambda a, b: jssim(a, b), lambda a, b: ssim(a, b), ("img1", "img2"), 2, 1e-5),
    ("ssim_per_image", lambda a, b: jssim(a, b, size_average=False),
     lambda a, b: ssim(a, b, size_average=False), ("img1", "img2"), 2, 1e-5),
    ("spatial_gradient_x", lambda a: jsmooth.spatial_gradient(a)[0],
     lambda a: smoothness.spatial_gradient(a)[0], ("img1",), 1, 1e-6),
    ("spatial_gradient_y_raw", lambda a: jsmooth.spatial_gradient(a, False)[1],
     lambda a: smoothness.spatial_gradient(a, False)[1], ("disp",), 1, 1e-6),
    ("edge_aware_loss", lambda a, d: jsmooth.edge_aware_loss(a, d, 0.8),
     lambda a, d: smoothness.edge_aware_loss(a, d, 0.8), ("img1", "disp"), 2, 1e-5),
    ("edge_aware_loss_per_image", lambda a, d: jsmooth.edge_aware_loss(a, d, 0.5, 0.2, False),
     lambda a, d: smoothness.edge_aware_loss(a, d, 0.5, 0.2, False), ("img1", "disp"), 2, 1e-5),
    ("edge_aware_loss_v2", jsmooth.edge_aware_loss_v2, smoothness.edge_aware_loss_v2,
     ("img1", "disp"), 2, 1e-5),
    ("psnr", jmetrics.psnr, metrics.psnr, ("img1", "img2"), 2, 1e-6),
    ("psnr_per_image", lambda a, b: jmetrics.psnr(a, b, False),
     lambda a, b: metrics.psnr(a, b, False), ("img1", "img2"), 2, 1e-6),
    ("compute_scale_factor", jmetrics.compute_scale_factor, metrics.compute_scale_factor,
     ("pts", "pts_gt"), 2, 1e-6),
    ("log_disparity_loss", jmetrics.log_disparity_loss, metrics.log_disparity_loss,
     ("pts", "pts_gt", "scale"), 3, 1e-6),
    ("gather_pixel_by_pxpy", jsampling.gather_pixel_by_pxpy, sampling.gather_pixel_by_pxpy,
     ("disp", "pxpy"), 1, 1e-6),
    ("scale_intrinsics_2", lambda k: jops.scale_intrinsics(k, 2),
     lambda k: scale_intrinsics(k, 2), ("k",), 1, 1e-6),
]


@pytest.mark.parametrize("name,jfn,tfn,names,n_diff,gtol", CASES, ids=[c[0] for c in CASES])
def test_value_and_input_gradients_match_jax(rng, name, jfn, tfn, names, n_diff, gtol):
    data = _inputs(rng)
    args = [data[n] for n in names]
    want = np.asarray(jfn(*map(jnp.asarray, args)))
    r = rng.normal(size=want.shape).astype(np.float32)

    def jax_scalar(*diff):
        return jnp.sum(jfn(*diff, *map(jnp.asarray, args[n_diff:])) * r)

    want_grads = jax.grad(jax_scalar, argnums=tuple(range(n_diff)))(
        *map(jnp.asarray, args[:n_diff]))
    t_args = [torch.from_numpy(a.copy()) for a in args]
    for t in t_args[:n_diff]:
        t.requires_grad_()
    got = tfn(*t_args)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=name)
    torch.sum(got * torch.from_numpy(r)).backward()
    for i, (t, wg) in enumerate(zip(t_args[:n_diff], want_grads)):
        wg = np.asarray(wg)
        np.testing.assert_allclose(t.grad.numpy(), wg, rtol=1e-4,
                                   atol=gtol * max(1.0, float(np.abs(wg).max())),
                                   err_msg=f"{name} d/d{names[i]}")


def test_gather_rounds_half_to_even(rng):
    """Ties at .5 round to the even index, as jnp.round: 2.5 -> 2, 3.5 -> 4."""
    img = torch.arange(5 * 6, dtype=torch.float32).reshape(1, 5, 6, 1)
    got = sampling.gather_pixel_by_pxpy(img, torch.tensor([[[2.5, 3.5], [0.5, 1.5]]]))
    assert got.flatten().tolist() == [4 * 6 + 2, 2 * 6 + 0]


def test_instance_norm_uses_the_biased_variance(rng):
    """jnp.var is biased; torch.var is not by default. On a 2x2 map the two
    differ by 4/3, which the port must not show."""
    x = rng.uniform(size=(1, 2, 2, 1)).astype(np.float32)
    got = smoothness._instance_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsmooth._instance_norm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("edges", [None, (1.0, 0.6, 0.3, 0.1, 0.05)], ids=["linspace", "bins"])
def test_stratified_samplers_match_jax_on_fed_uniforms(rng, edges):
    """The same (B, S) uniforms through both packages' samplers (the JAX
    draws its own from a key; its arithmetic is fed the port's numbers by
    monkeypatching its uniform source)."""
    b, s = 3, 4
    u = rng.uniform(size=(b, s)).astype(np.float32)
    original = jsampling._stratified_uniform
    try:
        jsampling._stratified_uniform = lambda key, bs, nb: jnp.asarray(u)
        if edges is None:
            want = jsampling.uniform_disparity_from_linspace_bins(None, b, s, 1.0, 0.001)
            got = sampling.uniform_disparity_from_linspace_bins(
                b, s, 1.0, 0.001, uniforms=torch.from_numpy(u))
        else:
            want = jsampling.uniform_disparity_from_bins(None, b, jnp.asarray(edges))
            got = sampling.uniform_disparity_from_bins(b, edges, uniforms=torch.from_numpy(u))
    finally:
        jsampling._stratified_uniform = original
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert bool(torch.all(got[:, :-1] > got[:, 1:]))


def test_stratified_rows_do_not_depend_on_the_batch_size():
    """One draw of S uniforms per row, in row order: row i is the same in a
    batch of 2 and a batch of 5."""
    small = sampling.uniform_disparity_from_linspace_bins(
        2, 8, 1.0, 0.001, generator=torch.Generator().manual_seed(3))
    large = sampling.uniform_disparity_from_linspace_bins(
        5, 8, 1.0, 0.001, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(small, large[:2], rtol=0, atol=0)
    assert not torch.equal(large[0], large[1])
