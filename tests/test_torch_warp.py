"""The warp layer's plain versions (mine_tpu_torch/ops/kernels/warp.py)
against the JAX package's Pallas kernels run in interpret mode.

The plain versions are what the wrappers run on CPU tensors and what the
CUDA kernels are held against on the card (chip_smoke.py), so pinning them
to the Pallas semantics pins the kernels' contract. Scenes are those of
tests/test_pallas_warp.py: edge tiles (W not a lane multiple, Wo not a tile
multiple) and out-of-bounds coordinates (border clamp). Tolerance 1e-5:
the same arithmetic in fp32, summed in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mine_tpu.ops.grid_sample as gs
from mine_tpu.ops.pallas.warp import warp_bilinear_chw, warp_composite_chw
from mine_tpu_torch.ops.grid_sample import grid_sample_pixel
from mine_tpu_torch.ops.kernels import warp as kw

N, C, H, W = 2, 3, 24, 136
HO, WO = 16, 130


def _pallas(src_nchw, cx, cy):
    return np.asarray(warp_bilinear_chw(
        jnp.asarray(src_nchw), jnp.asarray(cx), jnp.asarray(cy), interpret=True
    ))


def _port(src_nchw, cx, cy):
    return kw.warp_bilinear(
        torch.from_numpy(src_nchw), torch.from_numpy(cx), torch.from_numpy(cy)
    ).numpy()


def test_warp_bilinear_matches_pallas(rng):
    src = rng.uniform(size=(N, C, H, W)).astype(np.float32)
    coords = rng.uniform(-5, 145, size=(N, HO, WO, 2)).astype(np.float32)
    cx, cy = coords[..., 0].copy(), coords[..., 1].copy()
    np.testing.assert_allclose(_port(src, cx, cy), _pallas(src, cx, cy),
                               rtol=1e-5, atol=1e-5)


def test_integer_and_border_coords_are_exact(rng):
    """Exact grid hits and exact border coords: the weights are exactly 0 or
    1, so the two must agree bit for bit."""
    h, w = 16, 128
    src = rng.uniform(size=(1, 1, h, w)).astype(np.float32)
    xs = np.array([0.0, 1.0, w - 2.0, w - 1.0, w / 2, -3.0, w + 4.0], np.float32)
    ys = np.array([0.0, 1.0, h - 2.0, h - 1.0, h / 2, -2.0, h + 1.0], np.float32)
    gx, gy = np.meshgrid(xs, ys)
    np.testing.assert_array_equal(_port(src, gx[None], gy[None]),
                                  _pallas(src, gx[None], gy[None]))


@pytest.mark.parametrize("h,w", [(1, 136), (24, 1), (1, 1)])
def test_one_pixel_axis(rng, h, w):
    """On a size-1 axis min(x, size-2) is -1: the out-of-image corner must
    contribute 0 while its weight is 0, leaving the one real pixel."""
    src = rng.uniform(size=(1, 2, h, w)).astype(np.float32)
    coords = rng.uniform(-3, 140, size=(1, 8, 20, 2)).astype(np.float32)
    cx, cy = coords[..., 0].copy(), coords[..., 1].copy()
    got = _port(src, cx, cy)
    np.testing.assert_allclose(got, _pallas(src, cx, cy), rtol=1e-5, atol=1e-5)
    want_xla = np.moveaxis(np.asarray(gs._grid_sample_xla(
        jnp.asarray(np.moveaxis(src, 1, -1)), jnp.asarray(coords))), -1, 1)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)


def test_grid_sample_pixel_matches_xla_path(rng):
    """The NHWC public op over the kernel layer, against the JAX package's
    XLA sampler (the path its grid_sample_pixel takes off the TPU)."""
    src = rng.uniform(size=(N, H, W, C)).astype(np.float32)
    coords = rng.uniform(-5, 145, size=(N, HO, WO, 2)).astype(np.float32)
    got = grid_sample_pixel(torch.from_numpy(src), torch.from_numpy(coords)).numpy()
    want = np.asarray(gs._grid_sample_xla(jnp.asarray(src), jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_sample_pixel_matches_torch_grid_sample(rng):
    """The identity the port relies on: torch's border-padded grid_sample on
    (p + 0.5) / (0.5 size) - 1 samples at pixel p. 1e-5: the normalisation
    round trip rounds."""
    src = rng.uniform(size=(N, H, W, C)).astype(np.float32)
    coords = rng.uniform(-5, 145, size=(N, HO, WO, 2)).astype(np.float32)
    got = grid_sample_pixel(torch.from_numpy(src), torch.from_numpy(coords))
    c = torch.from_numpy(coords)
    grid = torch.stack([(c[..., 0] + 0.5) / (0.5 * W) - 1.0,
                        (c[..., 1] + 0.5) / (0.5 * H) - 1.0], dim=-1)
    want = torch.nn.functional.grid_sample(
        torch.from_numpy(src).permute(0, 3, 1, 2), grid, mode="bilinear",
        padding_mode="border", align_corners=False,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_warp_composite_matches_pallas(rng):
    """The fused warp-composite's plain version against the Pallas kernel:
    border clamp, edge tiles, and negative z (behind-camera sigma mask)."""
    n, s, c, h, w = 1, 3, 4, 24, 136
    ho, wo = 16, 130
    src = rng.uniform(size=(n, s, c, h, w)).astype(np.float32)
    coords = rng.uniform(-5, 145, size=(n, s, ho, wo, 2)).astype(np.float32)
    dist = rng.uniform(0.05, 1.5, size=(n, s, ho, wo)).astype(np.float32)
    z = rng.uniform(-0.5, 3.0, size=(n, s, ho, wo)).astype(np.float32)
    cx, cy = coords[..., 0].copy(), coords[..., 1].copy()
    want = np.asarray(warp_composite_chw(
        jnp.asarray(src), jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(dist),
        jnp.asarray(z), interpret=True,
    ))
    got = kw.warp_composite_plain(*(torch.from_numpy(a) for a in (src, cx, cy, dist, z)))
    assert got.shape == (n, c + 3, ho, wo)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _composite_operands(n=1, s=2, h=8, w=16, rgb_channels=3):
    """warp_composite's operands: an MPI and near-identity plane matrices."""
    mats = torch.eye(3) + 0.01 * torch.rand(n, s, 3, 3)
    return (torch.rand(n, s, h, w, rgb_channels), torch.rand(n, s, h, w, 1), mats,
            mats.clone(), torch.rand(n, 3))


@pytest.mark.parametrize("stem", ["warp_composite", "warp_grad"])
def test_kernel_variants_still_apply_to_the_sources(stem):
    """Every variant of mine_tpu_torch.kernel_variants changes the shipped
    source it names (the study cannot silently time the shipped kernel)."""
    from mine_tpu_torch import kernel_variants as kv

    variants = kv.COMPOSITE_VARIANTS if stem == "warp_composite" else kv.GRAD_VARIANTS
    texts = [text for _, text in kv.variant_sources(stem, variants)]
    assert texts[0] == (kw.build.CSRC / f"{stem}.cu").read_text()
    assert len(set(texts)) == len(texts)


def test_cpu_tensors_take_the_plain_version(rng):
    kw.reset_launches()
    src = torch.rand(1, 4, 8, 16)
    cx, cy = torch.rand(1, 8, 16) * 16, torch.rand(1, 8, 16) * 8
    torch.testing.assert_close(kw.warp_bilinear(src, cx, cy),
                               kw.warp_bilinear_plain(src, cx, cy), rtol=0, atol=0)
    operands = _composite_operands()
    torch.testing.assert_close(kw.warp_composite(*operands),
                               kw.warp_composite_matrix_plain(*operands), rtol=0, atol=0)
    src.requires_grad_()
    kw.warp_bilinear(src, cx, cy).sum().backward()
    assert src.grad is not None
    assert kw.launches == {"warp_bilinear": 0, "warp_bilinear_grad": 0, "warp_composite": 0}


def test_wrappers_refuse_what_the_kernels_cannot_do():
    src = torch.rand(1, 4, 8, 16)
    cx, cy = torch.rand(1, 8, 16), torch.rand(1, 8, 16)
    rgb, *rest = _composite_operands()
    with pytest.raises(NotImplementedError, match="forward-only"):
        kw.warp_composite(rgb.requires_grad_(), *rest)
    with pytest.raises(ValueError, match="coords"):
        kw.warp_bilinear(torch.rand(1, 4, 8, 16), cx[0], cy[0])
    with pytest.raises(ValueError, match="mpi_rgb"):
        kw.warp_composite(*_composite_operands(rgb_channels=4))
    with pytest.raises(ValueError, match="no kernel"):
        kw.warp_bilinear(*(t.to("meta") for t in (torch.rand(1, 4, 8, 16), cx, cy)))
