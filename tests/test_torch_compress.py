"""The port's compressed MPI representation against the JAX package's
(mine_tpu/serving/compress.py, mine_tpu/ops/mpi_render.py
plane_contributions), on the same seeded slabs.

Tolerances: the int8 quantization (q, lo, scale), its dequantization, the
bf16 cast, keep_mask, the pruning sigma scale and the wire blobs are held
bit for bit (the same fp32 operations in the same order, round half to
even); plane_contributions within 1e-6 (exp and cumprod are evaluated by two
libraries)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mine_tpu.ops.mpi_render import plane_contributions as jax_contributions
from mine_tpu.serving import compress as jc
from mine_tpu_torch.ops.mpi_render import plane_contributions
from mine_tpu_torch.serving import compress as tc

S, H, W = 6, 24, 32


def _k():
    return np.array([[[W / 2, 0, W / 2], [0, W / 2, H / 2], [0, 0, 1]]], np.float32)


def _mpi(seed: int = 0):
    """A seeded MPI with near-empty middle planes and an opaque blob."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (1, S, H, W, 3)).astype(np.float32)
    sigma = rng.uniform(0, 2, (1, S, H, W, 1)).astype(np.float32)
    sigma[:, 2:4] *= 1e-5
    sigma[:, 0, 8:14, 10:18] = 60.0
    disparity = np.linspace(1.0, 0.01, S, dtype=np.float32)[None]
    return rgb, sigma, disparity, _k()


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _np(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("slab", ["uniform", "constant_plane", "negative", "wide_range"])
def test_quantize_int8_is_bit_equal(slab):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (1, 5, 7, 9, 3)).astype(np.float32)
    if slab == "constant_plane":
        x[:, 2] = 0.37
    elif slab == "negative":
        x = x * 4.0 - 2.5
    elif slab == "wide_range":
        x[:, 1] *= 1e4
        x[:, 3] *= 1e-6
    want = jc._quantize_int8(x)
    got = tc._quantize_int8(torch.from_numpy(x))
    for g, w_, name in zip(got, want, ("q", "lo", "scale")):
        assert g.numpy().dtype == w_.dtype, name
        np.testing.assert_array_equal(g.numpy(), w_, err_msg=name)
    np.testing.assert_array_equal(tc._dequant_int8(*got).numpy(), jc._dequant_int8(*want))


def test_plane_contributions_with_dilation_match():
    """A plane hidden behind an opaque blob at the source pose survives
    through the dilated transmittance, as in JAX."""
    rgb, sigma, disp, k = _mpi()
    k_inv = np.linalg.inv(k).astype(np.float32)
    for dilate in (8, 0, 3):
        want = np.asarray(jax_contributions(jnp.asarray(sigma), jnp.asarray(disp),
                                            jnp.asarray(k_inv), vis_dilate_px=dilate))
        got = plane_contributions(*_t(sigma, disp, k_inv), vis_dilate_px=dilate).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"dilate {dilate}")
    assert want.shape == (S,)


@pytest.mark.parametrize("where", ["left_edge", "corner", "bottom_edge"])
def test_plane_contributions_at_the_border_match(where):
    """Opaque content at the image border: the max window's -inf padding
    must not leak into the in-image part of the window."""
    sigma = np.full((2, S, H, W, 1), 1e-4, np.float32)
    region = {"left_edge": (slice(4, 12), slice(0, 2)), "corner": (slice(0, 3), slice(0, 3)),
              "bottom_edge": (slice(H - 2, H), slice(5, 25))}[where]
    sigma[1, 1, region[0], region[1]] = 80.0
    sigma[0, 0, :, W - 1] = 30.0
    disp = np.stack([np.linspace(1.0, 0.05, S, dtype=np.float32)] * 2)
    k_inv = np.linalg.inv(np.concatenate([_k()] * 2)).astype(np.float32)
    want = np.asarray(jax_contributions(jnp.asarray(sigma), jnp.asarray(disp),
                                        jnp.asarray(k_inv)))
    got = plane_contributions(*_t(sigma, disp, k_inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_plane_contributions_alpha_mode_match():
    rng = np.random.default_rng(4)
    alpha = rng.uniform(0, 1, (1, S, H, W, 1)).astype(np.float32)
    disp = np.linspace(1.0, 0.01, S, dtype=np.float32)[None]
    k_inv = np.linalg.inv(_k()).astype(np.float32)
    want = np.asarray(jax_contributions(jnp.asarray(alpha), jnp.asarray(disp),
                                        jnp.asarray(k_inv), use_alpha=True))
    got = plane_contributions(*_t(alpha, disp, k_inv), use_alpha=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("eps", [1e-3, 0.2, 0.9, 2.0])
def test_keep_mask_and_prune_sigma_scale_match(eps):
    contrib = np.array([0.3, 1e-5, 0.0004, 0.25, 0.8, 1e-7])
    keep = tc.keep_mask(contrib, eps)
    np.testing.assert_array_equal(keep, jc.keep_mask(contrib, eps))
    assert keep.any()
    keep[-1] = True
    disp = np.linspace(1.0, 0.01, S, dtype=np.float32)[None]
    np.testing.assert_array_equal(tc._prune_sigma_scale(disp, keep),
                                  jc._prune_sigma_scale(disp, keep))


@pytest.mark.parametrize("use_alpha", [False, True])
@pytest.mark.parametrize("tier", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("prune_eps", [0.0, 1e-3])
def test_compressed_entries_and_wire_blobs_are_identical(tier, prune_eps, use_alpha):
    """compress_mpi on the same slabs gives the JAX package's entry bit for
    bit: the wire blobs are byte-equal, and decompress agrees."""
    rgb, sigma, disp, k = _mpi()
    if use_alpha:
        sigma = np.clip(sigma / 60.0, 0.0, 1.0)
    want = jc.compress_mpi(rgb, sigma, disp, k, (H, W, S), tier, prune_eps, use_alpha)
    got = tc.compress_mpi(*_t(rgb, sigma, disp, k), (H, W, S), tier, prune_eps, use_alpha)
    assert type(got).__name__ == type(want).__name__
    assert got.nbytes == want.nbytes
    assert tc.to_wire(got) == jc.to_wire(want)
    if isinstance(want, jc.CompressedMPI):
        assert got.planes_kept == want.planes_kept
        for a, b in zip(tc.decompress(got), jc.decompress(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if prune_eps and not use_alpha:
        assert want.planes_kept < S  # the near-empty planes went


@pytest.mark.parametrize("tier", ["fp32", "bf16", "int8"])
def test_wire_blobs_cross_parse(tier):
    """A blob from either package parses in the other, every field bit for
    bit, bf16 as its raw 16-bit words."""
    rgb, sigma, disp, k = _mpi(seed=1)
    jax_entry = jc.compress_mpi(rgb, sigma, disp, k, (H, W, S), tier, 1e-3)
    port_entry = tc.compress_mpi(*_t(rgb, sigma, disp, k), (H, W, S), tier, 1e-3)
    from_jax = tc.from_wire(jc.to_wire(jax_entry))
    from_port = jc.from_wire(tc.to_wire(port_entry))
    assert type(from_jax).__name__ == type(from_port).__name__ == "CompressedMPI"
    assert from_jax.tier == from_port.tier == tier
    assert from_jax.bucket == from_port.bucket == (H, W, S)
    for name, got in from_jax._arrays().items():
        want = jax_entry._arrays()[name]
        if want is None:
            assert got is None and from_port._arrays()[name] is None
            continue
        want = np.asarray(want)
        if tier == "bf16" and name in ("rgb", "sigma"):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(got), want.view(np.int16), err_msg=name)
            np.testing.assert_array_equal(from_port._arrays()[name].view(np.int16),
                                          _np(port_entry._arrays()[name]), err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            np.testing.assert_array_equal(from_port._arrays()[name],
                                          port_entry._arrays()[name].numpy(), err_msg=name)


def test_plain_fp32_entry_round_trips_as_an_mpi_entry():
    rgb, sigma, disp, k = _mpi(seed=2)
    tensors = _t(rgb, sigma, disp, k)
    entry = tc.compress_mpi(*tensors, (H, W, S))
    assert isinstance(entry, tc.MPIEntry) and entry.mpi_rgb is tensors[0]  # a no-op
    back = tc.from_wire(tc.to_wire(entry))
    assert isinstance(back, tc.MPIEntry) and back.bucket == (H, W, S)
    assert torch.equal(back.mpi_rgb, entry.mpi_rgb) and torch.equal(back.k, entry.k)
    j = jc.from_wire(tc.to_wire(entry))
    assert isinstance(j, jc.MPIEntry)
    np.testing.assert_array_equal(j.mpi_sigma, sigma)


def _blob():
    rgb, sigma, disp, k = _mpi()
    return tc.to_wire(tc.compress_mpi(*_t(rgb, sigma, disp, k), (H, W, S), "int8", 1e-3))


def _rewrite_header(blob: bytes, edit) -> bytes:
    magic = tc._WIRE_MAGIC
    n = int.from_bytes(blob[len(magic):len(magic) + 8], "little")
    header = json.loads(blob[len(magic) + 8:len(magic) + 8 + n])
    edit(header)
    head = json.dumps(header).encode()
    return magic + len(head).to_bytes(8, "little") + head + blob[len(magic) + 8 + n:]


@pytest.mark.parametrize("damage", [
    "empty", "bad_magic", "no_length", "huge_length", "truncated_header", "garbage_header",
    "truncated_field", "unknown_tier", "unknown_dtype", "missing_sidecar", "no_fields",
])
def test_garbage_and_truncated_blobs_raise_value_error(damage):
    blob = _blob()
    magic = tc._WIRE_MAGIC
    bad = {
        "empty": lambda: b"",
        "bad_magic": lambda: b"XXXXX\n" + blob[6:],
        "no_length": lambda: magic + b"\x01\x02",
        "huge_length": lambda: magic + (1 << 40).to_bytes(8, "little") + blob[14:],
        "truncated_header": lambda: blob[:40],
        "garbage_header": lambda: magic + (10).to_bytes(8, "little") + b"not json!!" + b"x" * 64,
        "truncated_field": lambda: blob[:-1],
        "unknown_tier": lambda: _rewrite_header(blob, lambda h: h.update(tier="fp16")),
        "unknown_dtype": lambda: _rewrite_header(
            blob, lambda h: h["fields"]["rgb"].update(dtype="complex64")),
        "missing_sidecar": lambda: _rewrite_header(
            blob, lambda h: h["fields"].pop("sigma_scale")),
        "no_fields": lambda: _rewrite_header(blob, lambda h: h.pop("fields")),
    }[damage]()
    with pytest.raises(ValueError):
        tc.from_wire(bad)


def test_bad_tier_is_refused():
    rgb, sigma, disp, k = _mpi()
    with pytest.raises(ValueError, match="unknown cache tier"):
        tc.compress_mpi(*_t(rgb, sigma, disp, k), (H, W, S), "fp16")
