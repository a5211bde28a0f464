"""Compressed MPI representation: quantized tiers + transmittance pruning
(the port's own copy of mine_tpu/serving/compress.py).

One representation with three consumers:

  the cache   `CompressedMPI` is an MPICache value whose `.nbytes` is the
              COMPRESSED byte count; the tier is part of every cache key, so
              fp32/bf16/int8 entries of one image never alias.
  the render  `decompress()` is dequant-on-render: the engine converts the
              resident slabs to fp32 per dispatch and pads the surviving
              planes up to a plane-count bucket (serving/engine.py), so
              pruning cuts render work as well as bytes.
  the wire    `to_wire`/`from_wire`: a self-describing byte format served
              over `GET /mpi/<key>`. It is the JAX package's format byte for
              byte: a blob from either package parses in the other.

Tiers:
  fp32   no transformation (with pruning off, `compress_mpi` returns the
         plain MPIEntry: the predict's own tensors, a numerics no-op)
  bf16   slabs stored as torch.bfloat16 (round to nearest even, as
         ml_dtypes' cast in the JAX package); on the wire the raw 16-bit
         words under the dtype string "bfloat16"
  int8   per-plane affine quantization of rgb and sigma:
         q = round((x - lo) / scale) - 128 as int8, with (lo, scale) per
         plane in fp32 and x ~ (q + 128) * scale + lo. The fp32 ops and
         torch.round's half-to-even give the q, lo and scale numpy gives on
         the same slab, on the CPU and on the card alike.

Pruning: `ops/mpi_render.py plane_contributions` gives each plane's maximum
compositing weight (parallax-dilated); planes that never reach `prune_eps`
are dropped, and the surviving disparities travel with the slabs. Each
survivor's sigma is rescaled by its old/new inter-plane gap ratio
(`_prune_sigma_scale`), so its transparency is unchanged at the source pose.
In sigma mode the last plane is always kept: its background
pseudo-distance is a constant that no scale could compensate.

Everything runs where the predict's tensors are (the card, or the CPU in
the tests); only the (S,) contribution vector and the disparities come to
the host to decide the keep set.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field

import numpy as np
import torch

from mine_tpu_torch.ops.geometry import inverse_3x3
from mine_tpu_torch.ops.kernels.warp import BG_DIST
from mine_tpu_torch.ops.mpi_render import plane_contributions
from mine_tpu_torch.serving.cache import MPIEntry, _nbytes

TIERS = ("fp32", "bf16", "int8")

# the recommended pruning threshold: a plane whose best pixel contributes
# under 0.1% of a ray's colour is invisible at 8-bit output depth
DEFAULT_PRUNE_EPS = 1e-3

_WIRE_MAGIC = b"MPIC1\n"
# wire dtype string -> (numpy dtype of the stored words, torch dtype)
_WIRE_DTYPES = {
    "float32": (np.float32, torch.float32),
    "int8": (np.int8, torch.int8),
    "bfloat16": (np.int16, torch.bfloat16),
}
_TORCH_TO_WIRE = {t: name for name, (_, t) in _WIRE_DTYPES.items()}


@dataclass
class CompressedMPI:
    """One compressed cached prediction: everything `decompress` needs to
    hand the render fp32 slabs.

    rgb/sigma hold the tier's storage dtype ((1, S_kept, H, W, 3/1)): fp32
    or bf16 directly, int8 beside per-plane (lo, scale) fp32 pairs.
    disparity is the SURVIVING planes' (1, S_kept). bucket is the engine
    shape bucket (H, W, S) the entry was predicted under; num_planes_full is
    the unpruned plane count (S + S_fine for a coarse-to-fine bucket, whose
    key keeps the coarse S), carried by the wire header.
    """

    tier: str
    rgb: torch.Tensor  # (1, S_kept, H, W, 3) storage dtype
    sigma: torch.Tensor  # (1, S_kept, H, W, 1) storage dtype
    disparity: torch.Tensor  # (1, S_kept) fp32
    k: torch.Tensor  # (1, 3, 3) fp32
    bucket: tuple[int, int, int]
    num_planes_full: int
    rgb_lo: torch.Tensor | None = None  # (1, S_kept, 1, 1, 1) fp32, int8 tier only
    rgb_scale: torch.Tensor | None = None
    sigma_lo: torch.Tensor | None = None
    sigma_scale: torch.Tensor | None = None
    nbytes: int = field(default=0)

    def __post_init__(self) -> None:
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r}; one of {TIERS}")
        if not self.nbytes:
            self.nbytes = sum(_nbytes(a) for a in self._arrays().values() if a is not None)

    @property
    def planes_kept(self) -> int:
        return int(self.disparity.shape[1])

    def _arrays(self) -> dict[str, torch.Tensor | None]:
        return {
            "rgb": self.rgb, "sigma": self.sigma,
            "disparity": self.disparity, "k": self.k,
            "rgb_lo": self.rgb_lo, "rgb_scale": self.rgb_scale,
            "sigma_lo": self.sigma_lo, "sigma_scale": self.sigma_scale,
        }


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-plane affine int8: (q, lo, scale) with x ~ (q + 128) * scale + lo.
    x: (1, S, H, W, C) fp32. lo/scale: (1, S, 1, 1, 1) fp32."""
    lo = torch.amin(x, dim=(2, 3, 4), keepdim=True)
    hi = torch.amax(x, dim=(2, 3, 4), keepdim=True)
    # a constant plane still round-trips exactly: scale 0 would divide by
    # zero, so floor it and let lo carry the value
    scale = torch.clamp_min((hi - lo) / 255.0, 1e-12)
    q = torch.clamp(torch.round((x - lo) / scale), 0.0, 255.0) - 128.0
    return q.to(torch.int8), lo, scale


def _dequant_int8(q: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q + 128) * scale + lo in fp32, one op at a time (no fused multiply-add)."""
    return (q.to(torch.float32) + 128.0) * scale + lo


def _prune_sigma_scale(disparity: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Per-surviving-plane sigma correction for pruning, (K,) fp32.

    The renderer derives each plane's distance from the disparity list it
    is given: dist_s(q) = (depth_next - depth_s) * ||K^-1 q|| (the last
    plane gets the background pseudo-distance). Dropping planes widens the
    gap of a kept plane in front of a pruned run, and its alpha = 1 -
    exp(-sigma dist) would grow. The ray norm cancels in the old/new gap
    ratio, so scaling the survivor's sigma by orig_gap / new_gap keeps its
    transparency at the source pose exactly. A plane that was last keeps the
    background slot on both sides (ratio 1)."""
    depth = 1.0 / np.asarray(disparity, np.float64).reshape(-1)  # (S,)
    s = depth.shape[0]
    orig_gap = np.empty(s, np.float64)
    orig_gap[:-1] = np.abs(depth[1:] - depth[:-1])
    orig_gap[-1] = BG_DIST
    kept = np.flatnonzero(keep)
    new_gap = np.empty(kept.shape[0], np.float64)
    new_gap[:-1] = np.abs(depth[kept[1:]] - depth[kept[:-1]])
    new_gap[-1] = BG_DIST
    return (orig_gap[kept] / np.maximum(new_gap, 1e-12)).astype(np.float32)


def keep_mask(contributions: np.ndarray, prune_eps: float) -> np.ndarray:
    """(S,) bool: planes whose max compositing weight reaches prune_eps. The
    best plane is always kept, so an all-transparent MPI degrades to its
    least-empty plane rather than to nothing."""
    contributions = np.asarray(contributions, np.float64)
    keep = contributions >= float(prune_eps)
    if not keep.any():
        keep[int(np.argmax(contributions))] = True
    return keep


@torch.no_grad()
def compress_mpi(mpi_rgb: torch.Tensor, mpi_sigma: torch.Tensor, disparity: torch.Tensor,
                 k: torch.Tensor, bucket: tuple[int, int, int], tier: str = "fp32",
                 prune_eps: float = 0.0, use_alpha: bool = False) -> MPIEntry | CompressedMPI:
    """Predict output -> cache value, on the predict's device. fp32 with
    pruning off, or with nothing to prune, returns the plain MPIEntry of the
    input tensors; anything else a CompressedMPI."""
    if tier not in TIERS:
        raise ValueError(f"unknown cache tier {tier!r}; one of {TIERS}")
    bucket = tuple(bucket)
    if tier == "fp32" and not prune_eps:
        return MPIEntry(mpi_rgb, mpi_sigma, disparity, k, bucket)
    rgb, sigma, disp = mpi_rgb, mpi_sigma, disparity
    if prune_eps:
        contrib = plane_contributions(mpi_sigma, disparity, inverse_3x3(k), use_alpha=use_alpha)
        keep = keep_mask(contrib.cpu().numpy(), prune_eps)
        if not use_alpha:
            keep[-1] = True  # the background slot (see _prune_sigma_scale)
        if not keep.all():
            idx = torch.from_numpy(np.flatnonzero(keep)).to(mpi_rgb.device)
            sigma = sigma[:, idx]
            if not use_alpha:
                scale = _prune_sigma_scale(disparity.cpu().numpy(), keep)
                sigma = sigma * torch.from_numpy(scale).to(sigma.device)[None, :, None, None, None]
            rgb, disp = rgb[:, idx], disp[:, idx]
        elif tier == "fp32":
            return MPIEntry(mpi_rgb, mpi_sigma, disparity, k, bucket)
    fields: dict[str, torch.Tensor] = {}
    if tier == "fp32":
        fields.update(rgb=rgb, sigma=sigma)
    elif tier == "bf16":
        fields.update(rgb=rgb.to(torch.bfloat16), sigma=sigma.to(torch.bfloat16))
    else:
        q_rgb, rgb_lo, rgb_scale = _quantize_int8(rgb)
        q_sigma, sigma_lo, sigma_scale = _quantize_int8(sigma)
        fields.update(rgb=q_rgb, sigma=q_sigma, rgb_lo=rgb_lo, rgb_scale=rgb_scale,
                      sigma_lo=sigma_lo, sigma_scale=sigma_scale)
    return CompressedMPI(tier=tier, disparity=disp, k=k, bucket=bucket,
                         num_planes_full=int(mpi_rgb.shape[1]), **fields)


def decompress(entry: CompressedMPI) -> tuple[torch.Tensor, ...]:
    """CompressedMPI -> (rgb fp32, sigma fp32, disparity, k), on the entry's
    device (the dequant is the render-path cost of the tier)."""
    if entry.tier == "int8":
        rgb = _dequant_int8(entry.rgb, entry.rgb_lo, entry.rgb_scale)
        sigma = _dequant_int8(entry.sigma, entry.sigma_lo, entry.sigma_scale)
    else:  # fp32 passthrough / bf16 upcast
        rgb, sigma = entry.rgb.to(torch.float32), entry.sigma.to(torch.float32)
    return rgb, sigma, entry.disparity, entry.k


# -- wire format ---------------------------------------------------------------
#
# One self-describing blob: magic, an 8-byte little-endian header length, a
# JSON header (tier, bucket, plane counts, and per-field shape/dtype), then
# the raw little-endian buffers in header order. A plain MPIEntry serializes
# as the fp32 tier.


def to_wire(entry: MPIEntry | CompressedMPI) -> bytes:
    """MPIEntry | CompressedMPI -> bytes (the GET /mpi/<key> body)."""
    if isinstance(entry, MPIEntry):
        entry = CompressedMPI(tier="fp32", rgb=entry.mpi_rgb, sigma=entry.mpi_sigma,
                              disparity=entry.disparity, k=entry.k,
                              bucket=tuple(entry.bucket),
                              num_planes_full=int(entry.mpi_rgb.shape[1]))
    # each field off the device once
    arrays = {n: a.detach().cpu().contiguous()
              for n, a in entry._arrays().items() if a is not None}
    header = {
        "tier": entry.tier,
        "bucket": list(entry.bucket),
        "num_planes_full": entry.num_planes_full,
        "fields": {name: {"shape": list(a.shape), "dtype": _TORCH_TO_WIRE[a.dtype]}
                   for name, a in arrays.items()},
    }
    buf = io.BytesIO()
    head = json.dumps(header).encode()
    buf.write(_WIRE_MAGIC)
    buf.write(len(head).to_bytes(8, "little"))
    buf.write(head)
    for name, a in arrays.items():
        words = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        buf.write(words.numpy().tobytes())
    return buf.getvalue()


def from_wire(data: bytes) -> MPIEntry | CompressedMPI:
    """bytes -> MPIEntry (fp32, full) | CompressedMPI, CPU tensors. A
    truncated or garbled blob raises ValueError."""
    if not data.startswith(_WIRE_MAGIC):
        raise ValueError("not an MPI wire blob (bad magic)")
    off = len(_WIRE_MAGIC)
    if len(data) < off + 8:
        raise ValueError("truncated MPI wire blob (no header length)")
    head_len = int.from_bytes(data[off:off + 8], "little")
    off += 8
    if head_len <= 0 or head_len > 1 << 20 or len(data) < off + head_len:
        raise ValueError("truncated MPI wire blob (bad header length)")
    try:
        header = json.loads(data[off:off + head_len])
        tier, specs = header["tier"], header["fields"]
        bucket = tuple(int(v) for v in header["bucket"])
        num_full = int(header["num_planes_full"])
        fields = {name: (tuple(int(v) for v in spec["shape"]), _WIRE_DTYPES[spec["dtype"]])
                  for name, spec in specs.items()}
    except (KeyError, TypeError, AttributeError) as exc:
        raise ValueError(f"malformed MPI wire header: {exc!r}") from None
    off += head_len
    if tier not in TIERS:
        raise ValueError(f"unknown wire tier {tier!r}")
    arrays: dict[str, torch.Tensor] = {}
    for name, (shape, (np_dtype, torch_dtype)) in fields.items():
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * np.dtype(np_dtype).itemsize
        if len(data) < off + nbytes:
            raise ValueError(f"truncated MPI wire blob (field {name})")
        words = np.frombuffer(data, dtype=np_dtype, count=count, offset=off).reshape(shape)
        arrays[name] = torch.from_numpy(words.copy()).view(torch_dtype)
        off += nbytes
    required = {"rgb", "sigma", "disparity", "k"}
    if tier == "int8":
        required |= {"rgb_lo", "rgb_scale", "sigma_lo", "sigma_scale"}
    missing = required - set(arrays)
    if missing:
        raise ValueError(f"MPI wire blob (tier {tier}) missing fields {sorted(missing)}")
    if tier == "fp32" and arrays["rgb"].shape[1] == num_full:
        return MPIEntry(arrays["rgb"], arrays["sigma"], arrays["disparity"], arrays["k"],
                        bucket)
    return CompressedMPI(tier=tier, bucket=bucket, num_planes_full=num_full,
                         rgb=arrays["rgb"], sigma=arrays["sigma"],
                         disparity=arrays["disparity"], k=arrays["k"],
                         rgb_lo=arrays.get("rgb_lo"), rgb_scale=arrays.get("rgb_scale"),
                         sigma_lo=arrays.get("sigma_lo"), sigma_scale=arrays.get("sigma_scale"))
