"""Variants of the warp-composite and warp-backward kernels, built and timed
side by side on one card: the measurements behind their design constants.

    python -m mine_tpu_torch.kernel_variants

From the root of a checkout, on a machine with a CUDA device and nvcc. Each
variant is csrc/warp_composite.cu or csrc/warp_grad.cu with one design
choice changed by a text substitution, compiled by nvcc (all at once) into
build/kernel_variants/, loaded with ctypes and launched through the same C
entry point as the shipped kernel. The inputs are chip_smoke.py's: the
warp-composite at S=32, 384x512 at two poses; the backward at
(128, 4, 384, 512) on 128 real planes, once as they are and once with
chip_smoke.py's band of random far-out coordinates. Every variant but the
decompositions is held against the plain version (1e-5; the backward at
1e-5 of max |grad_src|). The decompositions drop the shared-memory atomics
or the global ones, give wrong sums by design, and only split the time.
Each result line is JSON with the card's name and power limit, and names
the atomic instructions nvcc emitted.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from mine_tpu_torch.ops.kernels import build
from mine_tpu_torch.ops.kernels import warp as kw

OUT = build.BUILD_ROOT.parent / "kernel_variants"

# (name, substitutions); the first of each list is the shipped source
_K5_LANES = "constexpr int kLanes = 2;"
_K5_THREADS = "constexpr int kThreads = 128;"
COMPOSITE_VARIANTS = [
    ("shipped: 2 lanes, 128 threads", []),
    ("1 lane", [(_K5_LANES, "constexpr int kLanes = 1;")]),
    ("4 lanes", [(_K5_LANES, "constexpr int kLanes = 4;")]),
    ("8 lanes", [(_K5_LANES, "constexpr int kLanes = 8;")]),
    ("2 lanes, 256 threads", [(_K5_THREADS, "constexpr int kThreads = 256;")]),
]
_K2_TILE = "constexpr int kTileW = 64, kTileH = 4;"
_K2_SHARED_ADDS = [
    (f"if (t.v{k}) atomicAdd(tp + {o}, gv * w{k});", f"if (t.v{k}) tp[{o}] += gv * w{k};")
    for k, o in (("00", "t00"), ("01", "t00 + 1"), ("10", "t00 + bw"), ("11", "t00 + bw + 1"))
]
_K2_FLUSH = [("if (v != 0.0f) atomicAdd(dst + col, v);", "dst[col] = v;")]
GRAD_VARIANTS = [
    ("shipped: 64x4 tiles, 24 KB", []),
    ("32x8 tiles", [(_K2_TILE, "constexpr int kTileW = 32, kTileH = 8;")]),
    ("128x2 tiles", [(_K2_TILE, "constexpr int kTileW = 128, kTileH = 2;")]),
    ("12 KB tile budget", [("constexpr int kTileBytes = 24 * 1024;",
                            "constexpr int kTileBytes = 12 * 1024;")]),
    ("decomposition: plain shared adds", _K2_SHARED_ADDS),
    ("decomposition: plain-store flush", _K2_FLUSH),
    ("decomposition: both", _K2_SHARED_ADDS + _K2_FLUSH),
]


def variant_sources(stem: str, variants: list) -> list[tuple[str, str]]:
    """(name, source text) of each variant of csrc/<stem>.cu; raises if a
    substitution no longer matches the source."""
    base = (build.CSRC / f"{stem}.cu").read_text()
    out = []
    for name, subs in variants:
        text = base
        for old, new in subs:
            if old not in text:
                raise ValueError(f"{stem} variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        out.append((name, text))
    return out


def _build(jobs: list[tuple[tuple[str, str], str]]) -> dict[tuple[str, str], ctypes.CDLL]:
    """Compile every (key, source text) at once; returns {key: library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = []
    for i, (key, text) in enumerate(jobs):
        src = OUT / f"variant{i}.cu"
        src.write_text(text)
        lib = OUT / f"libvariant{i}.so"
        procs.append((key, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key!r} failed to build:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _atomics(lib: ctypes.CDLL) -> list[str]:
    """The atomic SASS instructions in a library, from cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True).stdout
    return sorted(set(re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED)\.[A-Z0-9._]+)", sass)))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from chip_smoke import card, emit, plane_coords, pose, time_cuda_ms
    from mine_tpu_torch.inference.video import fov_intrinsics
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.homography import homography_sample_coords
    from mine_tpu_torch.ops.mpi_render import streaming_matrices

    info = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    libs = _build(
        [(("warp_composite", name), text)
         for name, text in variant_sources("warp_composite", COMPOSITE_VARIANTS)]
        + [(("warp_grad", name), text)
           for name, text in variant_sources("warp_grad", GRAD_VARIANTS)])
    stream = torch.cuda.current_stream().cuda_stream

    h, w, s = 384, 512, 32
    k_cam = torch.from_numpy(np.array(
        [[w / 2, 0, w / 2], [0, w / 2, h / 2], [0, 0, 1]], np.float32))[None].to(dev)
    disparity = torch.linspace(1.0, 0.001, s, device=dev)[None]
    mpi = (torch.rand((1, s, h, w, 3), generator=gen, device=dev),
           torch.rand((1, s, h, w, 1), generator=gen, device=dev) * 4.0)
    for label, g in (("planes behind the camera", pose(0.1, -0.05, -1.5)),
                     ("swing", pose(0.15, 0.05, 0.05))):
        ops = (*mpi, *streaming_matrices(disparity, torch.from_numpy(g)[None].to(dev),
                                         inverse_3x3(k_cam), k_cam))
        want = kw.warp_composite_matrix_plain(*ops)
        out = torch.empty_like(want)
        for name, _ in COMPOSITE_VARIANTS:
            fn = libs["warp_composite", name].mine_warp_composite_f32
            fn.argtypes = kw._SIGNATURES["warp_composite"]["mine_warp_composite_f32"]

            def launch(fn=fn):
                fn(*(t.data_ptr() for t in ops), out.data_ptr(), 1, s, h, w, stream)

            launch()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if not torch.allclose(out, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"warp_composite variant {name!r}: max abs err {err}")
            emit(info, kernel="warp_composite", variant=name, pose=label, ms=time_cuda_ms(launch),
                 max_abs_err=err, atomics=_atomics(libs["warp_composite", name]))

    n = 128
    g_test = pose(0.08, -0.04, 0.15)
    k = torch.from_numpy(fov_intrinsics(h, w))[None].to(dev).expand(n, 3, 3)
    xy, _ = homography_sample_coords(
        1.0 / torch.linspace(1.0, 0.001, n, device=dev),
        torch.from_numpy(g_test)[None].to(dev).expand(n, 4, 4), inverse_3x3(k), k, h, w)
    coords = {"real planes": (xy[..., 0].contiguous(), xy[..., 1].contiguous()),
              "real planes + random band": plane_coords(h, w, n, g_test, dev, gen)}
    g = torch.randn((n, 4, h, w), generator=gen, device=dev)
    src = torch.rand((n, 4, h, w), generator=gen, device=dev)
    grad = torch.zeros_like(g)
    grad_xy = torch.zeros((2, n, h, w), device=dev)
    paths = torch.zeros(2, dtype=torch.int64, device=dev)
    for label, (cx, cy) in coords.items():
        want = kw.warp_bilinear_grad_plain(g, cx, cy, h, w)[0]
        atol = 1e-5 * want.abs().max().item()
        for name, _ in GRAD_VARIANTS:
            fn = libs["warp_grad", name].mine_warp_bilinear_grad_f32
            fn.argtypes = kw._SIGNATURES["warp_grad"]["mine_warp_bilinear_grad_f32"]

            def launch(with_coords: bool, fn=fn):
                grad.zero_()  # as the wrapper's torch.zeros
                fn(g.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                   src.data_ptr() if with_coords else None, grad.data_ptr(),
                   grad_xy[0].data_ptr() if with_coords else None,
                   grad_xy[1].data_ptr() if with_coords else None,
                   n, 4, h, w, h, w, paths.data_ptr(), stream)

            paths.zero_()
            launch(False)
            blocks = paths.tolist()
            err = (grad - want).abs().max().item()
            checked = not name.startswith("decomposition")
            if checked and not torch.allclose(grad, want, rtol=1e-5, atol=atol):
                raise AssertionError(f"warp_grad variant {name!r}: max abs err {err}")
            emit(info, kernel="warp_bilinear_grad", variant=name, coords=label,
                 ms=time_cuda_ms(lambda: launch(False)),
                 with_coords_ms=time_cuda_ms(lambda: launch(True)),
                 blocks_shared_direct=blocks, max_abs_err=err, checked=checked,
                 atomics=_atomics(libs["warp_grad", name]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
