"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each `mine_tpu_torch/csrc/*.cu` is compiled on its own by `nvcc` for Hopper
(`sm_90a`) into `build/mine_tpu_torch/<hash>/lib<stem>.so` at the repository
root; all sources compile at once, one `nvcc` process each. The hash covers
every file in `csrc/` and the compiler flags, so an edited source builds anew
and an unchanged one is loaded as it is. The sources include no PyTorch
header: each exports plain C functions taking device pointers, sizes and the
CUDA stream, and returns `cudaGetLastError()` after its launch.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "mine_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """`nvcc` from PATH, else from the CUDA toolkit under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(candidate):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels are compiled at first use and need the CUDA toolkit"
        )
    return candidate


def source_hash() -> str:
    """Digest of every csrc file (name and bytes) and the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build_all(force: bool = False, ptxas_info: bool = False) -> dict[str, str]:
    """Compile every csrc/*.cu not yet built (all of them with `force`), one
    nvcc each, all started together. Returns {stem: nvcc's stderr}; with
    `ptxas_info` that holds each kernel's registers and spills. Raises
    RuntimeError with nvcc's stderr if any source fails to compile."""
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_info else ())
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists() and not force:
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        proc = subprocess.Popen(
            [nvcc_path(), *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((src, lib, tmp, proc))
    logs: dict[str, str] = {}
    failures = []
    for src, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        logs[src.stem] = out + err
        if proc.returncode != 0:
            failures.append(f"{src.name} (nvcc exit {proc.returncode}):\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return logs


def load(stem: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (built first if needed),
    with `argtypes` set from `signatures` and every entry point returning an
    int CUDA error code."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            path = BUILD_ROOT / source_hash() / f"lib{stem}.so"
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mine_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mine_cuda_error_string.restype = ctypes.c_char_p
            _loaded[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.mine_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
