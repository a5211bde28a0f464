"""Build identity for the /metrics page (the `git_rev` and `set_build_info`
part of mine_tpu/obs/ledger.py; the perf ledger itself is not ported yet).
"""

from __future__ import annotations

import os
import subprocess
from typing import Any

import torch


def git_rev() -> str | None:
    """The checkout's short HEAD revision, or None outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        )
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except Exception:  # noqa: BLE001 - evidence, not correctness
        return None


def set_build_info(registry: Any, backend: str | None = None) -> None:
    """Publish `mine_build_info{git_rev,torch_version,backend}` (value 1, the
    Prometheus info-metric idiom) on a metrics registry. `backend` is the
    engine's device type, "cuda" or "cpu". The JAX package's family carries
    jax_version where this one carries torch_version."""
    registry.gauge(
        "mine_build_info",
        "build/runtime identity (value is always 1; the labels are the "
        "payload): git revision, torch version, backend",
    ).set(1, git_rev=git_rev() or "unknown", torch_version=torch.__version__,
          backend=backend or "none")
