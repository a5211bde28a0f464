"""Append-only perf ledger and build identity (the port's own copy of
mine_tpu/obs/ledger.py).

One JSONL file (default `perf_ledger.jsonl`, override or disable through
$MINE_TPU_PERF_LEDGER, the variable the JAX package reads) collects one row
per bench measurement:

  ts, git_rev, metric, value, unit, config_digest (what workload),
  device + backend_class (what hardware), torch_version, and the perf
  vitals (mfu, step_ms, peak_hbm_bytes, p50_ms/p95_ms) where they exist.

A row the port writes names its card as `device` (torch.cuda.get_device_name,
e.g. "NVIDIA H100 80GB HBM3"; the host's processor on the CPU) and `cuda` or
`cpu` as its backend, so `stream_key` never grades a port row against a JAX
row (a TPU or XLA:CPU device kind), even in one shared file. Where a JAX row
carries jax_version, a port row carries torch_version.

`check` compares each (metric, config_digest, device, backend_class,
mesh_shape) stream's NEWEST row against the median of its prior rows (the
rolling baseline) and flags a regression when the newest value moves beyond
`threshold` in the bad direction (`python -m mine_tpu_torch.tools.perf_ledger
check`). Fewer than `min_history` prior rows: the stream is skipped, never
failed. The aux fields of AUX_METRICS are checked in their own direction
when the newest row and its history carry them.

Rows are one JSON object per line, appended in a single write, so that
concurrent writers interleave whole lines. A malformed line (a killed
writer) is skipped and counted, never a crash: the ledger is an instrument.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import sys
import time
from statistics import median
from typing import Any

import torch

DEFAULT_LEDGER = "perf_ledger.jsonl"
LEDGER_ENV = "MINE_TPU_PERF_LEDGER"

# aux metrics checked alongside `value` when both the newest row and its
# history carry them; value: higher_is_better
AUX_METRICS: dict[str, bool] = {
    "p95_ms": False,
    "peak_hbm_bytes": False,
    # the compressed-MPI fleet economics: cache entries the byte budget
    # holds per GiB and the hit rate they buy
    "cache_entries_per_gib": True,
    "cache_hit_rate": True,
}


def ledger_path() -> str | None:
    """The ledger file benches append to: $MINE_TPU_PERF_LEDGER wins
    ("0"/"off"/"none"/"false" or empty disables), else ./perf_ledger.jsonl."""
    env = os.environ.get(LEDGER_ENV)
    if env is not None:
        if env.strip().lower() in ("", "0", "off", "none", "false"):
            return None
        return env
    return DEFAULT_LEDGER


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


def device_fields(device: str | torch.device) -> dict[str, str]:
    """`device` and `backend` of a row measured on `device`: the card's
    name and "cuda", or the host's processor and "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev), "backend": "cuda"}
    return {"device": platform.processor() or platform.machine() or "unknown",
            "backend": dev.type}


def config_digest(workload: dict[str, Any]) -> str:
    """Short stable digest of the workload knobs that make two rows
    comparable (shape, batch, planes, ...; not the measured values)."""
    blob = json.dumps(workload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def backend_class(backend_note: str | None) -> str:
    """'cpu (degraded: ...)' and 'cpu (forced)' are the same hardware
    class; comparisons key on the class, not the prose."""
    if not backend_note:
        return "unknown"
    return str(backend_note).split()[0].split("(")[0] or "unknown"


def make_row(
    metric: str,
    value: float | None,
    workload: dict[str, Any],
    unit: str = "",
    higher_is_better: bool = True,
    **fields: Any,
) -> dict:
    """One ledger row; extra perf vitals ride along as plain fields."""
    row = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_rev": git_rev(),
        "metric": metric,
        "value": value,
        "unit": unit,
        "higher_is_better": bool(higher_is_better),
        "config_digest": config_digest(workload),
        "workload": workload,
        "torch_version": torch.__version__,
    }
    row.update({k: v for k, v in fields.items() if v is not None})
    row["backend_class"] = backend_class(row.get("backend"))
    return row


def append(path: str, row: dict) -> dict:
    """Append one row in a single write (O_APPEND). Returns the row."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    line = json.dumps(row, sort_keys=True)
    with open(path, "a") as fh:
        fh.write(line + "\n")
    return row


def read(path: str) -> tuple[list[dict], int]:
    """(rows, malformed-line count); a missing file reads as empty."""
    rows: list[dict] = []
    bad = 0
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                if isinstance(row, dict) and "metric" in row:
                    rows.append(row)
                else:
                    bad += 1
    except FileNotFoundError:
        pass
    return rows, bad


def stream_key(row: dict) -> tuple:
    """(metric, workload digest, device, backend class, mesh shape): two
    rows are comparable only when all agree. `mesh_shape` is the 'DxFxP'
    string (parallel/mesh.py mesh_shape_str); writers omit it for
    one-device runs."""
    return (
        row.get("metric"),
        row.get("config_digest"),
        row.get("device"),
        row.get("backend_class", backend_class(row.get("backend"))),
        row.get("mesh_shape"),
    )


def rolling_baseline(
    history: list[dict], field: str = "value", window: int = 5
) -> float | None:
    """Median of the last `window` numeric `field` values in `history`
    (file order, oldest first)."""
    vals = [row[field] for row in history
            if isinstance(row.get(field), (int, float))]
    if not vals:
        return None
    return float(median(vals[-int(window):]))


def _verdict_for(
    name: str, newest: float, baseline: float, higher_is_better: bool,
    threshold: float,
) -> dict:
    if baseline == 0:
        delta = 0.0
    elif higher_is_better:
        delta = (baseline - newest) / abs(baseline)
    else:
        delta = (newest - baseline) / abs(baseline)
    return {
        "field": name,
        "value": newest,
        "baseline": baseline,
        "vs_baseline": round(newest / baseline, 4) if baseline else None,
        "regression_delta": round(delta, 4),
        "regressed": delta > threshold,
    }


def check_rows(
    rows: list[dict],
    threshold: float = 0.10,
    window: int = 5,
    min_history: int = 2,
) -> dict:
    """The newest row of every comparable stream against its rolling
    baseline: {"ok", "checked", "skipped", "regressions", ...}; ok when no
    checked field regressed beyond `threshold`."""
    streams: dict[tuple, list[dict]] = {}
    for row in rows:
        streams.setdefault(stream_key(row), []).append(row)
    checked, skipped = [], []
    regressions = 0
    for key, stream in streams.items():
        newest, history = stream[-1], stream[:-1]
        label = {"metric": key[0], "config_digest": key[1],
                 "device": key[2], "backend_class": key[3]}
        usable = [r for r in history
                  if isinstance(r.get("value"), (int, float))]
        if len(usable) < min_history:
            skipped.append({**label, "reason":
                            f"{len(usable)} prior rows < min_history="
                            f"{min_history}"})
            continue
        if not isinstance(newest.get("value"), (int, float)):
            skipped.append({**label, "reason": "newest row has no value"})
            continue
        fields = [("value", bool(newest.get("higher_is_better", True)))]
        fields += [
            (aux, hib) for aux, hib in AUX_METRICS.items()
            if isinstance(newest.get(aux), (int, float))
            and rolling_baseline(usable, aux, window) is not None
        ]
        verdicts = []
        for field, hib in fields:
            baseline = rolling_baseline(usable, field, window)
            if baseline is None:
                continue
            v = _verdict_for(field, float(newest[field]), baseline, hib,
                             threshold)
            regressions += int(v["regressed"])
            verdicts.append(v)
        checked.append({**label, "history": len(usable),
                        "fields": verdicts})
    return {
        "ok": regressions == 0,
        "threshold": threshold,
        "window": window,
        "min_history": min_history,
        "checked": checked,
        "skipped": skipped,
        "regressions": regressions,
    }


def check(path: str, threshold: float = 0.10, window: int = 5,
          min_history: int = 2) -> dict:
    """check_rows over the file, with its path, row count and malformed
    lines."""
    rows, bad = read(path)
    verdict = check_rows(rows, threshold=threshold, window=window,
                         min_history=min_history)
    verdict.update(ledger=path, rows=len(rows), malformed_lines=bad)
    return verdict


def append_bench_row(result_fields: dict, workload: dict,
                     path: str | None = None,
                     device: str | torch.device | None = None) -> dict | None:
    """Build a row from a bench's fields, append it to the configured ledger
    and return it (None when the ledger is disabled). `device` fills the
    row's device and backend when the fields lack them. Never raises: a bench
    must report its number even when the ledger file is unwritable (the
    failure is noted on stderr)."""
    path = ledger_path() if path is None else path
    if path is None:
        return None
    try:
        fields = dict(result_fields)
        if device is not None:
            for k, v in device_fields(device).items():
                fields.setdefault(k, v)
        row = make_row(workload=workload, **fields)
        append(path, row)
        return row
    except Exception as exc:  # noqa: BLE001 - the measurement outranks the ledger
        # an unwritable ledger must not pass for a disabled one: the gate
        # would check no stream and nothing would say why
        print(f"# perf-ledger append to {path} failed: {exc}", file=sys.stderr)
        return None
