"""Live device-memory telemetry (the port's own copy of
mine_tpu/obs/memlog.py): sample the card's allocator into gauges and
Chrome-trace counter events.

The JAX package polls `jax.Device.memory_stats()`; here the sample is the
CUDA caching allocator's `torch.cuda.memory_allocated` (bytes_in_use) and
`torch.cuda.max_memory_allocated` (peak_bytes_in_use) on the engine's
device. The server samples after each engine dispatch and on every
/metrics scrape, and publishes `mine_serve_hbm_{live,peak}_bytes` (the JAX
package's names) plus `C` events on the tracer's clock. A CPU device has no
stats: no sample, and the gauges stay absent, never a fabricated 0.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable

import torch

from mine_tpu_torch.obs.trace import Tracer

# the Chrome counter track name (one per process lane)
COUNTER_NAME = "hbm_bytes"


def device_memory_stats(device: torch.device | str | None = None) -> list[dict]:
    """The CUDA caching allocator's bytes of `device` (the current CUDA
    device when None), shaped as the JAX package's memory_stats samples:
    bytes_in_use is torch.cuda.memory_allocated, peak_bytes_in_use
    torch.cuda.max_memory_allocated. A CPU device, or no CUDA, has no stats:
    an empty list."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return []
    return [{"device": str(dev), "stats": {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
    }}]


class MemLog:
    """Bounded-ring device-memory sampler over one tracer's clock.

    live_gauge/peak_gauge: utils/metrics.py Gauges (or None). stats_fn
    defaults to device_memory_stats of `device`, and is injectable for
    tests.
    """

    def __init__(
        self,
        tracer: Tracer | None = None,
        live_gauge: Any | None = None,
        peak_gauge: Any | None = None,
        max_samples: int = 4096,
        stats_fn: Callable[[], list[dict]] | None = None,
        device: torch.device | str | None = None,
    ):
        self.tracer = tracer
        self.live_gauge = live_gauge
        self.peak_gauge = peak_gauge
        self._stats_fn = stats_fn or (lambda: device_memory_stats(device))
        self._lock = threading.Lock()
        self._samples: deque[dict] = deque(maxlen=int(max_samples))
        self._epoch = (
            tracer._epoch if tracer is not None else time.perf_counter()
        )

    # -- sampling ------------------------------------------------------------

    def sample(self, step: Any = None) -> dict | None:
        """Poll the device once; returns the sample (or None when the
        device reports no stats, and then the gauges stay unset). The
        gauges take the max over the devices sampled."""
        try:
            per_device = self._stats_fn()
        except Exception:  # noqa: BLE001 - telemetry must never crash a step
            return None
        live = peak = None
        for entry in per_device:
            stats = entry.get("stats") or {}
            b = stats.get("bytes_in_use")
            p = stats.get("peak_bytes_in_use")
            if b is not None:
                live = max(live or 0, int(b))
            if p is not None:
                peak = max(peak or 0, int(p))
        if live is None and peak is None:
            return None
        sample = {
            "ts_us": (time.perf_counter() - self._epoch) * 1e6,
            "step": step,
            "live_bytes": live,
            "peak_bytes": peak,
            "devices": per_device,
        }
        with self._lock:
            self._samples.append(sample)
        if self.live_gauge is not None and live is not None:
            self.live_gauge.set(live)
        if self.peak_gauge is not None and peak is not None:
            self.peak_gauge.set(peak)
        return sample

    # -- reading -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def last(self) -> dict | None:
        """Newest sample minus the per-device list."""
        with self._lock:
            if not self._samples:
                return None
            s = dict(self._samples[-1])
        s.pop("devices", None)
        return s

    def counter_events(self, pid: int | None = None) -> list[dict]:
        """Chrome-trace `C` (counter) events for every sample, on the host
        tracer's timebase, for the host-span export."""
        pid = os.getpid() if pid is None else pid
        with self._lock:
            samples = list(self._samples)
        events = []
        for s in samples:
            args = {}
            if s["live_bytes"] is not None:
                args["live"] = s["live_bytes"]
            if s["peak_bytes"] is not None:
                args["peak"] = s["peak_bytes"]
            events.append({
                "ph": "C", "pid": pid, "tid": 0, "name": COUNTER_NAME,
                "ts": round(s["ts_us"], 3), "args": args,
            })
        return events
