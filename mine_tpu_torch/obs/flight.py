"""Flight recorder: leave evidence when a run dies or stalls (the port's
own copy of mine_tpu/obs/flight.py).

  * SIGUSR1  -> dump and continue (poke a live-but-suspicious run).
  * SIGTERM  -> dump, then re-deliver the signal with the previous
    disposition restored, so termination is unchanged: the dump is the only
    addition.
  * stall watchdog -> a heartbeat thread; when `heartbeat()` has not been
    called for `watchdog_timeout_s` (no step completed), dump with reason
    "stall". One dump per stall: the watchdog re-arms only after the
    heartbeat resumes (plus a minimum inter-dump interval, so a wedged run
    cannot fill the disk).

A dump is a directory `<proc>/flight_<utc>_<reason>/` under `dump_dir`
(training passes `<workspace>/flight`, the server `<workspace>/flight`).
`<proc>` is `p<rank>-<pid>` inside a torch.distributed group, `pid<pid>`
otherwise:

  stacks.txt  all-thread Python stacks via faulthandler.
  spans.json  the tracer's last-K spans plus this thread's open spans.
  meta.json   reason, timestamps, heartbeat age, last step, the caller's
              status, and torch.cuda.memory_stats of every card when this
              process has initialised CUDA (never initialising it, never
              synchronising a stream).

Everything in `dump()` is individually best-effort: a half-written dump
beats an exception that masks the original failure. A dump takes only the
recorder's own lock; `get_status` must not take a lock the process's work
holds either.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import threading
import time
from typing import Any, Callable

import torch

from mine_tpu_torch.obs.trace import Span, Tracer


def _span_dict(s: Span) -> dict:
    return {
        "name": s.name, "cat": s.cat, "ts_us": round(s.ts_us, 1),
        "dur_us": round(s.dur_us, 1), "tid": s.tid,
        "thread": s.thread_name, "depth": s.depth, "args": s.args,
    }


def _process_key() -> str:
    """The per-process dump-subdirectory name: `p<rank>-<pid>` inside an
    initialised torch.distributed group, `pid<pid>` otherwise, so that
    processes sharing a dump dir write disjoint subdirectories."""
    pid = os.getpid()
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return f"p{dist.get_rank()}-{pid}"
    return f"pid{pid}"


def _device_memory_stats() -> Any:
    """torch.cuda.memory_stats of every card IF this process has already
    initialised CUDA; never initialises it and never synchronises a stream
    (the allocator's statistics live on the host), so a dump on a wedged
    card does not hang on that card."""
    if not torch.cuda.is_initialized():
        return "cuda not initialized"
    try:
        return [
            {
                "device": f"cuda:{i}",
                "kind": torch.cuda.get_device_name(i),
                "memory_stats": dict(torch.cuda.memory_stats(i)),
            }
            for i in range(torch.cuda.device_count())
        ]
    except Exception as exc:  # noqa: BLE001 - evidence, not correctness
        return f"unavailable: {type(exc).__name__}: {exc}"


class FlightRecorder:
    """Signal + watchdog crash/stall dumper around one tracer."""

    def __init__(
        self,
        dump_dir: str,
        tracer: Tracer | None = None,
        watchdog_timeout_s: float = 0.0,
        last_k_spans: int = 256,
        min_dump_interval_s: float = 10.0,
        get_status: Callable[[], dict] | None = None,
        signals: tuple[int, ...] = (signal.SIGUSR1, signal.SIGTERM),
    ):
        self.dump_dir = dump_dir
        self.tracer = tracer
        self.watchdog_timeout_s = float(watchdog_timeout_s)
        self.last_k_spans = int(last_k_spans)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.get_status = get_status
        self._signals = signals
        self._prev_handlers: dict[int, Any] = {}
        # reentrant: a signal can interrupt a dump on the thread that runs it
        self._lock = threading.RLock()
        self._beat = time.monotonic()
        self._last_step: Any = None
        self._last_dump = 0.0
        self._stalled = False
        self._stop = threading.Event()
        self._watchdog: threading.Thread | None = None
        self.dumps: list[str] = []
        self._started_at = time.time()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FlightRecorder":
        """Install signal handlers (main thread only — CPython's rule) and
        start the stall watchdog when a timeout is configured."""
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                try:
                    self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
                except (ValueError, OSError):  # non-main ctx or exotic platform
                    pass
        if self.watchdog_timeout_s > 0 and self._watchdog is None:
            self._stop.clear()
            self._beat = time.monotonic()
            self._watchdog = threading.Thread(
                target=self._watch, name="mine-obs-flight-watchdog", daemon=True
            )
            self._watchdog.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
            self._watchdog = None
        if threading.current_thread() is threading.main_thread():
            for sig, prev in self._prev_handlers.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
            self._prev_handlers.clear()

    # -- heartbeat / watchdog ------------------------------------------------

    def heartbeat(self, step: Any = None) -> None:
        """Call once per unit of progress (train step, serve dispatch)."""
        self._beat = time.monotonic()
        self._stalled = False
        if step is not None:
            self._last_step = step

    def _watch(self) -> None:
        interval = max(min(self.watchdog_timeout_s / 4.0, 1.0), 0.05)
        while not self._stop.wait(interval):
            age = time.monotonic() - self._beat
            if age < self.watchdog_timeout_s or self._stalled:
                continue
            self._stalled = True  # re-armed by the next heartbeat
            self.dump("stall", extra={"heartbeat_age_s": round(age, 3)})

    # -- signals -------------------------------------------------------------

    def _on_signal(self, signum: int, frame: Any) -> None:
        name = signal.Signals(signum).name.lower()
        self.dump(f"signal_{name}")
        if signum == signal.SIGTERM:
            # restore the previous disposition and re-deliver: termination
            # must still terminate (this handler only adds the evidence)
            prev = self._prev_handlers.get(signum, signal.SIG_DFL)
            try:
                signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError, TypeError):
                signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    # -- the dump itself -----------------------------------------------------

    def dump(self, reason: str, extra: dict | None = None) -> str | None:
        """Write one flight-dump directory; rate-limited; never raises."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < self.min_dump_interval_s and self.dumps:
                return None
            self._last_dump = now
        try:
            stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime())
            path = os.path.join(
                self.dump_dir, _process_key(), f"flight_{stamp}_{reason}"
            )
            # a second dump in the same second must not clobber the first
            base, n = path, 1
            while os.path.exists(path):
                path = f"{base}.{n}"
                n += 1
            os.makedirs(path, exist_ok=True)
        except OSError:
            return None

        try:
            with open(os.path.join(path, "stacks.txt"), "w") as fh:
                fh.write(f"flight dump: reason={reason} "
                         f"utc={time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())}\n\n")
                faulthandler.dump_traceback(file=fh, all_threads=True)
        except Exception:  # noqa: BLE001 - best effort, see module docstring
            pass

        try:
            spans: list[dict] = []
            active: list[str] = []
            if self.tracer is not None:
                spans = [
                    _span_dict(s)
                    for s in self.tracer.snapshot(self.last_k_spans)
                ]
                active = self.tracer.active_spans()
            with open(os.path.join(path, "spans.json"), "w") as fh:
                json.dump({
                    "reason": reason,
                    "last_k": self.last_k_spans,
                    "open_spans_this_thread": active,
                    "spans": spans,
                }, fh)
        except Exception:  # noqa: BLE001
            pass

        try:
            status = {}
            if self.get_status is not None:
                try:
                    status = dict(self.get_status())
                except Exception as exc:  # noqa: BLE001
                    status = {"error": f"{type(exc).__name__}: {exc}"}
            meta = {
                "reason": reason,
                "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "pid": os.getpid(),
                "uptime_s": round(time.time() - self._started_at, 1),
                "heartbeat_age_s": round(time.monotonic() - self._beat, 3),
                "last_step": self._last_step,
                "watchdog_timeout_s": self.watchdog_timeout_s,
                "status": status,
                "device_memory": _device_memory_stats(),
            }
            if extra:
                meta.update(extra)
            with open(os.path.join(path, "meta.json"), "w") as fh:
                json.dump(meta, fh)
        except Exception:  # noqa: BLE001
            pass

        self.dumps.append(path)
        return path
