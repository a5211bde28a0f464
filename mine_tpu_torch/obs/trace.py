"""Host-side span tracing with Chrome-trace JSON export (the port's own copy
of mine_tpu/obs/trace.py, plus obs/collect.py's per-request filter).

  * `Tracer.span(name)` is a context manager recording a wall-clock span
    into a bounded ring (deque), with a thread-local stack so spans nest and
    a per-(cat, name) running total for cheap phase summaries.
  * `to_chrome_trace()` / `export()` emit Chrome trace-event JSON whose
    process lane is named HOST_PROCESS_NAME, for chrome://tracing or
    Perfetto next to a torch.profiler device trace.
  * Disabled, `span()` returns a shared no-op context manager: one
    attribute check and no allocation.
  * The request trace context rides two headers: X-Request-Id (minted when
    absent or malformed, `resolve_request_id`) and X-Parent-Span (the
    upstream hop's span id, dropped when malformed). `filter_doc_to_request`
    reduces an export to one request's spans.

The ring and the totals take a reentrant lock; the span stack is
thread-local.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable

# the process-lane name host exports carry (the JAX package's, so that its
# trace tools read the port's exports as they read its own)
HOST_PROCESS_NAME = "mine_tpu host spans"

# span args the trace context rides in: `span_id` names a span so a
# downstream hop can point back at it, `parent_span` is the upstream hop's
# span_id (arrived as the X-Parent-Span header), and `request_id` is the
# trace id (X-Request-Id)
SPAN_ID_ARG = "span_id"
PARENT_SPAN_ARG = "parent_span"
REQUEST_ID_ARG = "request_id"

# the HTTP spellings of the trace context
REQUEST_ID_HEADER = "X-Request-Id"
PARENT_SPAN_HEADER = "X-Parent-Span"

# charset guard for BOTH context headers: a value is echoed into response
# headers and span args, so anything that could smuggle newlines or
# unbounded bytes is replaced (request id: minted; parent span: dropped)
TRACE_TOKEN_RE = re.compile(r"^[A-Za-z0-9._\-]{1,128}$")


def new_span_id() -> str:
    """A fresh span id for a hop: short enough to ride a header, unique
    enough per ring."""
    return uuid.uuid4().hex[:12]


def resolve_request_id(raw: str | None) -> str:
    """The caller-supplied request id when well-formed (TRACE_TOKEN_RE),
    else a minted one: every request gets an addressable trace id."""
    if raw and TRACE_TOKEN_RE.match(raw):
        return raw
    return uuid.uuid4().hex[:16]


def resolve_parent_span(raw: str | None) -> str | None:
    """The upstream hop's span id when well-formed, else None (a
    malformed parent is dropped, never echoed into span args)."""
    return raw if raw and TRACE_TOKEN_RE.match(raw) else None


@dataclass(frozen=True)
class Span:
    """One completed span. Times are microseconds on the tracer's
    monotonic epoch (perf_counter-based — durations are exact; absolute
    alignment with a device trace is not promised, same as any two
    independent trace clocks)."""

    name: str
    cat: str
    ts_us: float
    dur_us: float
    tid: int
    thread_name: str
    depth: int
    args: dict[str, Any] = field(default_factory=dict)


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager for one enabled span."""

    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def __enter__(self) -> "_LiveSpan":
        self.tracer._push(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        t1 = time.perf_counter()
        self.tracer._pop_and_record(
            self.name, self.cat, self.t0, t1, self.args
        )


class Tracer:
    """Bounded-ring host span recorder; one per subsystem instance.

    on_span: optional callback invoked (outside the lock) with each
    completed Span — the serving stack hooks its trace-counter metric
    family here.
    """

    def __init__(
        self,
        enabled: bool = False,
        max_spans: int = 4096,
        on_span: Callable[[Span], None] | None = None,
    ):
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self.on_span = on_span
        self._epoch = time.perf_counter()
        self._lock = threading.RLock()
        self._spans: deque[Span] = deque(maxlen=self.max_spans)  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        # running (cat, name) -> [count, total_us] since last summary reset
        self._totals: dict[tuple[str, str], list[float]] = defaultdict(  # guarded-by: _lock
            lambda: [0.0, 0.0]
        )
        self._local = threading.local()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, cat: str = "host", **args: Any):
        """Context manager timing one phase; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, args)

    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, name: str) -> None:
        self._stack().append(name)

    def _pop_and_record(
        self, name: str, cat: str, t0: float, t1: float, args: dict
    ) -> None:
        stack = self._stack()
        depth = max(len(stack) - 1, 0)
        if stack and stack[-1] == name:
            stack.pop()
        self._record(name, cat, t0, t1, args, depth)

    def _record(
        self, name: str, cat: str, t0: float, t1: float, args: dict,
        depth: int,
    ) -> None:
        thread = threading.current_thread()
        span = Span(
            name=name,
            cat=cat,
            ts_us=(t0 - self._epoch) * 1e6,
            dur_us=(t1 - t0) * 1e6,
            tid=thread.ident or 0,
            thread_name=thread.name,
            depth=depth,
            args=args,
        )
        with self._lock:
            if len(self._spans) == self.max_spans:
                self._dropped += 1
            self._spans.append(span)
            tot = self._totals[(cat, name)]
            tot[0] += 1
            tot[1] += span.dur_us
        if self.on_span is not None:
            self.on_span(span)

    def record(
        self, name: str, cat: str, t0: float, t1: float, **args: Any
    ) -> None:
        """Record a span from explicit perf_counter endpoints — for phases
        whose start and end live in different stack frames (e.g. the
        batcher's queue-wait, measured from another request's enqueue).
        Never touches the thread-local span stack."""
        if not self.enabled:
            return
        self._record(name, cat, t0, t1, args, depth=0)

    def active_spans(self) -> list[str]:
        """This thread's open span names (outer -> inner)."""
        return list(self._stack())

    # -- reading -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def snapshot(self, last_k: int | None = None) -> list[Span]:
        with self._lock:
            spans = list(self._spans)
        return spans if last_k is None else spans[-int(last_k):]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def phase_summary(self, reset: bool = False) -> dict[str, dict[str, float]]:
        """(cat.name) -> {count, total_ms, mean_ms} since the last reset,
        without walking the ring."""
        with self._lock:
            out = {
                f"{cat}.{name}": {
                    "count": int(count),
                    "total_ms": round(total_us / 1e3, 3),
                    "mean_ms": round(total_us / 1e3 / count, 3) if count else 0.0,
                }
                for (cat, name), (count, total_us) in self._totals.items()
            }
            if reset:
                self._totals.clear()
        return out

    # -- export --------------------------------------------------------------

    def to_chrome_trace(
        self, last_k: int | None = None,
        extra_events: list[dict] | None = None,
    ) -> dict:
        """Chrome trace-event JSON (dict): `X` duration events per span plus
        process/thread metadata naming the host lane. extra_events (already
        on this tracer's timebase, e.g. obs/memlog.py counter events) are
        appended verbatim so they render in the same lane."""
        pid = os.getpid()
        spans = self.snapshot(last_k)
        events: list[dict] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": HOST_PROCESS_NAME},
        }]
        seen_tids: dict[int, str] = {}
        for s in spans:
            if s.tid not in seen_tids:
                seen_tids[s.tid] = s.thread_name
                events.append({
                    "ph": "M", "pid": pid, "tid": s.tid,
                    "name": "thread_name",
                    "args": {"name": s.thread_name},
                })
            ev = {
                "ph": "X", "pid": pid, "tid": s.tid, "name": s.name,
                "cat": s.cat, "ts": round(s.ts_us, 3),
                "dur": round(s.dur_us, 3),
            }
            if s.args:
                ev["args"] = {k: _jsonable(v) for k, v in s.args.items()}
            events.append(ev)
        if extra_events:
            events.extend(extra_events)
        return {
            "displayTimeUnit": "ms",
            "traceEvents": events,
            "metadata": {
                "producer": HOST_PROCESS_NAME,
                "dropped_spans": self.dropped,
                # clock anchor: the tracer-timebase instant and the wall
                # clock at export, captured back to back, so that a span's
                # ts maps onto this process's wall clock as
                #   wall_s = exported_unix_s + (ts_us - exported_ts_us)/1e6
                "clock": {
                    "exported_ts_us": (time.perf_counter() - self._epoch)
                    * 1e6,
                    "exported_unix_s": time.time(),
                },
            },
        }

    def export(
        self, path: str, last_k: int | None = None,
        extra_events: list[dict] | None = None,
    ) -> str:
        """Write the Chrome-trace JSON (name it `*.trace.json`)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_chrome_trace(last_k, extra_events), fh)
        os.replace(tmp, path)
        return path


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# shared disabled tracer: a safe default for call sites that take an
# optional tracer (never enable it — it is process-global)
NULL_TRACER = Tracer(enabled=False)


def _matches_request(ev: dict, request_id: str) -> bool:
    if ev.get("ph") != "X":
        return False
    args = ev.get("args") or {}
    if args.get(REQUEST_ID_ARG) == request_id:
        return True
    return request_id in str(args.get("request_ids", "")).split(",")


def filter_doc_to_request(doc: dict, request_id: str) -> dict:
    """A Chrome-trace doc reduced to ONE request: metadata (`M`) events
    kept, `X` spans kept only when their `request_id` is this one or their
    comma-joined `request_ids` (a coalesced dispatch) names it."""
    out = dict(doc)
    out["traceEvents"] = [
        ev for ev in doc.get("traceEvents", ())
        if ev.get("ph") == "M" or _matches_request(ev, request_id)
    ]
    meta = dict(doc.get("metadata") or {})
    meta["request_id"] = request_id
    out["metadata"] = meta
    return out
