"""Micro-batching queue: coalesce concurrent renders of one MPI (the port's
own copy of mine_tpu/serving/batcher.py).

Rendering 8 poses in one dispatch costs less than 8 dispatches of 1 (one
pose-bucketed render, one host copy per frame, no per-call set-up). When
several clients orbit the same scene their requests arrive within
milliseconds; the batcher holds the first one back for at most
`max_delay_ms` and folds every same-key request that arrives in that window
into one dispatch, up to `max_batch_poses` poses.

One worker thread over a pending deque guarded by a condition variable. The
worker seeds a group with the oldest request, then sweeps the deque for
requests with the same cache key; requests for other keys stay in place and
seed later groups, so coalescing never reorders work within a key. Results
come back through per-request futures.

Admission control: the deque is bounded (`max_queue_requests`; beyond it
`submit` raises QueueFull, HTTP 503 + Retry-After); each request carries an
optional monotonic `deadline`, and a request still pending past it fails
with DeadlineExceeded (HTTP 504) before dispatch, so no device time goes to
frames whose client gave up. `stop()` fails stranded requests with
BatcherStopped (HTTP 503).

The brownout ladder (serving/degrade.py) reads `queue_frac` as its pressure
signal and retargets the window with `set_max_delay_s`. A group waiting in
its window re-reads the window on every wake-up, so a widening reaches the
current queue (the JAX batcher fixes a group's deadline when it seeds it).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from mine_tpu_torch.obs.trace import NULL_TRACER, Tracer
from mine_tpu_torch.serving.cache import CacheKey, MPIEntry

# (entry, poses (N,4,4)) -> (rgb (N,H,W,3), disp (N,H,W,1))
RenderFn = Callable[[MPIEntry, np.ndarray], tuple[np.ndarray, np.ndarray]]


class BatcherStopped(RuntimeError):
    """The batcher is stopped (shutdown drain) — maps to HTTP 503."""

    def __init__(self) -> None:
        super().__init__("batcher stopped")


class QueueFull(RuntimeError):
    """Pending queue at capacity — shed with HTTP 503 + Retry-After."""

    def __init__(self, depth: int, bound: int):
        super().__init__(
            f"render queue full ({depth} pending >= bound {bound})"
        )


class DeadlineExceeded(RuntimeError):
    """Request expired while queued; dropped before dispatch (HTTP 504)."""

    def __init__(self, waited_s: float):
        super().__init__(
            f"request deadline exceeded after {waited_s:.3f}s in queue"
        )


@dataclass(eq=False)  # identity: cancel() must not compare pose arrays
class _Pending:
    key: CacheKey
    entry: MPIEntry
    poses: np.ndarray
    deadline: float | None = None  # monotonic; None = no deadline
    request_id: str | None = None  # X-Request-Id for span attribution
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


def _ids(group: list[_Pending]) -> str | None:
    """Comma-joined request ids of a group's members (span attribution:
    server.trace_for_request splits this back); None when no member
    carried one — absent beats an empty-string arg in every span."""
    ids = [p.request_id for p in group if p.request_id]
    return ",".join(ids) if ids else None


class MicroBatcher:
    """Single-worker coalescing dispatcher with a max-delay/max-batch policy.

    max_delay_ms: how long the oldest request of a group may wait for
      company before the group dispatches (the latency cost of coalescing —
      bounded and configurable; 0 disables waiting entirely).
    max_batch_poses: pose-count ceiling per dispatch; a request is only
      absorbed if the whole group still fits. A single over-sized request
      still dispatches alone (the engine chunks internally).
    max_queue_requests: pending-queue bound; submissions beyond it raise
      QueueFull (0 = unbounded).
    """

    def __init__(
        self,
        render_fn: RenderFn,
        max_delay_ms: float = 4.0,
        max_batch_poses: int = 64,
        max_queue_requests: int = 0,
        metrics: Any | None = None,
        tracer: Tracer | None = None,
    ):
        if max_batch_poses < 1:
            raise ValueError(f"max_batch_poses must be >= 1, got {max_batch_poses}")
        if max_queue_requests < 0:
            raise ValueError(
                f"max_queue_requests must be >= 0, got {max_queue_requests}"
            )
        self._render_fn = render_fn
        self.max_delay_s = max(0.0, max_delay_ms) / 1e3
        self.max_batch_poses = int(max_batch_poses)
        self.max_queue_requests = int(max_queue_requests)
        self._metrics = metrics
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._pending: deque[_Pending] = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._stop = False  # guarded-by: _cond
        self._worker: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._worker is None or not self._worker.is_alive():
            # under the condition like every other _stop touch: a restart
            # racing a concurrent stop() must not interleave the flag flip
            # with stop()'s drain
            with self._cond:
                self._stop = False
            self._worker = threading.Thread(
                target=self._run, name="mine-serve-batcher", daemon=True
            )
            self._worker.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
        # fail any requests stranded by shutdown instead of hanging clients;
        # the TYPED exception lets the HTTP layer answer 503 (drain), not 500
        with self._cond:
            stranded = list(self._pending)
            self._pending.clear()
            self._gauge_locked()
        for p in stranded:
            p.future.set_exception(BatcherStopped())

    # -- submission ----------------------------------------------------------

    def submit(
        self,
        key: CacheKey,
        entry: MPIEntry,
        poses: np.ndarray,
        deadline: float | None = None,
        request_id: str | None = None,
    ) -> Future:
        """Enqueue one render request; resolves to (rgb, disp) host arrays.

        deadline: monotonic-clock instant after which the request must NOT
        be dispatched — the worker fails it with DeadlineExceeded instead.
        request_id: trace attribution only — a coalesced dispatch's spans
        carry every member's id, so /debug/trace?request_id= finds them.
        """
        poses = np.asarray(poses, np.float32)
        if poses.ndim != 3 or poses.shape[1:] != (4, 4):
            raise ValueError(f"poses must be (N, 4, 4), got {poses.shape}")
        item = _Pending(key=key, entry=entry, poses=poses, deadline=deadline,
                        request_id=request_id)
        with self._cond:
            if self._stop:
                raise BatcherStopped()
            if (self.max_queue_requests
                    and len(self._pending) >= self.max_queue_requests):
                shed = getattr(self._metrics, "shed_requests", None)
                if shed is not None:
                    shed.inc(reason="queue_full")
                raise QueueFull(len(self._pending), self.max_queue_requests)
            self._pending.append(item)
            self._gauge_locked()
            self._cond.notify_all()
        if self._metrics is not None:
            self._metrics.batch_requests.inc()
        return item.future

    def cancel(self, future: Future) -> bool:
        """Evict a still-pending request (e.g. its client timed out and is
        gone — rendering for it would be pure waste). True if evicted;
        False when it already dispatched (the result is simply dropped)."""
        with self._cond:
            for item in self._pending:
                if item.future is future:
                    self._pending.remove(item)
                    self._gauge_locked()
                    return True
        return False

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def queue_frac(self) -> float:
        """Queue depth over its admission bound, the degradation ladder's
        pressure signal; 0.0 when the queue is unbounded."""
        if not self.max_queue_requests:
            return 0.0
        return self.queue_depth() / self.max_queue_requests

    def set_max_delay_s(self, delay_s: float) -> None:
        """Retarget the coalescing window live (brownout L3 widens it, a
        lower level restores it), for the group waiting now as well as
        later ones: the worker is woken to re-read it."""
        with self._cond:
            self.max_delay_s = max(0.0, float(delay_s))
            self._cond.notify_all()

    # -- worker --------------------------------------------------------------

    def _gauge_locked(self) -> None:
        if self._metrics is not None:
            self._metrics.batch_queue_depth.set(len(self._pending))

    def _fail_expired(self, items: list[_Pending]) -> None:
        """Fail expired requests with the typed 504 exception + counter.
        (Outside the condition lock: set_exception wakes blocked clients.)"""
        now = time.monotonic()
        for item in items:
            timeouts = getattr(self._metrics, "request_timeouts", None)
            if timeouts is not None:
                timeouts.inc(stage="queue")
            item.future.set_exception(
                DeadlineExceeded(now - item.enqueued_at)
            )

    def _take_group(self) -> list[_Pending] | None:
        """Block until work or stop; return one coalesced same-key group.
        Expired requests encountered anywhere — as a would-be seed or
        during the sweep — are failed, never dispatched."""
        expired: list[_Pending] = []
        try:
            with self._cond:
                while True:
                    while not self._pending and not self._stop:
                        self._cond.wait()
                    if not self._pending:
                        return None  # stopping and drained
                    coalesce_t0 = time.perf_counter()
                    seed = self._pending.popleft()
                    if seed.expired(time.monotonic()):
                        expired.append(seed)
                        self._gauge_locked()
                        continue
                    break
                group = [seed]
                n_poses = seed.poses.shape[0]
                while True:
                    # sweep pending for the seed's key, preserving order of
                    # everything not absorbed; a candidate only joins if the
                    # whole group still fits the pose ceiling (an oversized
                    # SEED still dispatches alone — the engine chunks)
                    kept: deque[_Pending] = deque()
                    now = time.monotonic()
                    while self._pending:
                        cand = self._pending.popleft()
                        if cand.expired(now):
                            expired.append(cand)
                        elif (cand.key == seed.key
                                and n_poses + cand.poses.shape[0]
                                <= self.max_batch_poses):
                            group.append(cand)
                            n_poses += cand.poses.shape[0]
                        else:
                            kept.append(cand)
                    self._pending = kept
                    # the window is read anew on every wake-up: a
                    # set_max_delay_s while this group waits applies to it
                    remaining = seed.enqueued_at + self.max_delay_s - time.monotonic()
                    if (n_poses >= self.max_batch_poses or remaining <= 0
                            or self._stop):
                        break
                    self._cond.wait(timeout=remaining)
                self._gauge_locked()
                self._tracer.record(
                    "coalesce", "serve", coalesce_t0, time.perf_counter(),
                    requests=len(group), poses=n_poses,
                    request_ids=_ids(group),
                )
                return group
        finally:
            self._fail_expired(expired)

    def _run(self) -> None:
        while True:
            group = self._take_group()
            if group is None:
                return
            self._dispatch(group)

    def _dispatch(self, group: list[_Pending]) -> None:
        # last line of deadline defense: members can expire during the
        # coalescing wait — drop them here rather than render into the void
        now = time.monotonic()
        expired = [p for p in group if p.expired(now)]
        if expired:
            self._fail_expired(expired)
            group = [p for p in group if not p.expired(now)]
            if not group:
                return
        poses = np.concatenate([p.poses for p in group], axis=0)
        now = time.monotonic()
        if self._metrics is not None:
            self._metrics.batch_dispatches.inc()
            if len(group) >= 2:
                self._metrics.batch_coalesced_dispatches.inc()
            qd = getattr(self._metrics, "queue_delay", None)
            if qd is not None:
                for p in group:
                    qd.observe(now - p.enqueued_at)
        # one queue-wait span per group, from the oldest member's enqueue
        # (enqueued_at is monotonic; the tracer wants perf_counter — map
        # the age onto the tracer clock)
        age = now - group[0].enqueued_at
        t1 = time.perf_counter()
        self._tracer.record("queue_wait", "serve", t1 - age, t1,
                            requests=len(group), request_ids=_ids(group))
        try:
            with self._tracer.span("dispatch", cat="serve",
                                   poses=poses.shape[0],
                                   request_ids=_ids(group)):
                rgb, disp = self._render_fn(group[0].entry, poses)
        except BaseException as exc:  # noqa: BLE001 - forwarded to callers
            for p in group:
                p.future.set_exception(exc)
            return
        offset = 0
        for p in group:
            n = p.poses.shape[0]
            p.future.set_result((rgb[offset:offset + n], disp[offset:offset + n]))
            offset += n
