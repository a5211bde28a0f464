"""The serving metric set, on mine_tpu_torch.utils.metrics' registry (the
port's own copy of mine_tpu/serving/metrics.py, with the same
`mine_serve_*` family names). The cost families are set by the engine's
predicts (serving/engine.py, obs/cost.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from mine_tpu_torch.utils.metrics import MetricsRegistry


class RateGauge:
    """Rolling throughput gauge: record(n) events, value() = n/sec over the
    trailing window. Backed by a plain gauge family in the registry that is
    refreshed on every record AND on every scrape (server.py calls
    refresh() before rendering), so an idle server decays to 0 instead of
    freezing at its last burst."""

    def __init__(self, gauge, window_s: float = 30.0):
        self._gauge = gauge
        self._window_s = window_s
        self._events: deque[tuple[float, float]] = deque()
        self._lock = threading.Lock()

    def record(self, n: float, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, float(n)))
            self._gauge.set(self._rate_locked(now))

    def refresh(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            rate = self._rate_locked(now)
            self._gauge.set(rate)
            return rate

    def _rate_locked(self, now: float) -> float:
        cutoff = now - self._window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()
        if not self._events:
            return 0.0
        total = sum(n for _, n in self._events)
        # span from the oldest retained event, floored to avoid a huge rate
        # from a single instantaneous burst
        span = max(now - self._events[0][0], 1.0)
        return total / span


class ServingMetrics:
    """Every serving metric, created against one registry."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry

        # HTTP surface
        self.requests = r.counter(
            "mine_serve_requests_total",
            "HTTP requests by endpoint and status code",
        )
        self.request_latency = r.histogram(
            "mine_serve_request_latency_seconds",
            "request wall time by endpoint (cumulative le buckets)",
        )
        self.queue_delay = r.histogram(
            "mine_serve_queue_delay_seconds",
            "time a render request waited in the micro-batcher before its "
            "group dispatched (the latency cost of coalescing)",
        )

        # admission control + fault tolerance
        self.shed_requests = r.counter(
            "mine_serve_shed_requests_total",
            "requests rejected before any work, by reason "
            "(queue_full|breaker_open|draining)",
        )
        self.draining = r.gauge(
            "mine_serve_draining",
            "1 while this replica is in the drain shedding state "
            "(/admin/drain: product POSTs answer 503 + Retry-After, the "
            "peer-fetch wire stays served for the arc handoff), else 0",
        )
        self.request_timeouts = r.counter(
            "mine_serve_request_timeouts_total",
            "requests that hit their deadline, by stage (queue = expired "
            "before dispatch -> 504; result = client wait timed out and "
            "the pending entry was evicted -> 504)",
        )
        self.breaker_state = r.gauge(
            "mine_serve_breaker_state",
            "circuit breaker state: 0 closed, 1 half-open, 2 open",
        )
        # brownout degradation ladder (serving/degrade.py): fidelity traded
        # for availability before any shed; degraded answers are 200s
        self.degradation_level = r.gauge(
            "mine_serve_degradation_level",
            "brownout ladder level: 0 normal, 1 int8+pruned predicts, "
            "2 stale-while-revalidate, 3 widened coalescing (the 503 "
            "shed only fires past 3)",
        )
        self.degradation_responses = r.counter(
            "mine_serve_degradation_responses_total",
            "product responses served while the brownout ladder was "
            "engaged, by level; every one also carried an X-Degraded "
            "header announcing its level and effective tier",
        )
        self.breaker_trips = r.counter(
            "mine_serve_breaker_trips_total",
            "closed/half-open -> open transitions after consecutive engine "
            "failures",
        )
        self.engine_failures = r.counter(
            "mine_serve_engine_failures_total",
            "engine dispatch failures, by kind (predict/render) — the "
            "breaker's input signal",
        )

        # hot checkpoint swap (serving/engine.py swap_weights + the
        # ServingApp swap worker): generation flips and the named failure
        # modes; a failed swap is never a 5xx, it is these counters
        self.weight_generation = r.gauge(
            "mine_serve_weight_generation",
            "serving weight generation (0 = the startup checkpoint; "
            "incremented by every successful hot swap)",
        )
        self.swaps = r.counter(
            "mine_serve_swaps_total",
            "successful hot checkpoint swaps (atomic generation flips)",
        )
        self.swap_failures = r.counter(
            "mine_serve_swap_failures_total",
            "hot swaps that did NOT flip, by reason (load = checkpoint "
            "unreadable; corrupt = integrity sidecar mismatch; rejected = "
            "tree/shape validation or verification dispatch failed; "
            "in_progress = concurrent swap refused; internal = anything "
            "else): the old generation kept serving in every case",
        )

        # host-span tracing (obs/trace.py wired via ServingApp)
        self.trace_spans = r.counter(
            "mine_serve_trace_spans_total",
            "host spans recorded by the request-lifecycle tracer, by cat",
        )

        # engine
        self.encoder_invocations = r.counter(
            "mine_serve_encoder_invocations_total",
            "full encoder-decoder predict passes actually executed "
            "(cache hits do not count — this is the expensive half)",
        )
        self.engine_compiles = r.counter(
            "mine_serve_engine_compiles_total",
            "first dispatches of a predict bucket or a (plane count, pose "
            "count) render bucket, by kind (predict/render): each builds "
            "the kernels and warms cuDNN and the allocator; bounded by the "
            "shape-bucket, plane-bucket and pose-bucket sets",
        )
        self.rendered_frames = r.counter(
            "mine_serve_rendered_frames_total",
            "novel-view frames rendered (padding frames excluded)",
        )
        self.renders_per_sec = RateGauge(r.gauge(
            "mine_serve_renders_per_sec",
            "rendered frames per second over the trailing window",
        ))

        # cost accounting (obs/cost.py): the predict's counted FLOPs over
        # its measured time to completion
        self.step_flops = r.gauge(
            "mine_serve_step_flops",
            "FLOPs of the most recent dispatch (FlopCounterMode count of its "
            "bucket's first predict), by kind",
        )
        self.mfu = r.gauge(
            "mine_serve_mfu",
            "predict model FLOPs utilization over the device peak (absent "
            "until a predict resolves and the peak is known)",
        )
        self.achieved_tflops = r.gauge(
            "mine_serve_achieved_tflops_per_sec",
            "achieved TFLOP/s of the last predict",
        )

        # live device memory (obs/memlog.py; sampled per dispatch and per
        # /metrics scrape; absent on a CPU device)
        self.hbm_live_bytes = r.gauge(
            "mine_serve_hbm_live_bytes",
            "torch.cuda.memory_allocated() of the engine's device",
        )
        self.hbm_peak_bytes = r.gauge(
            "mine_serve_hbm_peak_bytes",
            "torch.cuda.max_memory_allocated() of the engine's device: the "
            "high-water mark the cache byte budget and bucket set must stay "
            "under",
        )

        # compressed MPI tier (serving/compress.py)
        self.pruned_planes = r.counter(
            "mine_serve_pruned_planes_total",
            "planes dropped from cached MPIs by transmittance pruning "
            "(serving.prune_transmittance_eps): cache bytes and render work "
            "that no longer exist",
        )

        # fleet peer fetch (serving/server.py _peer_fetch): on a local miss
        # a replica asks the ring's owner for the compressed MPI before
        # running the encoder; mine_fleet_* because it is fleet-wire traffic
        self.peer_fetch = r.counter(
            "mine_fleet_peer_fetch_total",
            "peer MPI fetch attempts by outcome (hit = adopted a peer's "
            "cached MPI, zero local encoder cost; miss = owner answered "
            "404; incompatible = the peer runs a different pruning "
            "operating point, config drift surfaced; timeout/error = "
            "degraded to a local re-predict)",
        )
        # autoscale pre-warm and drain handoff (serving/server.py prewarm)
        self.prewarm_keys = r.counter(
            "mine_serve_prewarm_keys_total",
            "pre-warm/handoff key outcomes (fetched = adopted over the "
            "wire; resident = already cached here; miss = no source had "
            "it; error = fetch/adopt failed, skipped)",
        )

        # MPI cache
        self.cache_hits = r.counter(
            "mine_serve_cache_hits_total", "MPI cache hits")
        self.cache_misses = r.counter(
            "mine_serve_cache_misses_total", "MPI cache misses")
        self.cache_evictions = r.counter(
            "mine_serve_cache_evictions_total",
            "MPI cache entries evicted for the byte budget",
        )
        self.cache_bytes_resident = r.gauge(
            "mine_serve_cache_bytes_resident",
            "bytes of MPI data currently cached",
        )
        self.cache_entries = r.gauge(
            "mine_serve_cache_entries", "MPI cache entry count")

        # micro-batcher
        self.batch_dispatches = r.counter(
            "mine_serve_batch_dispatches_total",
            "render-many dispatches run by the micro-batcher",
        )
        self.batch_requests = r.counter(
            "mine_serve_batch_requests_total",
            "render requests that entered the micro-batcher",
        )
        self.batch_coalesced_dispatches = r.counter(
            "mine_serve_batch_coalesced_dispatches_total",
            "dispatches that coalesced >= 2 requests into one render-many",
        )
        self.batch_queue_depth = r.gauge(
            "mine_serve_batch_queue_depth",
            "render requests waiting in the micro-batcher",
        )

    def render(self) -> str:
        self.renders_per_sec.refresh()
        return self.registry.render()
