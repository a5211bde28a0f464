"""HTTP serving surface (the port's counterpart of mine_tpu/serving/server.py).

Stdlib only (http.server.ThreadingHTTPServer). Handler threads do the cheap
work (decode, digest, cache lookup) and block on futures for the expensive
work, which goes through the engine and the micro-batcher.

Endpoints:
  POST /predict   image bytes (PNG/JPEG, raw body or JSON {"image_b64",
                  "bucket"?}) -> {"mpi_key", "cached", "bucket", "planes",
                  "planes_kept", "tier", "mpi_bytes"}. The encoder-decoder
                  runs ONCE per distinct (image bytes, checkpoint step,
                  bucket, tier); repeats are cache hits, and concurrent
                  misses of one key share one pass (singleflight).
  POST /render    JSON {"mpi_key", "poses" (N,4,4) | "offsets" (N,3),
                  "timeout_s"?, "include_disparity"?} -> {"frames_png_b64":
                  [...], ...}. 404 when the MPI left the cache (the client
                  predicts again). Concurrent renders of one MPI coalesce
                  into one dispatch (batcher.py).
  GET  /mpi/<key> the cached MPI as its wire container (compress.py
                  to_wire): the fleet's peer-fetch surface; 404 when not
                  resident.
  GET  /healthz   liveness + engine/bucket/cache snapshot, with the weight
                  generation and the swap state.
  GET  /metrics   Prometheus text exposition (serving/metrics.py names).
  POST /admin/swap  hot checkpoint swap: reload the workspace's newest
                  checkpoint into a new weight generation, validate and
                  verify it, flip. 202 async (default), {"wait": true}
                  blocks; a rejected or corrupt candidate answers 422 and the
                  old generation keeps serving. GET returns the last status.
                  --watch-last-good N polls the training job's last_good
                  pointer and promotes newer vetted checkpoints.
  GET  /debug/trace  the request-lifecycle host spans (parse, cache_lookup,
                  coalesce, queue_wait, dispatch, engine_predict, encode) as
                  Chrome-trace JSON; ?request_id= narrows it to one request.
  GET  /debug/hot_keys?n=  the n most recently used cache keys, hottest
                  first (what a joining replica pre-warms).
  POST /admin/drain {"draining": bool}: product POSTs answer 503 +
                  Retry-After while /mpi/<key> stays served (the autoscale
                  drain's handoff).
  POST /admin/peers {"peers": {name: url}, "peer_name"}: the
                  fleet membership for peer fetch.
  POST /admin/prewarm {"keys", "sources", "timeout_s"?}: adopt cached
                  MPIs from other replicas over /mpi/<key>.

Admission control: beyond `resilience.serve_max_queue_requests` pending
renders the server sheds with 503 + Retry-After; every render carries a
deadline (body `timeout_s`, default `resilience.serve_deadline_s`, both
clamped to REQUEST_TIMEOUT_S) that the batcher enforces before dispatch
(504); a circuit breaker around the engine opens after
`resilience.breaker_failure_threshold` consecutive dispatch failures and
sheds at once (503) until a half-open trial succeeds, with /healthz at 503
while it is open. Overload is an honest 503/504, never a hang or a 500.

Brownout (serving/degrade.py, `serving.degrade_enabled`): before any of
those sheds, a per-replica ladder trades fidelity for availability: int8 and
pruned predicts (L1), stale-while-revalidate over older-step cache entries
with the peer fetch skipped (L2), a widened coalescing window (L3). Every
degraded answer carries `X-Degraded: level=<n>;tier=<t>` and ticks
mine_serve_degradation_responses_total{level}. An SLO tracker (obs/slo.py)
is evaluated on every /metrics scrape; its worst burn rate feeds the ladder.

Fleet (serving/fleet.py): with --peer (the full membership, this replica
included) and --peer-name, a local cache miss first asks the replicas ahead
of this one in the digest's ring order for the MPI over GET /mpi/<key> and
adopts it onto this engine's device instead of running the encoder.

Cost: every predict sets mine_serve_step_flops, mine_serve_mfu and
mine_serve_achieved_tflops_per_sec (serving/engine.py, obs/cost.py);
--peak-flops gives the peak MFU divides by where the card has no table row.

Chaos seams (resilience/chaos.py, MINE_TPU_FAULTS): `corrupt_swap` and
`corrupt_ckpt` in the swap worker's load, `overload_spike` (the ladder's
inject) and `replica_kill` on a handled request, and the engine's
`predict_raise` and `engine_raise`.

CLI: python -m mine_tpu_torch.serving --workspace <train workspace> restores
the model weights only (training/checkpoint.py load_for_serving), runs the
default bucket's first dispatches, and serves until killed; on the CUDA
device unless --device cpu is given. Its flight recorder (obs/flight.py)
dumps thread stacks, the last request spans and the card's memory
statistics to <workspace>/flight on SIGUSR1 (and continues) and on SIGTERM
(then terminates).
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import io
import itertools
import json
import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs

import numpy as np
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.inference.trajectory import poses_from_offsets
from mine_tpu_torch.inference.video import normalize_disparity, to_uint8
from mine_tpu_torch.obs.flight import FlightRecorder
from mine_tpu_torch.obs.ledger import set_build_info
from mine_tpu_torch.obs.memlog import MemLog
from mine_tpu_torch.obs.slo import tracker_from_config
from mine_tpu_torch.obs.trace import (
    PARENT_SPAN_HEADER,
    REQUEST_ID_HEADER,
    Tracer,
    filter_doc_to_request,
    new_span_id,
    resolve_parent_span,
    resolve_request_id,
)
from mine_tpu_torch.resilience import chaos
from mine_tpu_torch.resilience.breaker import BreakerOpen, CircuitBreaker
from mine_tpu_torch.serving.batcher import (
    BatcherStopped,
    DeadlineExceeded,
    MicroBatcher,
    QueueFull,
)
from mine_tpu_torch.serving.cache import MPICache, key_from_str, key_to_str, mpi_key
from mine_tpu_torch.serving.compress import CompressedMPI, from_wire, to_wire
from mine_tpu_torch.serving.degrade import PressureSample, controller_from_config
from mine_tpu_torch.serving.engine import (
    BucketSpec,
    RenderEngine,
    SwapError,
    SwapInProgress,
)
from mine_tpu_torch.serving.fleet import HashRing, _urllib_transport
from mine_tpu_torch.serving.metrics import ServingMetrics
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.utils.device import resolve_device

# (state_dict, checkpoint_step): what a callable swap source returns
SwapSource = Callable[[], tuple[dict, int]]


class RequestTimeout(RuntimeError):
    """The handler thread's wait on its future timed out; the pending
    request (if still queued) was evicted. Maps to HTTP 504."""


# distinct breaker-jitter seeds for apps built in one process
_APP_SEQ = itertools.count(1)
# the longest a handler thread waits for its predict or render
REQUEST_TIMEOUT_S = 300.0


def _decode_image(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _encode_png(frame_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame_u8).save(buf, format="PNG")
    return buf.getvalue()


def _poses_from_body(body: dict) -> np.ndarray:
    """(N, 4, 4) pose stack from a /render body: full poses, or camera-center
    offsets as identity-rotation poses (inference/trajectory.py)."""
    if "poses" in body:
        poses = np.asarray(body["poses"], np.float32)
        if poses.ndim == 2 and poses.shape[1] == 16:
            poses = poses.reshape(-1, 4, 4)
        if poses.ndim != 3 or poses.shape[1:] != (4, 4):
            raise ValueError(f"poses must be (N, 4, 4) (or N x 16 flat), got {poses.shape}")
        return poses
    if "offsets" in body:
        offsets = np.asarray(body["offsets"], np.float64)
        if offsets.ndim != 2 or offsets.shape[1] != 3:
            raise ValueError(f"offsets must be (N, 3), got {offsets.shape}")
        return poses_from_offsets(offsets)
    raise ValueError('render body needs "poses" or "offsets"')


class ServingApp:
    """Engine + cache + batcher + breaker + metrics + tracer + SLO tracker
    (+ the brownout ladder) for one workspace (or one state dict)."""

    def __init__(
        self,
        cfg: Config,
        state_dict: dict | None = None,
        checkpoint_step: int = 0,
        cache_bytes: int = 2 << 30,
        max_delay_ms: float = 4.0,
        max_batch_poses: int = 64,
        fov_deg: float = 90.0,
        allowed_buckets: list[BucketSpec] | None = None,
        trace_enabled: bool = True,
        swap_source: str | SwapSource | None = None,
        device: torch.device | str | None = None,
        engine: RenderEngine | None = None,
        peak_flops_override: float = 0.0,
    ):
        res = cfg.resilience
        self.metrics = ServingMetrics()
        self.breaker = CircuitBreaker(
            failure_threshold=res.breaker_failure_threshold,
            reset_after_s=res.breaker_reset_s,
            reset_jitter=res.breaker_reset_jitter,
            jitter_seed=next(_APP_SEQ),
            on_state=self.metrics.breaker_state.set,
            on_trip=self.metrics.breaker_trips.inc,
        )
        self.deadline_s = res.serve_deadline_s
        self.retry_after_s = res.serve_retry_after_s
        # request spans default on: a span is microseconds against a
        # millisecond render; every span also ticks the trace counter
        self.tracer = Tracer(
            enabled=trace_enabled, max_spans=cfg.obs.trace_buffer_spans,
            on_span=lambda span: self.metrics.trace_spans.inc(cat=span.cat),
        )
        if engine is not None:
            # a prebuilt engine (serving/fake.py's) reports into this app
            engine.metrics, engine.tracer = self.metrics, self.tracer
            self.engine = engine
        else:
            self.engine = RenderEngine(cfg, state_dict, checkpoint_step=checkpoint_step,
                                       metrics=self.metrics, fov_deg=fov_deg,
                                       tracer=self.tracer, device=device,
                                       peak_flops_override=peak_flops_override)
        # device-memory gauges, sampled after each dispatch and on scrape
        self.memlog = MemLog(tracer=self.tracer, live_gauge=self.metrics.hbm_live_bytes,
                             peak_gauge=self.metrics.hbm_peak_bytes, device=self.engine.device)
        self.metrics.weight_generation.set(self.engine.generation)
        # availability and p95 objectives over this registry, on every scrape
        self.slo = tracker_from_config(self.metrics.registry, cfg)
        set_build_info(self.metrics.registry, backend=self.engine.device.type)
        # hot-swap source: a workspace path (POST /admin/swap re-reads its
        # newest checkpoint) or a zero-arg callable returning (state_dict,
        # step); None answers /admin/swap with a 400
        self.swap_source = swap_source
        self._swap_lock = threading.Lock()
        self._swap_status: dict[str, Any] = {
            "state": "idle", "generation": self.engine.generation,
            "checkpoint_step": self.engine.checkpoint_step,
        }
        self._promote_stop = threading.Event()
        self._promote_thread: threading.Thread | None = None
        # shapes an untrusted /predict may ask for: each costs first
        # dispatches and an O(S*H*W) resident MPI, so the operator sets them
        self.allowed_buckets: set[BucketSpec] = {self.engine.default_bucket}
        for spec in allowed_buckets or ():
            self.allowed_buckets.add(tuple(int(v) for v in spec))
        # fleet peer fetch, off until configure_peers names the membership;
        # each fetch is bounded by serving.peer_fetch_timeout_s, and every
        # failure falls through to the local predict
        self.peer_fetch_timeout_s = cfg.serving.peer_fetch_timeout_s
        if self.peer_fetch_timeout_s <= 0:
            raise ValueError(f"serving.peer_fetch_timeout_s={self.peer_fetch_timeout_s} "
                             "must be > 0")
        self.peers: dict[str, str] = {}
        self.peer_name: str | None = None
        self._peer_ring: HashRing | None = None
        # drain shedding (the autoscale retirement): product POSTs answer
        # 503 + Retry-After, GET /mpi/<key> and the admin routes stay served
        self.draining = False
        self.metrics.draining.set(0)
        self.cache = MPICache(cache_bytes, metrics=self.metrics)
        self.batcher = MicroBatcher(
            self._guarded_render, max_delay_ms=max_delay_ms,
            max_batch_poses=max_batch_poses,
            max_queue_requests=res.serve_max_queue_requests,
            metrics=self.metrics, tracer=self.tracer,
        ).start()
        self._started_at = time.time()
        # the brownout ladder, off unless serving.degrade_enabled
        self._last_burn = 0.0  # the worst mine_slo_burn_rate at the last scrape
        self._normal_delay_s = self.batcher.max_delay_s
        self._degraded_delay_s = cfg.serving.degrade_coalesce_delay_ms / 1e3
        self.degrade = (controller_from_config(cfg, on_level=self._apply_degradation)
                        if cfg.serving.degrade_enabled else None)
        self.metrics.degradation_level.set(0)
        # predict singleflight: concurrent misses of one key share one pass
        self._inflight: dict[Any, Future] = {}
        self._inflight_lock = threading.Lock()

    # -- the brownout ladder (serving/degrade.py) -----------------------------

    def _degrade_tick(self) -> int:
        """One ladder observation of the live pressure (queue depth and
        breaker read now, the burn rate of the last scrape); level 0 with
        the ladder off. Called per product request and per /metrics
        scrape, so an idle replica relaxes on the scrape cadence."""
        if self.degrade is None:
            return 0
        return self.degrade.tick(PressureSample(
            queue_frac=self.batcher.queue_frac(),
            burn_rate=self._last_burn,
            breaker_open=self.breaker.state == "open",
        ))

    def _apply_degradation(self, level: int) -> None:
        """The controller's on_level hook (transitions only): L1's
        compression override goes to the engine, L3 widens and any lower
        level restores the batcher's window, for the current queue too."""
        tier = self.degrade.tier_override()
        if tier is not None:
            self.engine.set_degraded_compression(tier, self.degrade.prune_eps_override())
        else:
            self.engine.clear_degraded_compression()
        self.batcher.set_max_delay_s(self._degraded_delay_s if self.degrade.widen_coalesce()
                                     else self._normal_delay_s)
        self.metrics.degradation_level.set(level)

    def slo_scrape(self) -> None:
        """The scrape-cadence SLO refresh and one ladder observation: the
        burn rates just published are the ladder's burn signal until the
        next scrape."""
        report = self.slo.evaluate()
        self._last_burn = max((row["burn_rate"] for row in report.values()), default=0.0)
        self._degrade_tick()

    # -- circuit breaker around the engine ------------------------------------

    def _breaker_guard(self, kind: str, fn, *args):
        """One engine dispatch under the breaker: open -> BreakerOpen without
        touching the card; outcomes feed the state machine. Callers validate
        first, so a failure here is an engine failure."""
        if not self.breaker.allow():
            self.metrics.shed_requests.inc(reason="breaker_open")
            raise BreakerOpen(self.breaker.retry_after_s() or self.retry_after_s)
        try:
            result = fn(*args)
        except BaseException:
            self.metrics.engine_failures.inc(kind=kind)
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        self.memlog.sample()
        return result

    def _guarded_render(self, entry, poses):
        return self._breaker_guard("render", self.engine.render, entry, poses)

    # -- hot checkpoint swap ---------------------------------------------------

    def swap_status(self) -> dict:
        with self._swap_lock:
            return dict(self._swap_status)

    def swap(self, wait: bool = False, step: int | None = None) -> dict:
        """Start a hot swap from `swap_source` on a worker thread (the old
        generation serves meanwhile); `wait` joins it. `step` pins a
        workspace source to a retained step (the promotion watch passes the
        vetted one). Never raises for a failed swap: the status names it and
        mine_serve_swap_failures_total counts it. Raises ValueError only
        when no swap source is configured."""
        if self.swap_source is None:
            raise ValueError("no swap source configured (start the server with a "
                             "--workspace, or pass swap_source=)")
        with self._swap_lock:
            if self._swap_status.get("state") == "in_progress":
                self.metrics.swap_failures.inc(reason="in_progress")
                return dict(self._swap_status)
            self._swap_status = {
                "state": "in_progress", "generation": self.engine.generation,
                "checkpoint_step": self.engine.checkpoint_step, "started_at": time.time(),
            }
            thread = threading.Thread(target=self._run_swap, args=(step,), name="mine-swap",
                                      daemon=True)
            thread.start()
        if wait:
            thread.join()
        return self.swap_status()

    def _load_swap_source(self, step: int | None = None) -> tuple[dict, int]:
        """(state_dict, step) from the configured source; the corrupt
        checkpoint chaos seams fire here."""
        chaos.maybe_raise("corrupt_swap")  # fault seam (resilience/chaos.py)
        if chaos.should("corrupt_ckpt"):
            # a checkpoint whose bytes no longer match its integrity sidecar:
            # the named rejection verify_checkpoint_integrity raises
            raise ckpt.CheckpointCorrupt("chaos-injected corrupt checkpoint",
                                         ["manifest sha256 mismatch (chaos seam)"])
        if callable(self.swap_source):
            return self.swap_source()
        _, state, step = ckpt.load_for_serving(
            self.swap_source, expected_state=self.engine.model.state_dict(), step=step)
        return state, step

    def _run_swap(self, target_step: int | None = None) -> None:
        # the status update is unconditional, so that no escaped exception
        # can leave the state "in_progress" and refuse every later swap
        try:
            outcome = self._swap_attempt(target_step)
        except Exception as exc:  # noqa: BLE001 - the never-wedge backstop
            self.metrics.swap_failures.inc(reason="internal")
            outcome = {"state": "failed", "reason": "internal",
                       "error": f"{type(exc).__name__}: {exc}"}
        with self._swap_lock:
            started = self._swap_status.get("started_at")
            self._swap_status = {
                **outcome,
                "generation": self.engine.generation,
                "checkpoint_step": self.engine.checkpoint_step,
                "duration_s": round(time.time() - started, 3) if started else None,
            }

    def _swap_attempt(self, target_step: int | None) -> dict[str, Any]:
        try:
            state, step = self._load_swap_source(target_step)
        except ckpt.CheckpointCorrupt as exc:
            self.metrics.swap_failures.inc(reason="corrupt")
            return {"state": "failed", "reason": "corrupt",
                    "error": f"{type(exc).__name__}: {exc}"}
        except ckpt.CheckpointTreeMismatch as exc:
            self.metrics.swap_failures.inc(reason="rejected")
            return {"state": "failed", "reason": "rejected",
                    "error": f"{type(exc).__name__}: {exc}"}
        except Exception as exc:  # noqa: BLE001 - named, counted, no 5xx
            self.metrics.swap_failures.inc(reason="load")
            return {"state": "failed", "reason": "load",
                    "error": f"{type(exc).__name__}: {exc}"}
        if int(step) == self.engine.checkpoint_step:
            return {"state": "noop", "note": f"already serving step {step}"}
        try:
            ws = self.engine.swap_weights(state, step)
        except SwapInProgress as exc:
            self.metrics.swap_failures.inc(reason="in_progress")
            return {"state": "failed", "reason": "in_progress", "error": str(exc)}
        except SwapError as exc:
            self.metrics.swap_failures.inc(reason="rejected")
            return {"state": "failed", "reason": "rejected",
                    "error": f"{type(exc).__name__}: {exc}"}
        self.metrics.swaps.inc()
        return {"state": "ok", "swapped_to_step": ws.checkpoint_step}

    def maybe_promote(self) -> dict | None:
        """One promotion check: when the workspace's last_good pointer vets a
        step newer than the serving one, swap to the newest RETAINED step at
        or under the pointer (never a fresher, unvetted checkpoint). Returns
        the swap status when one ran, else None."""
        if not isinstance(self.swap_source, str):
            return None
        pointer = ckpt.last_good_step(self.swap_source)
        if pointer is None or pointer <= self.engine.checkpoint_step:
            return None
        vetted = [s for s in ckpt.all_steps(self.swap_source) if s <= pointer]
        if not vetted or max(vetted) <= self.engine.checkpoint_step:
            return None
        if self.swap_status().get("state") == "in_progress":
            return None
        return self.swap(wait=True, step=max(vetted))

    def start_promotion_watch(self, interval_s: float = 30.0) -> None:
        """Poll the last_good pointer on a daemon thread (--watch-last-good);
        idempotent; stopped by close()."""
        if self._promote_thread is not None:
            return

        def watch():
            while not self._promote_stop.wait(interval_s):
                try:
                    self.maybe_promote()
                except Exception as exc:  # noqa: BLE001 - keep watching
                    print(f"# last_good promotion check failed: {exc}", flush=True)

        self._promote_thread = threading.Thread(target=watch, name="mine-last-good-watch",
                                                daemon=True)
        self._promote_thread.start()

    # -- the product -----------------------------------------------------------

    def predict(self, image_bytes: bytes, spec: BucketSpec | None = None,
                request_id: str | None = None, parent_span: str | None = None) -> dict:
        digest = hashlib.sha256(image_bytes).hexdigest()
        if spec is not None:
            spec = tuple(int(v) for v in spec)
            if spec not in self.allowed_buckets:
                raise ValueError(
                    f"bucket {list(spec)} is not served; allowed: "
                    f"{sorted(list(b) for b in self.allowed_buckets)} "
                    "(extend with --bucket H,W,S at server start)"
                )
        bucket = self.engine.bucket(spec)  # validates the requested shape
        self._degrade_tick()  # this request serves at the level it ticked
        # ONE snapshot keys the cache AND runs the dispatch, so that a
        # new-generation MPI is never filed under the old step's key; the
        # tier and threshold likewise, so that a level flip mid-request
        # never files an int8 entry under an fp32 key
        weights = self.engine.weights()
        tier, prune_eps = self.engine.effective_tier(), self.engine.effective_prune_eps()
        key = mpi_key(digest, weights.checkpoint_step, bucket.spec, tier)

        def response(entry, cached: bool, entry_key=key) -> dict:
            return {
                "mpi_key": key_to_str(entry_key),
                "cached": cached,
                "bucket": list(bucket.spec),
                "planes": bucket.num_planes,
                "planes_kept": (entry.planes_kept if isinstance(entry, CompressedMPI)
                                else bucket.num_planes),
                "tier": entry_key[5],
                "mpi_bytes": entry.nbytes,
            }

        with self.tracer.span("cache_lookup", cat="serve", endpoint="predict",
                              request_id=request_id):
            entry = self.cache.get(key)
        if entry is not None:
            return response(entry, cached=True)
        if self.degrade is not None and self.degrade.serve_stale():
            # L2 stale-while-revalidate: the newest older-step entry of this
            # scene answers, under its own key so that renders hit
            stale = self.cache.stale_key(key)
            old = None if stale is None else self.cache.get(stale, record=False)
            if old is not None:
                return {**response(old, cached=True, entry_key=stale), "stale": True}
        with self._inflight_lock:
            future = self._inflight.get(key)
            owner = future is None
            if owner:
                # the owner publishes to the cache BEFORE dropping its marker,
                # so "no marker" can mean "just finished"
                entry = self.cache.get(key, record=False)
                if entry is not None:
                    return response(entry, cached=True)
                future = Future()
                self._inflight[key] = future
        if not owner:
            try:
                return response(future.result(timeout=REQUEST_TIMEOUT_S), cached=True)
            except FutureTimeout:
                self.metrics.request_timeouts.inc(stage="result")
                raise RequestTimeout(f"predict singleflight wait exceeded "
                                     f"{REQUEST_TIMEOUT_S}s") from None
        try:
            # decode first, outside the breaker and before any peer: bytes
            # that do not decode are the client's fault (400), never an
            # engine failure and never worth a round trip
            image = _decode_image(image_bytes)
            if self.breaker.rejecting():
                self.metrics.shed_requests.inc(reason="breaker_open")
                raise BreakerOpen(self.breaker.retry_after_s() or self.retry_after_s)
            # a peer holding this key hands it over for network bytes
            # instead of an encoder pass, unless the ladder is at L2+
            entry = None
            if self.degrade is None or not self.degrade.skip_peer_fetch():
                entry = self._peer_fetch(key, digest, request_id=request_id,
                                         parent_span=parent_span)
            from_peer = entry is not None
            if entry is None:
                entry = self._breaker_guard("predict", self.engine.predict, image,
                                            bucket.spec, request_id, weights, tier, prune_eps)
            self.cache.put(key, entry)
            future.set_result(entry)
        except BaseException as exc:
            future.set_exception(exc)
            raise
        finally:
            with self._inflight_lock:
                self._inflight.pop(key, None)
        return response(entry, cached=from_peer)

    # -- the fleet wire (serving/fleet.py) ------------------------------------

    def configure_peers(self, peers: dict[str, str] | None, peer_name: str | None) -> None:
        """(Re)declare the fleet membership for peer fetch: `peers` is the
        full membership {name: base_url}, this replica included, and
        `peer_name` this one; None or empty turns it off. The ring is built
        as the router's is, so both order candidates alike. A rejected call
        leaves the previous membership in effect."""
        if not peers:
            self.peers, self.peer_name, self._peer_ring = {}, None, None
            return
        if not peer_name or peer_name not in peers:
            raise ValueError("peer_name must name this replica inside peers "
                             f"(got {peer_name!r}, peers {sorted(peers)})")
        ring = HashRing(list(peers))
        self.peers, self.peer_name, self._peer_ring = dict(peers), peer_name, ring

    def _peer_fetch(self, key, digest: str, request_id: str | None = None,
                    parent_span: str | None = None):
        """Adopt this key's MPI from a replica ahead of this one in the
        digest's candidate order: none when this one owns it (a joiner owns
        its new arc, which reaches it through the pre-warm); an owner that
        left the router's ring but is still up (drained, or ejected by the
        health gate) is just ahead. Returns the
        entry on this engine's device, or None. Never raises: every outcome
        is a counter tick, and a failure falls through to the local predict.
        The GET carries the request's trace context, so the peer records
        its hop under the same request id."""
        # one membership snapshot: configure_peers may swap it meanwhile
        ring, peers, self_name = self._peer_ring, self.peers, self.peer_name
        if ring is None:
            return None
        candidates = ring.candidates(digest)
        try:
            upstream = candidates[:candidates.index(self_name)]
        except ValueError:  # not on the ring: ask the owner
            upstream = candidates[:1]
        if not upstream:
            return None
        key_str = key_to_str(key)
        # one deadline for the owner and one failover together
        deadline = time.monotonic() + self.peer_fetch_timeout_s
        for name in upstream[:2]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            base_url = peers.get(name)
            if base_url is None:
                continue
            hop_id = new_span_id()
            hop_headers: dict[str, str] = {}
            if request_id:
                hop_headers[REQUEST_ID_HEADER] = request_id
                hop_headers[PARENT_SPAN_HEADER] = hop_id
            try:
                with self.tracer.span("peer_fetch", cat="serve", peer=name,
                                      request_id=request_id, span_id=hop_id,
                                      parent_span=parent_span):
                    status, _, body = _urllib_transport(
                        "GET", f"{base_url.rstrip('/')}/mpi/{key_str}", None, hop_headers,
                        remaining)
                if status == 200:
                    entry = from_wire(body)
                    if tuple(entry.bucket) != tuple(key[2:5]):
                        raise ValueError(f"peer {name} returned bucket {entry.bucket} "
                                         f"for key bucket {key[2:5]}")
                    # drift the key does not fence: another full plane count,
                    # or a pruned entry where this replica does not prune
                    # the key's S is the coarse count: a coarse-to-fine
                    # bucket's entries hold S + S_fine planes
                    full = self.engine.bucket(key[2:5]).num_planes
                    if isinstance(entry, CompressedMPI):
                        drifted = (entry.tier != key[5] or entry.num_planes_full != full
                                   or (not self.engine.prune_eps
                                       and entry.planes_kept < entry.num_planes_full))
                    else:
                        drifted = int(entry.mpi_rgb.shape[1]) != full
                    if drifted:
                        self.metrics.peer_fetch.inc(outcome="incompatible")
                        return None
                    entry = self.engine._adopt_entry(entry, request_id=request_id)
                    self.metrics.peer_fetch.inc(outcome="hit")
                    return entry
                outcome = "miss" if status == 404 else "error"
            except TimeoutError:
                outcome = "timeout"
            except Exception:  # noqa: BLE001 - degrade to the local predict
                outcome = "error"
            self.metrics.peer_fetch.inc(outcome=outcome)
        return None

    def set_draining(self, draining: bool) -> None:
        """Flip the drain shedding state (POST /admin/drain); an aborted
        drain flips back with its cache intact."""
        self.draining = bool(draining)
        self.metrics.draining.set(1 if self.draining else 0)

    def prewarm(self, keys: list[str], sources: list[str], timeout_s: float | None = None,
                request_id: str | None = None) -> dict[str, int]:
        """Adopt cached MPIs over the fleet wire before this replica serves
        their traffic: the autoscale join's pre-warm and the drain
        handoff's receiving side. `keys` are wire keys, hottest first;
        `sources` base URLs tried in order per key. Each fetch is bounded by
        the peer-fetch budget and `timeout_s` bounds the pass. Never raises;
        returns the outcome counts (also on mine_serve_prewarm_keys_total)."""
        counts = {"fetched": 0, "resident": 0, "miss": 0, "error": 0}
        deadline = time.monotonic() + timeout_s if timeout_s and timeout_s > 0 else None
        for key_str in keys:
            if deadline is not None and time.monotonic() >= deadline:
                break
            try:
                key = key_from_str(key_str)
            except ValueError:
                counts["error"] += 1
                self.metrics.prewarm_keys.inc(outcome="error")
                continue
            if self.cache.get(key, record=False) is not None:
                counts["resident"] += 1
                self.metrics.prewarm_keys.inc(outcome="resident")
                continue
            outcome = "miss"
            for base_url in sources:
                budget = self.peer_fetch_timeout_s
                if deadline is not None:
                    budget = min(budget, deadline - time.monotonic())
                if budget <= 0:
                    break
                try:
                    with self.tracer.span("prewarm_fetch", cat="serve", request_id=request_id,
                                          key=key_str[:16]):
                        status, _, body = _urllib_transport(
                            "GET", f"{base_url.rstrip('/')}/mpi/{key_str}", None, {}, budget)
                    if status != 200:
                        continue
                    entry = from_wire(body)
                    if tuple(entry.bucket) != tuple(key[2:5]):
                        raise ValueError(f"source returned bucket {entry.bucket} for key "
                                         f"bucket {key[2:5]}")
                    self.cache.put(key, self.engine._adopt_entry(entry, request_id=request_id))
                    outcome = "fetched"
                    break
                except TimeoutError:
                    continue
                except Exception:  # noqa: BLE001 - degrade, never raise
                    outcome = "error"
                    continue
            counts[outcome] += 1
            self.metrics.prewarm_keys.inc(outcome=outcome)
        return counts

    def compressed_blob(self, key_str: str) -> bytes | None:
        """The cached entry for `key_str` as wire bytes, or None. Not a
        client lookup: the hit/miss counters do not move."""
        entry = self.cache.get(key_from_str(key_str), record=False)
        return None if entry is None else to_wire(entry)

    def render(self, key_str: str, poses: np.ndarray, timeout_s: float | None = None,
               request_id: str | None = None) -> tuple[np.ndarray, np.ndarray]:
        key = key_from_str(key_str)
        self._degrade_tick()  # renders feel the queue's pressure first
        with self.tracer.span("cache_lookup", cat="serve", endpoint="render",
                              request_id=request_id):
            entry = self.cache.get(key)
        if entry is None:
            raise KeyError(key_str)
        if self.breaker.rejecting():
            # admission probe only: the half-open trial is spent at dispatch
            self.metrics.shed_requests.inc(reason="breaker_open")
            raise BreakerOpen(self.breaker.retry_after_s() or self.retry_after_s)
        timeout = min(timeout_s if timeout_s and timeout_s > 0 else self.deadline_s,
                      REQUEST_TIMEOUT_S)
        future = self.batcher.submit(key, entry, poses, deadline=time.monotonic() + timeout,
                                     request_id=request_id)
        try:
            return future.result(timeout=timeout)
        except FutureTimeout:
            # evict the pending entry so the worker never renders for a
            # client that gave up; mid-dispatch, the result is dropped
            self.batcher.cancel(future)
            self.metrics.request_timeouts.inc(stage="result")
            raise RequestTimeout(f"render did not complete within {timeout:.1f}s") from None

    def trace_for_request(self, request_id: str) -> dict:
        """One request's spans as Chrome-trace JSON: the handler's spans and
        those of every dispatch that included it."""
        return filter_doc_to_request(self.tracer.to_chrome_trace(), request_id)

    def health(self) -> dict:
        breaker_state = self.breaker.state
        # "degraded" (503) only while OPEN: half-open must answer 200 so the
        # recovery trial can arrive
        status = {"closed": "ok", "half_open": "recovering"}.get(breaker_state, "degraded")
        if self.draining:
            status = "draining"  # out of service for product traffic
        return {
            "status": status,
            "draining": self.draining,
            "uptime_s": round(time.time() - self._started_at, 1),
            "backend": self.engine.device.type,
            "checkpoint_step": self.engine.checkpoint_step,
            "weight_generation": self.engine.generation,
            "swap_state": self.swap_status().get("state", "idle"),
            "buckets": [list(s) for s in self.engine.bucket_specs()],
            "compiles": self.engine.compiles,
            "warm_pool": self.engine.warm_pool(),
            "cache_entries": len(self.cache),
            "cache_bytes_resident": self.cache.bytes_resident,
            "queue_depth": self.batcher.queue_depth(),
            "queue_bound": self.batcher.max_queue_requests,
            "breaker": breaker_state,
            "breaker_trips": self.breaker.trips,
            "degradation": None if self.degrade is None else self.degrade.snapshot(),
            "trace_enabled": self.tracer.enabled,
            "trace_spans_buffered": len(self.tracer),
        }

    def flight_status(self) -> dict:
        """A flight dump's view of the app. It takes none of the engine's
        locks and touches no tensor (a dump from a server wedged on the card
        must not wait on it); the breaker's, the ladder's and the memory
        log's locks are held only for a few statements at a time."""
        return {
            "checkpoint_step": self.engine.checkpoint_step,
            "weight_generation": self.engine.generation,
            "compiles": self.engine.compiles,
            "breaker": self.breaker.state,
            "draining": self.draining,
            "degradation_level": None if self.degrade is None else self.degrade.level,
            "uptime_s": round(time.time() - self._started_at, 1),
            "hbm": self.memlog.last(),
        }

    def close(self) -> None:
        self._promote_stop.set()
        if self._promote_thread is not None:
            self._promote_thread.join(timeout=5)
        self.batcher.stop()


class _BodyTooLarge(Exception):
    """Request body over _Handler.MAX_BODY_BYTES: HTTP 413."""

    def __init__(self, length: int):
        super().__init__(f"request body of {length} bytes exceeds the "
                         f"{_Handler.MAX_BODY_BYTES}-byte limit")


class _Handler(BaseHTTPRequestHandler):
    # one thread per in-flight request; the app is thread-safe
    server: "ServingHTTPServer"
    protocol_version = "HTTP/1.1"
    # a source image (a few MB, 4/3 more as base64) or a pose list (KBs)
    MAX_BODY_BYTES = 64 * 1024 * 1024

    def log_message(self, fmt: str, *args: Any) -> None:  # noqa: A003
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _observe(self, code: int) -> None:
        """Count, time and trace this request once, before its response
        bytes hit the socket: a client that saw its answer finds it counted
        on /metrics and its root span on /debug/trace."""
        if getattr(self, "_observed", True) or not hasattr(self, "_t0"):
            return
        self._observed = True
        app = self.server.app
        app.metrics.requests.inc(endpoint=self._endpoint, status=str(code))
        app.metrics.request_latency.observe(time.monotonic() - self._t0,
                                            endpoint=self._endpoint)
        if self._endpoint not in ("metrics", "healthz", "debug_trace", "debug_hot_keys"):
            # the request's root span; scrape traffic stays out of the ring
            app.tracer.record("request", "serve", self._p0, time.perf_counter(),
                              request_id=self.request_id, endpoint=self._endpoint,
                              status=code, span_id=self._span_id,
                              parent_span=self._parent_span)

    def _degraded_headers(self, app: ServingApp) -> dict[str, str] | None:
        """X-Degraded for a product answer served while the ladder is
        engaged (its level and effective tier), counted per level; None at
        L0 or with the ladder off."""
        degrade = app.degrade
        if degrade is None or degrade.level <= 0:
            return None
        degrade.record_response()
        app.metrics.degradation_responses.inc(level=str(degrade.level))
        return {"X-Degraded": degrade.announcement(app.engine.effective_tier())}

    def _send(self, code: int, payload: bytes, content_type: str,
              extra_headers: dict[str, str] | None = None) -> None:
        self._observe(code)
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        rid = getattr(self, "request_id", None)
        if rid:
            self.send_header(REQUEST_ID_HEADER, rid)
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj: dict,
                   extra_headers: dict[str, str] | None = None) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json", extra_headers)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        if length > self.MAX_BODY_BYTES:
            raise _BodyTooLarge(length)
        return self.rfile.read(length) if length else b""

    def _overload_response(self, exc: Exception) -> int:
        """Admission-control outcomes -> honest HTTP codes: shed -> 503 with
        Retry-After, stopped -> 503, deadline -> 504."""
        app = self.server.app
        if isinstance(exc, (BreakerOpen, QueueFull)):
            retry_after = max(exc.retry_after_s if isinstance(exc, BreakerOpen)
                              else app.retry_after_s, 0.1)
            self._send_json(503, {"error": str(exc), "retry_after_s": retry_after},
                            {"Retry-After": f"{retry_after:.1f}"})
            return 503
        if isinstance(exc, BatcherStopped):
            app.metrics.shed_requests.inc(reason="draining")
            self._send_json(503, {"error": f"{exc} (server stopping)"})
            return 503
        self._send_json(504, {"error": str(exc)})  # DeadlineExceeded, RequestTimeout
        return 504

    def _route(self, method: str, path: str) -> int:
        # each branch sets its endpoint label before it answers, since
        # _observe fires inside _send
        app = self.server.app
        if method == "GET" and path == "/healthz":
            self._endpoint = "healthz"
            health = app.health()
            code = 503 if health["status"] in ("degraded", "draining") else 200
            self._send_json(code, health)
            return code
        if method == "GET" and path == "/metrics":
            self._endpoint = "metrics"
            app.memlog.sample()
            app.engine.publish_cost()
            app.slo_scrape()
            self._send(200, app.metrics.render().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
            return 200
        if method == "GET" and path == "/debug/trace":
            self._endpoint = "debug_trace"
            rid = (parse_qs(self.path.partition("?")[2]).get("request_id") or [None])[0]
            self._send_json(200, app.trace_for_request(rid) if rid else
                            app.tracer.to_chrome_trace(extra_events=app.memlog.counter_events()))
            return 200
        if method == "POST" and path in ("/predict", "/render"):
            self._endpoint = path.lstrip("/")
            if app.draining:
                # the router's cooldown steers the arc to its new owner while
                # /mpi/<key> keeps serving the handoff
                app.metrics.shed_requests.inc(reason="draining")
                retry_after = max(app.retry_after_s, 0.1)
                self._send_json(503, {"error": "replica draining", "retry_after_s": retry_after},
                                {"Retry-After": f"{retry_after:.1f}"})
                return 503
            if path == "/predict":
                return self._predict(app)
            return self._render(app)
        if method == "GET" and path.startswith("/mpi/"):
            self._endpoint = "mpi"
            key_str = path[len("/mpi/"):]
            try:
                blob = app.compressed_blob(key_str)
            except ValueError as exc:
                self._send_json(400, {"error": f"bad mpi key: {exc}"})
                return 400
            if blob is None:
                self._send_json(404, {"error": f"mpi_key {key_str} not cached here"})
                return 404
            self._send(200, blob, "application/octet-stream")
            return 200
        if path == "/admin/swap" and method in ("GET", "POST"):
            self._endpoint = "admin_swap"
            if method == "GET":
                self._send_json(200, app.swap_status())
                return 200
            return self._admin_swap(app)
        if method == "GET" and path == "/debug/hot_keys":
            self._endpoint = "debug_hot_keys"
            try:
                n = int((parse_qs(self.path.partition("?")[2]).get("n") or ["64"])[0])
            except ValueError:
                self._send_json(400, {"error": "n must be an integer"})
                return 400
            self._send_json(200, {"hot_keys": [{"mpi_key": k, "nbytes": b}
                                               for k, b in app.cache.hot_keys(n)]})
            return 200
        if method == "POST" and path in ("/admin/drain", "/admin/peers", "/admin/prewarm"):
            self._endpoint = path[1:].replace("/", "_")
            handler = {"/admin/drain": self._admin_drain, "/admin/peers": self._admin_peers,
                       "/admin/prewarm": self._admin_prewarm}[path]
            return handler(app)
        self._endpoint = "unknown"
        self._send_json(404, {"error": f"no route {method} {path}"})
        return 404

    def _handle(self, method: str) -> None:
        path = self.path.split("?", 1)[0]
        self.request_id = resolve_request_id(self.headers.get(REQUEST_ID_HEADER))
        # this request's root span id, and the upstream hop's
        self._span_id = new_span_id()
        self._parent_span = resolve_parent_span(self.headers.get(PARENT_SPAN_HEADER))
        self._t0 = time.monotonic()
        self._p0 = time.perf_counter()
        self._observed = False
        self._endpoint = path.lstrip("/") or "unknown"
        app = self.server.app
        if chaos.should("overload_spike") and app.degrade is not None:
            # synthetic pressure (resilience/chaos.py): the ladder's next
            # observations classify as breach whatever the real signals say
            app.degrade.inject()
        if chaos.should("replica_kill"):
            # replica death as a router sees it: the listener goes away and
            # this connection drops with no response. shutdown() joins the
            # serve_forever loop this handler runs under, so it runs
            # off-thread.
            def die(srv):
                srv.shutdown()
                srv.server_close()

            threading.Thread(target=die, args=(self.server,), daemon=True).start()
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass
            return
        try:
            code = self._route(method, path)
        except (BrokenPipeError, ConnectionResetError):
            raise
        except _BodyTooLarge as exc:
            # refused without reading the body
            code = 413
            try:
                self._send_json(413, {"error": str(exc)})
            except Exception:  # noqa: BLE001 - client already gone
                pass
        except Exception as exc:  # noqa: BLE001 - HTTP boundary
            code = 500
            try:
                self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception:  # noqa: BLE001 - client already gone
                pass
        # backstop for a response the client never received
        self._observe(code)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        self._handle("GET")

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        self._handle("POST")

    # -- endpoints -----------------------------------------------------------

    def _predict(self, app: ServingApp) -> int:
        rid = self.request_id
        with app.tracer.span("parse", cat="serve", endpoint="predict", request_id=rid):
            body = self._read_body()
            spec = None
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if ctype == "application/json":
                try:
                    req = json.loads(body)
                    image_bytes = base64.b64decode(req["image_b64"])
                    if req.get("bucket") is not None:
                        spec = tuple(int(v) for v in req["bucket"])
                except (KeyError, ValueError, TypeError) as exc:
                    self._send_json(400, {"error": f"bad predict body: {exc}"})
                    return 400
            else:
                image_bytes = body  # raw PNG/JPEG bytes
        if not image_bytes:
            self._send_json(400, {"error": "empty image"})
            return 400
        try:
            with app.tracer.span("predict", cat="serve", request_id=rid):
                result = app.predict(image_bytes, spec, request_id=rid,
                                     parent_span=self._span_id)
        except (BreakerOpen, RequestTimeout) as exc:
            return self._overload_response(exc)
        except (ValueError, OSError) as exc:
            # a bad bucket, or undecodable image bytes (PIL raises OSError)
            self._send_json(400, {"error": str(exc)})
            return 400
        self._send_json(200, result, self._degraded_headers(app))
        return 200

    def _json_body(self, what: str) -> dict | None:
        """The request body as a JSON object, or None after answering 400."""
        try:
            req = json.loads(self._read_body() or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, TypeError) as exc:
            self._send_json(400, {"error": f"bad {what} body: {exc}"})
            return None
        return req

    def _admin_drain(self, app: ServingApp) -> int:
        """{"draining": true|false} flips the drain shedding state."""
        req = self._json_body("drain")
        if req is None:
            return 400
        app.set_draining(bool(req.get("draining", True)))
        self._send_json(200, {"draining": app.draining})
        return 200

    def _admin_peers(self, app: ServingApp) -> int:
        """{"peers": {name: url}, "peer_name": str}: the
        membership the autoscale controller fans out after each change."""
        req = self._json_body("peers")
        if req is None:
            return 400
        try:
            peers = req.get("peers") or None
            if peers is not None and not (
                    isinstance(peers, dict)
                    and all(isinstance(k, str) and isinstance(v, str)
                            for k, v in peers.items())):
                raise ValueError("peers must map name -> base URL")
            app.configure_peers(peers, req.get("peer_name"))
        except (ValueError, TypeError) as exc:
            self._send_json(400, {"error": f"bad peers body: {exc}"})
            return 400
        self._send_json(200, {"peers": sorted(app.peers), "peer_name": app.peer_name})
        return 200

    def _admin_prewarm(self, app: ServingApp) -> int:
        """{"keys": [mpi_key...], "sources": [base_url...], "timeout_s"?}
        -> the outcome counts of ServingApp.prewarm."""
        req = self._json_body("prewarm")
        if req is None:
            return 400
        try:
            keys, sources = req.get("keys") or [], req.get("sources") or []
            if not all(isinstance(k, str) for k in keys) \
                    or not all(isinstance(u, str) for u in sources):
                raise ValueError("keys and sources must be string lists")
            timeout_s = req.get("timeout_s")
            timeout_s = None if timeout_s is None else float(timeout_s)
        except (ValueError, TypeError) as exc:
            self._send_json(400, {"error": f"bad prewarm body: {exc}"})
            return 400
        self._send_json(200, app.prewarm(list(keys), list(sources), timeout_s=timeout_s,
                                         request_id=self.request_id))
        return 200

    def _admin_swap(self, app: ServingApp) -> int:
        """202 + status for an accepted async swap; {"wait": true} blocks
        (200 on a flip or a no-op, 409 when another swap runs, 422 for a
        named rejection or load failure). A failed swap is never a 5xx: the
        old generation is still serving."""
        req = self._json_body("swap")
        if req is None:
            return 400
        wait = bool(req.get("wait"))
        try:
            status = app.swap(wait=wait)
        except ValueError as exc:  # no swap source configured
            self._send_json(400, {"error": str(exc)})
            return 400
        code = {
            "ok": 200, "noop": 200, "idle": 200,
            "in_progress": 409 if wait else 202,
            "failed": 409 if status.get("reason") == "in_progress" else 422,
        }.get(status.get("state"), 200)
        self._send_json(code, status)
        return code

    def _render(self, app: ServingApp) -> int:
        rid = self.request_id
        try:
            with app.tracer.span("parse", cat="serve", endpoint="render", request_id=rid):
                req = json.loads(self._read_body())
                key_str = req["mpi_key"]
                key_from_str(key_str)  # a malformed key is a 400, not a 500
                poses = _poses_from_body(req)
                timeout_s = req.get("timeout_s")
                if timeout_s is not None:
                    timeout_s = float(timeout_s)
        except (KeyError, ValueError, TypeError) as exc:
            self._send_json(400, {"error": f"bad render body: {exc}"})
            return 400
        try:
            rgb, disp = app.render(key_str, poses, timeout_s=timeout_s, request_id=rid)
        except (BreakerOpen, QueueFull, BatcherStopped, DeadlineExceeded,
                RequestTimeout) as exc:
            return self._overload_response(exc)
        except KeyError:
            self._send_json(404, {"error": f"mpi_key {key_str} not cached (evicted or never "
                                           "predicted): POST /predict again"})
            return 404
        with app.tracer.span("encode", cat="serve", frames=int(rgb.shape[0]),
                             request_id=rid):
            out: dict[str, Any] = {
                "mpi_key": key_str,
                "num_frames": int(rgb.shape[0]),
                "height": int(rgb.shape[1]),
                "width": int(rgb.shape[2]),
                "frames_png_b64": [base64.b64encode(_encode_png(f)).decode()
                                   for f in to_uint8(np.clip(rgb, 0.0, 1.0))],
            }
            if req.get("include_disparity"):
                out["disparity_png_b64"] = [
                    base64.b64encode(_encode_png(f)).decode()
                    for f in to_uint8(normalize_disparity(disp))[..., 0]
                ]
        self._send_json(200, out, self._degraded_headers(app))
        return 200


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the listen backlog: with socketserver's default of 5, a burst of 8
    # concurrent clients ended in a connection reset on an H100 host
    request_queue_size = 128

    def __init__(self, addr: tuple[str, int], app: ServingApp, verbose: bool = False):
        super().__init__(addr, _Handler)
        self.app = app
        self.verbose = verbose


def make_server(app: ServingApp, host: str = "127.0.0.1", port: int = 0,
                verbose: bool = False) -> ServingHTTPServer:
    """Bind (port 0 -> ephemeral; server.server_address reports it); the
    caller drives serve_forever(), usually on a thread."""
    return ServingHTTPServer((host, port), app, verbose=verbose)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workspace", required=True,
                        help="training workspace dir (params.yaml + checkpoints/)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--cache-mb", type=int, default=2048, help="MPI cache budget in MiB")
    parser.add_argument("--max-delay-ms", type=float, default=4.0,
                        help="micro-batching max coalescing delay")
    parser.add_argument("--max-batch-poses", type=int, default=64)
    parser.add_argument("--bucket", action="append", default=[], metavar="H,W,S",
                        help="additional (H, W, S) shape bucket /predict may ask for "
                             "(repeatable; the config's own shape is always served)")
    parser.add_argument("--zoo-buckets", action="store_true",
                        help="allow the pretrained-zoo shapes "
                             "(data/conformance/contract.py ZOO_BUCKETS), warmed at start")
    parser.add_argument("--fov", type=float, default=90.0)
    parser.add_argument("--extra_config", default=None,
                        help="JSON dot-key overrides on top of the archived params.yaml")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the first dispatches of the allowed buckets before binding")
    parser.add_argument("--allow-random-init", action="store_true",
                        help="serve seeded untrained weights when no checkpoint exists "
                             "(smoke runs only)")
    parser.add_argument("--no-trace", action="store_true",
                        help="disable request-lifecycle host spans")
    parser.add_argument("--peer", action="append", default=[], metavar="NAME=URL",
                        help="fleet peer replica (repeatable; include this replica too and "
                             "name it with --peer-name): a local cache miss asks the "
                             "digest's ring owner for the MPI before running the encoder")
    parser.add_argument("--peer-name", default=None,
                        help="this replica's name inside the --peer set")
    parser.add_argument("--watch-last-good", type=float, default=0.0, metavar="SECS",
                        help="poll the workspace's last_good pointer every SECS seconds and "
                             "hot-swap to newer vetted checkpoints (0 disables)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--peak-flops", type=float, default=0.0,
                        help="peak FLOP/s the MFU gauge divides by when the card has no "
                             "published table row (obs/cost.py), e.g. a CPU smoke")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    peers = {}
    for spec in args.peer:
        name, _, url = spec.partition("=")
        if not name or not url:
            parser.error(f"--peer must be NAME=URL, got {spec!r}")
        peers[name] = url
    if peers and args.peer_name not in peers:
        parser.error(f"--peer-name must name this replica inside the --peer set "
                     f"(got {args.peer_name!r}, peers {sorted(peers)})")

    device = resolve_device(args.device)  # no CUDA and no --device cpu: raise first
    cfg, state, step = ckpt.load_for_serving(args.workspace, overrides=args.extra_config,
                                             allow_random_init=args.allow_random_init)
    extra_buckets = [tuple(int(v) for v in spec.split(",")) for spec in args.bucket]
    if args.zoo_buckets:
        from mine_tpu_torch.data.conformance.contract import ZOO_BUCKETS

        extra_buckets.extend(ZOO_BUCKETS)
    app = ServingApp(cfg, state, checkpoint_step=step, cache_bytes=args.cache_mb << 20,
                     max_delay_ms=args.max_delay_ms, max_batch_poses=args.max_batch_poses,
                     fov_deg=args.fov, allowed_buckets=extra_buckets,
                     trace_enabled=not args.no_trace, swap_source=args.workspace,
                     device=device, peak_flops_override=args.peak_flops)
    app.configure_peers(peers, args.peer_name)
    # SIGUSR1/SIGTERM dump stacks, the last request spans and the card's
    # memory statistics (no stall watchdog: an idle server is healthy)
    flight = FlightRecorder(os.path.join(args.workspace, "flight"), tracer=app.tracer,
                            get_status=app.flight_status).start()
    if args.watch_last_good > 0:
        app.start_promotion_watch(interval_s=args.watch_last_good)
    if not args.no_warmup:
        built = app.engine.warmup(specs=sorted(app.allowed_buckets))
        print(f"warmup: {built} first dispatches (buckets {sorted(app.allowed_buckets)})",
              flush=True)
    server = make_server(app, args.host, args.port, verbose=args.verbose)
    host, port = server.server_address[:2]
    print(f"serving checkpoint step {step} on http://{host}:{port} "
          "(/predict /render /healthz /metrics /debug/trace)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        app.close()
        flight.stop()


if __name__ == "__main__":
    main()
