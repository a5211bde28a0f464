"""Multi-replica fleet front: digest-affinity routing over health-gated
replicas (the port's own copy of mine_tpu/serving/fleet.py).

One encoder pass amortizes over every render of its image, but only on the
replica holding the cached MPI. So the fleet routes by the image digest (the
first component of every mpi_key) over a consistent-hash ring: repeats of an
image land on one replica, and a membership change remaps only the arc of
the member that came or went.

  HashRing     consistent hashing with virtual nodes; `candidates(digest)`
               is the failover order (owner first, then the next distinct
               members clockwise).
  HealthGate   per-replica hysteresis: `down_after` consecutive failures
               eject, `up_after` consecutive successes readmit.
  FleetApp     forwarding with bounded failover on connect errors and 503s
               (a 503's Retry-After opens a per-replica cooldown), the
               remaining deadline passed to each attempt (expiry is a 504),
               `mine_fleet_*` metrics, an aggregated /healthz, /admin/swap
               fan-out, the merged /debug/trace?request_id= (obs/collect.py)
               and an SLO tracker over the router's own families.
  FleetHTTPServer / main()  the HTTP surface and its CLI,
               `python -m mine_tpu_torch.serving.fleet --replica NAME=URL ...`;
               `... fleet trace` is the offline trace collector.

Routing never touches pixels: a fleet answer is byte-identical to the
owning replica's.
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import http.client
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs
from typing import Any, Callable

from mine_tpu_torch.obs import collect
from mine_tpu_torch.obs.ledger import set_build_info
from mine_tpu_torch.obs.slo import SLOTracker, default_objectives
from mine_tpu_torch.obs.trace import (
    PARENT_SPAN_HEADER,
    REQUEST_ID_HEADER,
    TRACE_TOKEN_RE,
    Tracer,
    filter_doc_to_request,
    new_span_id,
    resolve_parent_span,
    resolve_request_id,
)
from mine_tpu_torch.utils.metrics import MetricsRegistry


class NoHealthyReplica(RuntimeError):
    """Every candidate was down/cooling/exhausted — maps to HTTP 503."""

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"no replica available; retry after {retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s


class FleetDeadlineExceeded(RuntimeError):
    """The request's deadline expired before any replica answered — 504."""


def _point(name: str) -> int:
    return int.from_bytes(
        hashlib.sha256(name.encode()).digest()[:8], "big"
    )


# THE vnode count, and no option: the router's ring and every replica's
# peer ring (server.py configure_peers) are built with it, so the two order
# failover and peer-fetch candidates alike and a "fetch from the owner"
# asks the owner.
DEFAULT_VNODES = 64


class HashRing:
    """Consistent-hash ring with virtual nodes (replicated hash points per
    member smooth the arc distribution, the classic Karger construction).
    Immutable once built — membership changes build a new ring, so readers
    never see a half-updated point list."""

    def __init__(self, members: list[str]):
        self.members = sorted(set(members))
        points: list[tuple[int, str]] = []
        for m in self.members:
            for v in range(DEFAULT_VNODES):
                points.append((_point(f"{m}#{v}"), m))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._owners = [p[1] for p in points]

    def candidates(self, digest: str) -> list[str]:
        """Every member, ordered by ring distance from the digest's point:
        the owner first, then the failover sequence. Deterministic for a
        given membership, so retries and cache affinity agree."""
        if not self.members:
            return []
        start = bisect.bisect_left(self._hashes, _point(digest))
        seen: list[str] = []
        n = len(self._owners)
        for i in range(n):
            owner = self._owners[(start + i) % n]
            if owner not in seen:
                seen.append(owner)
                if len(seen) == len(self.members):
                    break
        return seen


class HealthGate:
    """Hysteresis for one replica's membership: state flips DOWN only after
    `down_after` consecutive bad observations and back UP only after
    `up_after` consecutive good ones. Probe results and request-path
    connect errors feed the same gate."""

    def __init__(self, up_after: int = 2, down_after: int = 2,
                 healthy: bool = True):
        self.healthy = healthy
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self._good = 0
        self._bad = 0

    def observe(self, ok: bool) -> bool:
        """Feed one observation; returns True when the state FLIPPED."""
        if ok:
            self._good += 1
            self._bad = 0
            if not self.healthy and self._good >= self.up_after:
                self.healthy = True
                return True
        else:
            self._bad += 1
            self._good = 0
            if self.healthy and self._bad >= self.down_after:
                self.healthy = False
                return True
        return False


class Replica:
    def __init__(self, name: str, base_url: str, up_after: int,
                 down_after: int):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.gate = HealthGate(up_after=up_after, down_after=down_after)
        self.not_before = 0.0  # Retry-After cooldown (router clock)
        self.last_probe: dict | None = None
        # last X-Degraded level this replica announced (0 = full fidelity;
        # serving/degrade.py) — refreshed on every answered forward, fed
        # into the fleet-wide mine_fleet_degradation_level gauge
        self.degraded_level = 0


def _urllib_transport(
    method: str, url: str, body: bytes | None, headers: dict[str, str],
    timeout_s: float,
) -> tuple[int, dict[str, str], bytes]:
    """Default transport: (status, headers, body). HTTP error statuses are
    RETURNED (they are answers); transport-level failures raise — a
    TimeoutError when the attempt's time budget ran out (the REPLICA may be
    fine, the budget wasn't), a ConnectionError for everything that means
    the replica is unreachable (the failover + health-gate signal)."""
    import socket

    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()
    except socket.timeout as err:  # raised mid-read (body stalled)
        raise TimeoutError(str(err)) from err
    except urllib.error.URLError as err:
        if isinstance(err.reason, (socket.timeout, TimeoutError)):
            raise TimeoutError(str(err.reason)) from err
        # unwrap to a transport failure the forward loop can failover on
        raise ConnectionError(str(err.reason)) from err
    except http.client.HTTPException as err:
        # a replica dying MID-RESPONSE (IncompleteRead after headers,
        # BadStatusLine on a half-written status) is a connect-class
        # failure for the router — it must fail over + feed the health
        # gate, not escape as a router 500. (RemoteDisconnected happens to
        # be a ConnectionResetError too, but its siblings are not OSError.)
        raise ConnectionError(f"{type(err).__name__}: {err}") from err


class FleetMetrics:
    """mine_fleet_* families on the shared registry."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self.requests = r.counter(
            "mine_fleet_requests_total",
            "router responses by endpoint and status code",
        )
        self.request_latency = r.histogram(
            "mine_fleet_request_latency_seconds",
            "router-side request wall time by endpoint",
        )
        self.routed = r.counter(
            "mine_fleet_routed_total",
            "upstream dispatches by replica (first attempts + failovers)",
        )
        self.failovers = r.counter(
            "mine_fleet_failovers_total",
            "attempts abandoned for the next candidate, by reason "
            "(connect_error|unavailable_503|attempt_timeout)",
        )
        self.no_replica = r.counter(
            "mine_fleet_no_replica_total",
            "requests answered 503 because every candidate was "
            "down/cooling/exhausted",
        )
        self.replica_up = r.gauge(
            "mine_fleet_replica_up",
            "health-gated ring membership by replica (1 in, 0 out)",
        )
        self.ring_size = r.gauge(
            "mine_fleet_ring_size", "replicas currently in the ring",
        )
        self.ring_transitions = r.counter(
            "mine_fleet_ring_transitions_total",
            "hysteresis state flips by replica and direction (to=up|down)",
        )
        self.probes = r.counter(
            "mine_fleet_probes_total",
            "health probes by replica and outcome (ok|fail)",
        )
        self.ring_changes = r.counter(
            "mine_fleet_ring_changes_total",
            "explicit membership changes by op (join|leave) — autoscale/"
            "admin admissions and retirements, distinct from the health "
            "gate's hysteresis flips (ring_transitions)",
        )
        self.autoscale_decisions = r.counter(
            "mine_fleet_autoscale_decisions_total",
            "controller tick decisions by action "
            "(hold|scale_up|scale_down|cooldown|at_min|at_max)",
        )
        self.autoscale_events = r.counter(
            "mine_fleet_autoscale_events_total",
            "completed scale events by direction (join|drain) and outcome "
            "(ok|aborted|handoff_aborted)",
        )
        self.autoscale_target = r.gauge(
            "mine_fleet_autoscale_target_replicas",
            "the autoscale controller's current desired replica count",
        )
        self.degradation_level = r.gauge(
            "mine_fleet_degradation_level",
            "worst brownout-ladder level any ring replica last announced "
            "via X-Degraded (serving/degrade.py; 0 = full fidelity)",
        )

    def render(self) -> str:
        return self.registry.render()


class FleetApp:
    """Routing + health state for one fleet; transport and clock are
    injectable so the state machines are unit-testable without sockets."""

    def __init__(
        self,
        replicas: dict[str, str] | list[str],
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 2.0,
        up_after: int = 2,
        down_after: int = 2,
        max_attempts: int = 3,
        deadline_s: float = 30.0,
        retry_after_s: float = 1.0,
        metrics: FleetMetrics | None = None,
        transport: Callable | None = None,
        clock: Callable[[], float] = time.monotonic,
        trace_enabled: bool = True,
        trace_buffer_spans: int = 4096,
        slo_objectives: Any = None,
    ):
        if isinstance(replicas, list):
            replicas = {f"r{i}": url for i, url in enumerate(replicas)}
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.metrics = metrics if metrics is not None else FleetMetrics()
        # router-side spans: every forwarded hop (and every failover
        # attempt) is a span carrying the request's trace context, so the
        # router's /debug/trace ring holds ITS half of every request tree
        self.tracer = Tracer(enabled=trace_enabled,
                             max_spans=trace_buffer_spans)
        # SLO layer (obs/slo.py): availability + p95 over the router's own
        # request families, evaluated on every /metrics scrape
        self.slo = SLOTracker(
            self.metrics.registry,
            slo_objectives if slo_objectives is not None
            else default_objectives(family_prefix="mine_fleet"),
            clock=clock,
        )
        set_build_info(self.metrics.registry, backend=None)
        self.up_after = up_after
        self.down_after = down_after
        self.replicas = {
            name: Replica(name, url, up_after, down_after)
            for name, url in replicas.items()
        }
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.max_attempts = max(1, int(max_attempts))
        self.deadline_s = float(deadline_s)
        self.retry_after_s = float(retry_after_s)
        self.transport = transport if transport is not None else _urllib_transport
        self.clock = clock
        self._lock = threading.Lock()
        self._ring = HashRing(list(self.replicas))  # guarded-by: _lock
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        self._started_at = time.time()
        for name in self.replicas:
            self.metrics.replica_up.set(1, replica=name)
        self.metrics.ring_size.set(len(self.replicas))

    # -- ring membership -------------------------------------------------------

    def ring_members(self) -> list[str]:
        with self._lock:
            return list(self._ring.members)

    def add_replica(self, name: str, base_url: str) -> Replica:
        """Admit a NEW replica into the live membership (an autoscale
        join). The caller is responsible for having the replica
        request-ready first — pre-warmed cache, warm pools — because the
        moment this returns, its arc's traffic routes to it. Membership
        mutates by whole-dict replacement so concurrent iterators
        (probe_once, swap_all, health) only ever see a complete
        membership, never a half-built one."""
        with self._lock:
            if name in self.replicas:
                raise ValueError(f"replica {name!r} is already in the fleet")
            replica = Replica(name, base_url, self.up_after, self.down_after)
            self.replicas = {**self.replicas, name: replica}
            self._rebuild_ring_locked()
            self.metrics.ring_changes.inc(op="join")
        return replica

    def remove_replica(self, name: str) -> None:
        """Retire a replica from the live membership (an autoscale drain's
        last step). Its arc remaps to the ring neighbors — ONE arc, the
        consistent-hash contract. Refuses to empty the fleet: a routerful
        of nothing answers 503 forever with no path back."""
        with self._lock:
            if name not in self.replicas:
                raise ValueError(f"replica {name!r} is not in the fleet")
            remaining = {k: v for k, v in self.replicas.items() if k != name}
            if not remaining:
                raise ValueError(
                    "refusing to remove the last replica — an empty fleet "
                    "cannot recover"
                )
            self.replicas = remaining
            self._rebuild_ring_locked()
            self.metrics.replica_up.set(0, replica=name)
            self.metrics.ring_changes.inc(op="leave")

    def _rebuild_ring_locked(self) -> None:
        """Rebuild the ring from the healthy members. Caller holds _lock."""
        members = [r.name for r in self.replicas.values() if r.gate.healthy]
        self._ring = HashRing(members)
        for r in self.replicas.values():
            self.metrics.replica_up.set(
                1 if r.gate.healthy else 0, replica=r.name
            )
        self.metrics.ring_size.set(len(members))

    def _observe(self, replica: Replica, ok: bool) -> None:
        """Feed one health observation (probe or request-path); rebuild the
        ring on a hysteresis flip."""
        with self._lock:
            flipped = replica.gate.observe(ok)
            if flipped:
                self._rebuild_ring_locked()
                self.metrics.ring_transitions.inc(
                    replica=replica.name,
                    to="up" if replica.gate.healthy else "down",
                )

    def _republish_degradation(self) -> None:
        """Fleet-wide brownout visibility: the worst ladder level any
        replica last announced — via X-Degraded on a forwarded response
        or its /healthz degradation snapshot — is the autoscaler's
        scale-up signal."""
        with self._lock:
            self.metrics.degradation_level.set(max(
                (r.degraded_level for r in self.replicas.values()),
                default=0,
            ))

    def probe_once(self) -> dict[str, bool]:
        """One /healthz sweep over every replica (in or out of the ring —
        ejected replicas must keep being probed to ever rejoin)."""
        results: dict[str, bool] = {}
        for replica in list(self.replicas.values()):
            try:
                status, _, body = self.transport(
                    "GET", replica.base_url + "/healthz", None, {},
                    self.probe_timeout_s,
                )
                ok = status == 200
                replica.last_probe = {"status": status}
                try:
                    replica.last_probe.update(json.loads(body))
                except ValueError:
                    pass
                else:
                    # an idle replica announces recovery through its
                    # /healthz degradation snapshot — without this, the
                    # level last seen on a forwarded response would stay
                    # stale (and hold the fleet gauge up) until the next
                    # product request happened to land there
                    deg = replica.last_probe.get("degradation")
                    if isinstance(deg, dict):
                        replica.degraded_level = int(deg.get("level") or 0)
                        self._republish_degradation()
            except Exception as exc:  # noqa: BLE001 - a probe may die anyhow
                ok = False
                replica.last_probe = {"error": f"{type(exc).__name__}: {exc}"}
            self.metrics.probes.inc(replica=replica.name,
                                    outcome="ok" if ok else "fail")
            self._observe(replica, ok)
            results[replica.name] = ok
        return results

    def start(self) -> "FleetApp":
        if self._probe_thread is None:
            def loop():
                while not self._probe_stop.wait(self.probe_interval_s):
                    self.probe_once()

            self._probe_thread = threading.Thread(
                target=loop, name="mine-fleet-probe", daemon=True
            )
            self._probe_thread.start()
        return self

    def close(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)

    # -- forwarding ------------------------------------------------------------

    def candidates_for(self, digest: str) -> list[Replica]:
        with self._lock:
            names = self._ring.candidates(digest)
            replicas = self.replicas
        # membership may have changed between a racing reader's ring
        # snapshot and here; a just-removed name is simply not a candidate
        return [replicas[n] for n in names if n in replicas]

    def forward(
        self,
        digest: str,
        method: str,
        path: str,
        body: bytes | None,
        headers: dict[str, str],
        timeout_s: float | None = None,
        request_id: str | None = None,
        parent_span: str | None = None,
    ) -> tuple[int, dict[str, str], bytes, str]:
        """Route one request by digest with bounded failover.

        Walks the ring's candidate order (owner first), skipping replicas
        inside a Retry-After cooldown. Each attempt gets the REMAINING
        deadline budget. Failover happens on transport errors and 503s
        (the replica is shedding — its Retry-After opens the cooldown);
        every other status, including 404/504/500, is the replica's honest
        ANSWER and passes through (re-dispatching a 404 elsewhere cannot
        find an MPI that only the owner would have had).

        Trace context: every attempt (first dispatch AND each failover
        retry) records a router span with a fresh span_id and sends the
        replica `X-Request-Id: request_id` + `X-Parent-Span: <span_id>`,
        so the replica's spans hang off exactly the attempt that reached
        it and a failed attempt is visible as a childless span.

        Returns (status, headers, body, replica_name). Raises
        NoHealthyReplica (-> 503) or FleetDeadlineExceeded (-> 504).
        """
        deadline = self.clock() + (
            timeout_s if timeout_s and timeout_s > 0 else self.deadline_s
        )
        candidates = self.candidates_for(digest)
        if not candidates:
            self.metrics.no_replica.inc()
            raise NoHealthyReplica(self.retry_after_s)
        min_cooldown = None
        attempts = 0
        for replica in candidates:
            if attempts >= self.max_attempts:
                break
            now = self.clock()
            if replica.not_before > now:
                min_cooldown = (replica.not_before - now
                                if min_cooldown is None
                                else min(min_cooldown,
                                         replica.not_before - now))
                continue
            remaining = deadline - now
            if remaining <= 0:
                raise FleetDeadlineExceeded(
                    f"deadline expired after {attempts} attempt(s)"
                )
            attempts += 1
            self.metrics.routed.inc(replica=replica.name)
            span_id = new_span_id()
            send_headers = dict(headers)
            if request_id:
                send_headers[REQUEST_ID_HEADER] = request_id
                send_headers[PARENT_SPAN_HEADER] = span_id
            span = self.tracer.span(
                "forward", cat="fleet", request_id=request_id,
                replica=replica.name, path=path, attempt=attempts,
                span_id=span_id, parent_span=parent_span,
            )
            try:
                with span:
                    status, resp_headers, resp_body = self.transport(
                        method, replica.base_url + path, body, send_headers,
                        remaining,
                    )
                    if hasattr(span, "args"):  # live span: the answer
                        span.args["status"] = status
            except TimeoutError:
                # the ATTEMPT's budget ran out, not necessarily the
                # replica: a busy-but-healthy replica under an impatient
                # client deadline must NOT be ejected (losing its arc
                # cold-misses its whole MPI cache) — the probe loop, with
                # its own timeout, is the judge of replica health. Fail
                # over with whatever budget remains. (TimeoutError is an
                # OSError subclass — this clause must come first.)
                self.metrics.failovers.inc(reason="attempt_timeout")
                continue
            except (ConnectionError, OSError):
                # transport failure: feed the hysteresis gate (2 of these
                # eject the replica without waiting for the probe loop) and
                # fail over
                self._observe(replica, False)
                self.metrics.failovers.inc(reason="connect_error")
                continue
            if status == 503:
                # the replica is shedding (queue full / breaker open /
                # draining): honor its Retry-After as a cooldown so the
                # ring does not hammer a replica that asked for air.
                # Deliberately NEUTRAL for the health gate — neither a
                # connect failure nor a success that could mask the probe
                # loop's degraded verdict (the probe reads /healthz 503
                # as down; a render 503 must not keep resetting that).
                retry_after = _parse_retry_after(resp_headers)
                replica.not_before = self.clock() + retry_after
                min_cooldown = (retry_after if min_cooldown is None
                                else min(min_cooldown, retry_after))
                self.metrics.failovers.inc(reason="unavailable_503")
                continue
            # any other answered request is evidence of life: reset the
            # gate's failure streak so two SPORADIC connect errors with
            # hundreds of successes in between cannot eject the replica
            # (the hysteresis contract is about consecutive signal)
            self._observe(replica, True)
            # fleet-wide brownout visibility: every answered forward
            # refreshes the replica's announced ladder level (absence of
            # X-Degraded IS the L0 announcement) and republishes the worst
            # level across the fleet — the autoscaler's scale-up signal
            replica.degraded_level = _parse_degraded_level(resp_headers)
            self._republish_degradation()
            return status, resp_headers, resp_body, replica.name
        if self.clock() >= deadline:
            raise FleetDeadlineExceeded(
                f"deadline expired after {attempts} attempt(s)"
            )
        self.metrics.no_replica.inc()
        raise NoHealthyReplica(
            min_cooldown if min_cooldown is not None else self.retry_after_s
        )

    # -- fleet-wide operations -------------------------------------------------

    def health(self) -> dict:
        members = self.ring_members()
        return {
            "status": "ok" if members else "degraded",
            "uptime_s": round(time.time() - self._started_at, 1),
            "ring_size": len(members),
            "replicas": {
                r.name: {
                    "base_url": r.base_url,
                    "in_ring": r.gate.healthy,
                    "last_probe": r.last_probe,
                }
                for r in self.replicas.values()
            },
        }

    def aggregated_trace(self, request_id: str,
                         timeout_s: float | None = None) -> dict:
        """GET /debug/trace?request_id= across the WHOLE fleet: the
        router's own spans for this request plus every replica's
        /debug/trace?request_id= ring, merged into one skew-annotated
        Chrome-trace doc with per-process lanes and the cross-process hop
        tree in metadata (obs/collect.py). Unreachable replicas are named
        in metadata, never silently missing."""
        timeout = timeout_s if timeout_s else self.probe_timeout_s

        def fetch(url: str, t: float) -> dict:
            # ride the app's transport so tests inject fakes and the
            # error taxonomy matches every other router-replica call
            status, _, body = self.transport("GET", url, None, {}, t)
            if status != 200:
                raise RuntimeError(f"/debug/trace answered {status}")
            return json.loads(body)

        return collect.collect_fleet_trace(
            {r.name: r.base_url for r in self.replicas.values()},
            request_id=request_id,
            # the router's OWN lane is filtered to the request too —
            # replicas answer pre-filtered, and a busy router's ring
            # holds every other request's spans, which must not leak
            # into this request's merged doc
            local={"name": "router", "doc": filter_doc_to_request(
                self.tracer.to_chrome_trace(), request_id
            )},
            timeout_s=timeout,
            fetch_fn=fetch,
        )

    def swap_all(self, wait: bool = True,
                 timeout_s: float = 600.0,
                 request_id: str | None = None,
                 parent_span: str | None = None) -> dict[str, dict]:
        """Fan POST /admin/swap out to EVERY configured replica
        (sequentially: a rolling upgrade — at most one replica is warming a
        generation at a time, the rest serve). Deliberately not limited to
        ring members: a replica the health gate has temporarily ejected
        (shedding under load) would otherwise rejoin serving STALE weights
        with nothing to reconcile it — an unreachable replica simply
        reports its transport error. Returns per-replica outcomes, each
        tagged `in_ring`; a replica "succeeded" only when its swap status
        says so (state ok/noop), never on a bare 202 (a refused concurrent
        swap also answers in_progress)."""
        payload = json.dumps({"wait": wait}).encode()
        results: dict[str, dict] = {}
        in_ring = set(self.ring_members())
        for name, replica in self.replicas.items():
            span_id = new_span_id()
            headers = {"Content-Type": "application/json"}
            if request_id:
                # the fan-out carries the trace context too: a rolling
                # fleet upgrade is one request whose hops are the replicas
                headers[REQUEST_ID_HEADER] = request_id
                headers[PARENT_SPAN_HEADER] = span_id
            span = self.tracer.span(
                "swap_fanout", cat="fleet", request_id=request_id,
                replica=name, span_id=span_id, parent_span=parent_span,
            )
            try:
                with span:
                    status, _, body = self.transport(
                        "POST", replica.base_url + "/admin/swap", payload,
                        headers, timeout_s,
                    )
                try:
                    results[name] = {"status": status, **json.loads(body)}
                except ValueError:
                    results[name] = {"status": status}
            except Exception as exc:  # noqa: BLE001 - per-replica verdicts
                results[name] = {"error": f"{type(exc).__name__}: {exc}"}
            results[name]["in_ring"] = name in in_ring
        return results


def _parse_retry_after(headers: dict[str, str]) -> float:
    for key, value in headers.items():
        if key.lower() == "retry-after":
            try:
                return max(0.1, float(value))
            except ValueError:
                break
    return 1.0


def _parse_degraded_level(headers: dict[str, str]) -> int:
    """The ladder level out of an `X-Degraded: level=<n>;tier=<t>` header
    (serving/degrade.py announcement); 0 when absent or malformed — a
    replica that says nothing is serving at full fidelity."""
    for key, value in headers.items():
        if key.lower() == "x-degraded":
            for part in value.split(";"):
                name, _, val = part.strip().partition("=")
                if name == "level":
                    try:
                        return max(0, int(val))
                    except ValueError:
                        return 0
    return 0


def digest_of_request(path: str, body: bytes,
                      content_type: str) -> tuple[str, float | None]:
    """(routing digest, body-declared timeout_s) for one fleet request.

    /predict: sha256 of the IMAGE BYTES — the same digest the replica
    computes for its cache key, so the ring sends repeats of one image to
    one replica. /render: the digest component of the mpi_key (minted by a
    /predict this router routed, so it lands on the replica holding the
    MPI). /mpi/<key>: the key's digest — the compressed-container fetch
    (serving/compress.py wire) routes to the owner exactly like the
    renders that hit its cache."""
    if path == "/predict":
        if content_type == "application/json":
            req = json.loads(body)
            import base64

            image_bytes = base64.b64decode(req["image_b64"])
            return (hashlib.sha256(image_bytes).hexdigest(),
                    _float_or_none(req.get("timeout_s")))
        return hashlib.sha256(body).hexdigest(), None
    if path == "/render":
        req = json.loads(body)
        digest = str(req["mpi_key"]).split(":", 1)[0]
        return digest, _float_or_none(req.get("timeout_s"))
    if path.startswith("/mpi/") and len(path) > len("/mpi/"):
        return path[len("/mpi/"):].split(":", 1)[0], None
    raise ValueError(f"unroutable path {path}")


def _float_or_none(v: Any) -> float | None:
    try:
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


class _FleetHandler(BaseHTTPRequestHandler):
    server: "FleetHTTPServer"
    protocol_version = "HTTP/1.1"

    _FORWARD_HEADERS = ("Content-Type",)

    def log_message(self, fmt: str, *args: Any) -> None:  # noqa: A003
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: bytes, content_type: str,
              extra: dict[str, str] | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        rid = getattr(self, "request_id", None)
        if rid and not (extra and REQUEST_ID_HEADER in extra):
            # every router response names its request — the id keys the
            # aggregated /debug/trace?request_id= lookup
            self.send_header(REQUEST_ID_HEADER, rid)
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj: dict,
                   extra: dict[str, str] | None = None) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json", extra)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def _route(self, method: str, path: str) -> tuple[int, str]:
        app = self.server.app
        if method == "GET" and path == "/healthz":
            health = app.health()
            code = 200 if health["status"] == "ok" else 503
            self._send_json(code, health)
            return code, "healthz"
        if method == "GET" and path == "/metrics":
            # SLO gauges refresh on scrape cadence, like everything else
            # on the page (obs/slo.py)
            app.slo.evaluate()
            self._send(200, app.metrics.render().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
            return 200, "metrics"
        if method == "GET" and path == "/debug/trace":
            query = parse_qs(self.path.partition("?")[2])
            rid = (query.get("request_id") or [None])[0]
            if rid and not TRACE_TOKEN_RE.match(rid):
                # the query-param path gets the SAME charset guard as
                # the header path: a malformed id interpolated into K
                # replica fetch URLs would fail every fetch and read as
                # a fleet-wide outage instead of the client error it is
                self._send_json(400, {
                    "error": f"malformed request_id {rid[:64]!r}",
                })
                return 400, "debug_trace"
            if rid:
                # fleet-wide: router spans + every replica's ring for
                # this request, merged with per-process lanes
                self._send_json(200, app.aggregated_trace(rid))
            else:
                self._send_json(200, app.tracer.to_chrome_trace())
            return 200, "debug_trace"
        if method == "POST" and path == "/admin/swap":
            body = self._read_body()
            wait = True
            try:
                if body:
                    wait = bool(json.loads(body).get("wait", True))
            except ValueError:
                pass
            results = app.swap_all(
                wait=wait, request_id=self.request_id,
                parent_span=self._span_id,
            )
            # with wait (the default), success means the swap RESOLVED on
            # every in-ring replica — a 202/in_progress is not a flip.
            # Out-of-ring replicas are best-effort (reported, not gating):
            # an unreachable one cannot fail a fleet upgrade it never saw.
            done_states = ("ok", "noop") if wait else ("ok", "noop",
                                                       "in_progress")
            ok = all(
                r.get("state") in done_states
                for r in results.values() if r.get("in_ring")
            )
            self._send_json(200 if ok else 422, {"replicas": results})
            return 200 if ok else 422, "admin_swap"
        if method == "POST" and path in ("/predict", "/render"):
            return self._forward(app, path), path.lstrip("/")
        if method == "GET" and path.startswith("/mpi/"):
            # compressed-MPI fetch routes to the key's owner like a render
            return self._forward(app, path, method="GET"), "mpi"
        self._send_json(404, {"error": f"no route {method} {path}"})
        return 404, "unknown"

    def _forward(self, app: FleetApp, path: str, method: str = "POST") -> int:
        body = self._read_body() if method == "POST" else None
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        try:
            digest, timeout_s = digest_of_request(path, body or b"", ctype)
        except (ValueError, KeyError, TypeError) as exc:
            self._send_json(400, {"error": f"unroutable request: {exc}"})
            return 400
        headers = {
            k: self.headers[k] for k in self._FORWARD_HEADERS
            if self.headers.get(k)
        }
        try:
            status, resp_headers, resp_body, replica = app.forward(
                digest, method, path, body, headers, timeout_s=timeout_s,
                request_id=self.request_id, parent_span=self._span_id,
            )
        except NoHealthyReplica as exc:
            retry_after = max(exc.retry_after_s, 0.1)
            self._send_json(
                503, {"error": str(exc), "retry_after_s": retry_after},
                {"Retry-After": f"{retry_after:.1f}"},
            )
            return 503
        except FleetDeadlineExceeded as exc:
            self._send_json(504, {"error": str(exc)})
            return 504
        extra = {"X-Mine-Replica": replica}
        for k, v in resp_headers.items():
            # X-Degraded passes through untouched: a client of the ROUTER
            # still learns its answer was served degraded (and at what
            # level/tier) exactly as a direct-replica client would
            if k.lower() in ("retry-after", "x-request-id", "x-degraded"):
                extra[k] = v
        self._send(status, resp_body,
                   resp_headers.get("Content-Type", "application/json"),
                   extra)
        return status

    def _handle(self, method: str) -> None:
        app = self.server.app
        path = self.path.split("?", 1)[0]
        # trace context off the headers — the ONE resolve implementation
        # shared with the replica server (obs/trace.py)
        self.request_id = resolve_request_id(
            self.headers.get(REQUEST_ID_HEADER)
        )
        # the router-side root of this request's span tree: forward /
        # swap_fanout spans point at it via parent_span, and an upstream
        # caller's X-Parent-Span (if any) becomes ITS parent
        self._span_id = new_span_id()
        client_parent = resolve_parent_span(
            self.headers.get(PARENT_SPAN_HEADER)
        )
        t0 = time.monotonic()
        p0 = time.perf_counter()
        try:
            code, endpoint = self._route(method, path)
        except (BrokenPipeError, ConnectionResetError):
            raise
        except Exception as exc:  # noqa: BLE001 - HTTP boundary
            code, endpoint = 500, path.lstrip("/") or "unknown"
            try:
                self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception:  # noqa: BLE001 - client already gone
                pass
        if endpoint not in ("metrics", "healthz", "debug_trace"):
            # scrape/introspection traffic stays out of the ring — the
            # trace exists for routed product requests
            app.tracer.record(
                "request", "fleet", p0, time.perf_counter(),
                request_id=self.request_id, endpoint=endpoint,
                status=code, span_id=self._span_id,
                parent_span=client_parent,
            )
        app.metrics.requests.inc(endpoint=endpoint, status=str(code))
        app.metrics.request_latency.observe(
            time.monotonic() - t0, endpoint=endpoint
        )

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        self._handle("GET")

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        self._handle("POST")


class FleetHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr: tuple[str, int], app: FleetApp,
                 verbose: bool = False):
        super().__init__(addr, _FleetHandler)
        self.app = app
        self.verbose = verbose


def make_fleet_server(
    app: FleetApp, host: str = "127.0.0.1", port: int = 0,
    verbose: bool = False,
) -> FleetHTTPServer:
    return FleetHTTPServer((host, port), app, verbose=verbose)


def _parse_members(specs: list[str]) -> dict[str, str]:
    """--replica values (URL or NAME=URL) -> {name: url}."""
    members: dict[str, str] = {}
    for i, spec in enumerate(specs):
        name, sep, url = spec.partition("=")
        if sep and not name.startswith("http"):
            members[name] = url
        else:
            members[f"r{i}"] = spec
    return members


def trace_main(argv: list[str]) -> None:
    """`python -m mine_tpu_torch.serving.fleet trace`: pull /debug/trace from
    every member (replicas and/or the router), estimate per-member clock
    skew from the probe round trips, and write ONE merged Chrome-trace
    JSON with per-process lanes, openable in Perfetto. With --request-id,
    the doc is filtered to that request and carries its cross-process hop
    tree in metadata."""
    parser = argparse.ArgumentParser(
        prog="fleet trace", description=trace_main.__doc__
    )
    parser.add_argument(
        "--replica", action="append", default=[], metavar="[NAME=]URL",
        help="member to pull /debug/trace from (repeatable); include the "
        "router's URL to get its lane too",
    )
    parser.add_argument("--request-id", default=None,
                        help="filter to one request + build its hop tree")
    parser.add_argument("--timeout", type=float, default=5.0)
    parser.add_argument("--out", default=None,
                        help="write the merged trace here (default: stdout)")
    args = parser.parse_args(argv)
    if not args.replica:
        parser.error("at least one --replica URL is required")
    if args.request_id and not TRACE_TOKEN_RE.match(args.request_id):
        parser.error(f"malformed --request-id {args.request_id[:64]!r} "
                     "(allowed: [A-Za-z0-9._-], max 128 chars)")
    doc = collect.collect_fleet_trace(
        _parse_members(args.replica), request_id=args.request_id,
        timeout_s=args.timeout,
    )
    meta = doc["metadata"]
    summary = {
        "members": {
            name: ({"error": m["error"]} if "error" in m else {
                "skew_s": (round(m["skew_s"], 6)
                           if m.get("skew_s") is not None else None),
                "rtt_s": round(m.get("rtt_s") or 0.0, 6),
            })
            for name, m in meta["members"].items()
        },
        "events": sum(1 for ev in doc["traceEvents"]
                      if ev.get("ph") == "X"),
    }
    if args.request_id:
        tree = meta.get("request_tree", {})
        summary["request_id"] = args.request_id
        summary["span_count"] = tree.get("span_count", 0)
        summary["processes"] = tree.get("processes", [])
        summary["tree_depth"] = collect.tree_depth(tree.get("tree", []))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh)
        summary["out"] = args.out
        print(json.dumps(summary))
    else:
        print(json.dumps(doc))
        print(json.dumps(summary), file=sys.stderr)


def main(argv: list[str] | None = None) -> None:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        return trace_main(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--replica", action="append", default=[], metavar="[NAME=]URL",
        help="replica (repeatable), e.g. r0=http://10.0.0.5:8000; NAME must "
        "be that replica's --peer-name (a bare URL is named r<position>)",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8800)
    parser.add_argument("--probe-interval", type=float, default=2.0)
    parser.add_argument("--max-attempts", type=int, default=3)
    parser.add_argument("--deadline", type=float, default=30.0)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    if not args.replica:
        parser.error("at least one --replica URL is required")
    app = FleetApp(
        _parse_members(args.replica), probe_interval_s=args.probe_interval,
        max_attempts=args.max_attempts, deadline_s=args.deadline,
    ).start()
    server = make_fleet_server(app, args.host, args.port,
                               verbose=args.verbose)
    host, port = server.server_address[:2]
    print(f"fleet router over {len(args.replica)} replicas on "
          f"http://{host}:{port} (/predict /render /healthz /metrics "
          f"/admin/swap /debug/trace)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        app.close()


if __name__ == "__main__":
    main()
