"""SLO-driven elastic fleet: the autoscaling controller (the port's own copy
of mine_tpu/serving/autoscale.py).

The controller scrapes the fleet router's /metrics page on an interval and
reads three signals: `mine_slo_burn_rate` (1.0 = eating the error budget at
exactly its rate), the router's p95 from the
`mine_fleet_request_latency_seconds` histogram, and
`mine_fleet_degradation_level` (the worst brownout level a replica
announced: sustained degradation is overload even while every answer is a
200). It scales up after `up_after` consecutive breached ticks and down
after `down_after` consecutive calm ones (every burn rate under the down
threshold and the fleet back at L0); a cooldown separates events, and the
membership stays within [min_replicas, max_replicas].

The scale events are cache-aware, since a membership change moves cache
arcs and a cold arc is an encoder bill the fleet already paid once:

  JOIN   spawn -> pre-warm -> admit. The joiner's future arc is computed on
         the candidate ring (the members and itself); it fetches the hot
         keys it will own from their current owners over GET /mpi/<key>,
         and only then enters the ring. A join past `join_timeout_s` is
         retired unadmitted.
  DRAIN  shed -> hand off -> leave. The newest member sheds product POSTs
         (503 + Retry-After: the router fails over) while its /mpi wire
         stays up, its hot entries are pushed to their owners on the
         survivor ring, then it leaves the ring and is retired. A handoff
         past `drain_timeout_s` is abandoned; the drain still completes.

Chaos seams (resilience/chaos.py): `join_stall` raises inside the Nth join's
pre-warm (the joiner is retired, membership unchanged), `drain_timeout`
inside the Nth drain's handoff (the drain completes regardless).

Replicas live behind a pool: InProcessPool (ServingApps behind their own
HTTP servers in this process) or SubprocessPool (`python -m
mine_tpu_torch.serving` replica processes), both with

    spawn() -> (name, base_url)        a replica not yet admitted
    retire(name)                       tear one down
    names() -> [name, ...]             in spawn order
    urls() -> {name: base_url}
    hot_keys(name, n) -> [(key, nbytes), ...]   hottest first
    prewarm(name, keys, sources, timeout_s) -> outcome counts
    set_draining(name, flag)
    configure_peers(members)           every managed replica's peer ring
    close()

CLI: `python -m mine_tpu_torch.serving.autoscale --workspace W` brings up an
elastic fleet of replica subprocesses behind one router and runs the
controller loop against it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from typing import Any, Callable

from mine_tpu_torch.config import Config
from mine_tpu_torch.obs.slo import (
    burn_rates_from_exposition,
    degradation_from_exposition,
    p95_from_exposition,
)
from mine_tpu_torch.resilience import chaos
from mine_tpu_torch.serving.fleet import (
    FleetApp,
    HashRing,
    _urllib_transport,
    make_fleet_server,
)


def routing_digest(key_str: str) -> str:
    """The ring-routing digest of a wire mpi_key — its first `:` field,
    exactly what fleet.digest_of_request extracts from /mpi/<key> and
    /render paths (so pre-warm placement agrees with request routing)."""
    return key_str.split(":", 1)[0]


# -- replica pools -----------------------------------------------------------


class _InProcReplica:
    __slots__ = ("app", "server", "thread", "url")

    def __init__(self, app: Any, server: Any, thread: threading.Thread,
                 url: str):
        self.app = app
        self.server = server
        self.thread = thread
        self.url = url


class InProcessPool:
    """A pool of in-process ServingApps made by `app_factory` (FakeEngine
    apps in the tests), each behind its own ephemeral-port HTTP server: the
    wire surfaces (peer fetch, pre-warm, drain shedding) are the real
    ones."""

    def __init__(self, app_factory: Callable[[], Any],
                 host: str = "127.0.0.1", name_prefix: str = "r"):
        self.app_factory = app_factory
        self.host = host
        self.name_prefix = name_prefix
        self._lock = threading.Lock()
        self._next = 0  # guarded-by: _lock
        self._replicas: dict[str, _InProcReplica] = {}  # guarded-by: _lock
        self._order: list[str] = []  # guarded-by: _lock

    def spawn(self) -> tuple[str, str]:
        from mine_tpu_torch.serving.server import make_server

        with self._lock:
            name = f"{self.name_prefix}{self._next}"
            self._next += 1
        app = self.app_factory()
        server = make_server(app, self.host, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True,
                                  name=f"pool-{name}")
        thread.start()
        h, p = server.server_address[:2]
        url = f"http://{h}:{p}"
        with self._lock:
            self._replicas = {
                **self._replicas, name: _InProcReplica(app, server, thread, url),
            }
            self._order = [*self._order, name]
        return name, url

    def retire(self, name: str) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            self._replicas = {
                k: v for k, v in self._replicas.items() if k != name
            }
            self._order = [n for n in self._order if n != name]
        if rep is None:
            return
        rep.server.shutdown()
        rep.server.server_close()
        rep.app.close()

    def names(self) -> list[str]:
        with self._lock:
            return list(self._order)

    def urls(self) -> dict[str, str]:
        with self._lock:
            return {n: self._replicas[n].url for n in self._order}

    def app(self, name: str):
        """The managed ServingApp, for introspection (metrics, cache);
        not part of the pool interface."""
        with self._lock:
            return self._replicas[name].app

    def hot_keys(self, name: str, n: int) -> list[tuple[str, int]]:
        with self._lock:
            rep = self._replicas[name]
        return rep.app.cache.hot_keys(n)

    def prewarm(self, name: str, keys: list[str], sources: list[str],
                timeout_s: float | None = None) -> dict[str, int]:
        with self._lock:
            rep = self._replicas[name]
        return rep.app.prewarm(list(keys), list(sources), timeout_s=timeout_s)

    def set_draining(self, name: str, draining: bool) -> None:
        with self._lock:
            rep = self._replicas[name]
        rep.app.set_draining(draining)

    def configure_peers(self, members: dict[str, str]) -> None:
        with self._lock:
            managed = dict(self._replicas)
        for name, rep in managed.items():
            if name in members:
                rep.app.configure_peers(dict(members), name)

    def close(self) -> None:
        for name in reversed(self.names()):
            self.retire(name)


_BOUND_RE = re.compile(r"serving checkpoint step \d+ on (http://\S+)")


# the checkout whose package the replica processes import
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class SubprocessPool:
    """A pool of `python -m mine_tpu_torch.serving` replica processes.
    spawn() parses the bound URL off the server's startup line; the rest
    drives the replica's admin surface (/debug/hot_keys, /admin/prewarm,
    /admin/drain, /admin/peers). `server_args` go to every replica's CLI
    (`--device cpu` off the card); `env`, when given, is every replica's
    environment (a chaos drill's MINE_TPU_FAULTS, for one)."""

    def __init__(self, workspace: str, host: str = "127.0.0.1",
                 server_args: list[str] | None = None,
                 name_prefix: str = "s", spawn_timeout_s: float = 120.0,
                 request_timeout_s: float = 10.0,
                 transport: Callable | None = None,
                 env: dict[str, str] | None = None):
        self.workspace = workspace
        self.host = host
        self.server_args = list(server_args or [])
        self.env = None if env is None else dict(env)
        self.name_prefix = name_prefix
        self.spawn_timeout_s = spawn_timeout_s
        self.request_timeout_s = request_timeout_s
        self.transport = transport if transport is not None else _urllib_transport
        self._lock = threading.Lock()
        self._next = 0  # guarded-by: _lock
        self._procs: dict[str, subprocess.Popen] = {}  # guarded-by: _lock
        self._urls: dict[str, str] = {}  # guarded-by: _lock
        self._order: list[str] = []  # guarded-by: _lock

    def spawn(self) -> tuple[str, str]:
        with self._lock:
            name = f"{self.name_prefix}{self._next}"
            self._next += 1
        cmd = [
            sys.executable, "-m", "mine_tpu_torch.serving",
            "--workspace", self.workspace,
            "--host", self.host, "--port", "0", *self.server_args,
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=_REPO_ROOT, env=self.env,
        )
        # a watchdog kills the child if it never prints its bound URL —
        # readline then hits EOF and the spawn fails loudly instead of
        # hanging the controller
        timer = threading.Timer(self.spawn_timeout_s, proc.kill)
        timer.daemon = True
        timer.start()
        url = None
        try:
            for line in proc.stdout:
                m = _BOUND_RE.search(line)
                if m:
                    url = m.group(1).rstrip("/")
                    break
        finally:
            timer.cancel()
        if url is None:
            proc.kill()
            proc.wait(timeout=10)
            raise RuntimeError(
                f"replica {name} exited (or timed out after "
                f"{self.spawn_timeout_s}s) before binding"
            )
        # keep draining the child's stdout so its pipe never fills
        threading.Thread(
            target=self._drain_stdout, args=(proc,), daemon=True,
            name=f"pool-{name}-stdout",
        ).start()
        with self._lock:
            self._procs = {**self._procs, name: proc}
            self._urls = {**self._urls, name: url}
            self._order = [*self._order, name]
        return name, url

    @staticmethod
    def _drain_stdout(proc: subprocess.Popen) -> None:
        for _line in proc.stdout:
            pass

    def retire(self, name: str) -> None:
        with self._lock:
            proc = self._procs.get(name)
            self._procs = {k: v for k, v in self._procs.items() if k != name}
            self._urls = {k: v for k, v in self._urls.items() if k != name}
            self._order = [n for n in self._order if n != name]
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._order)

    def pid(self, name: str) -> int:
        with self._lock:
            return self._procs[name].pid

    def urls(self) -> dict[str, str]:
        with self._lock:
            return dict(self._urls)

    def _base_url(self, name: str) -> str:
        with self._lock:
            return self._urls[name]

    def _call(self, url: str, method: str = "GET",
              payload: dict | None = None) -> dict:
        body = None if payload is None else json.dumps(payload).encode("utf-8")
        headers = {"Content-Type": "application/json"} if body else {}
        status, _, raw = self.transport(
            method, url, body, headers, self.request_timeout_s,
        )
        if status != 200:
            raise RuntimeError(
                f"{method} {url} answered {status}: {raw[:200]!r}"
            )
        return json.loads(raw.decode("utf-8")) if raw else {}

    def hot_keys(self, name: str, n: int) -> list[tuple[str, int]]:
        data = self._call(f"{self._base_url(name)}/debug/hot_keys?n={int(n)}")
        return [
            (d["mpi_key"], int(d["nbytes"])) for d in data["hot_keys"]
        ]

    def prewarm(self, name: str, keys: list[str], sources: list[str],
                timeout_s: float | None = None) -> dict[str, int]:
        payload: dict[str, Any] = {
            "keys": list(keys), "sources": list(sources),
        }
        if timeout_s is not None:
            payload["timeout_s"] = float(timeout_s)
        return self._call(
            f"{self._base_url(name)}/admin/prewarm", "POST", payload,
        )

    def set_draining(self, name: str, draining: bool) -> None:
        self._call(
            f"{self._base_url(name)}/admin/drain", "POST",
            {"draining": bool(draining)},
        )

    def configure_peers(self, members: dict[str, str]) -> None:
        for name in self.names():
            if name in members:
                self._call(
                    f"{self._base_url(name)}/admin/peers", "POST",
                    {"peers": dict(members), "peer_name": name},
                )

    def close(self) -> None:
        for name in reversed(self.names()):
            self.retire(name)


# -- the controller ----------------------------------------------------------


class AutoscaleController:
    """SLO signals -> membership changes, with hysteresis + cooldown.

    tick() never raises: a scrape failure is a `hold` decision, a failed
    join/drain is recorded on mine_fleet_autoscale_events_total and the
    next tick tries again. scale_to(n) is the deterministic entry point;
    tick() is what the interval loop (start()) drives. The clock is injectable so hysteresis and
    cooldown are unit-testable without sleeping."""

    def __init__(
        self,
        fleet: FleetApp,
        pool: Any,
        scrape: Callable[[], str] | str | None = None,
        *,
        min_replicas: int = 2,
        max_replicas: int = 6,
        interval_s: float = 10.0,
        up_burn_threshold: float = 1.0,
        down_burn_threshold: float = 0.25,
        up_after: int = 2,
        down_after: int = 5,
        cooldown_s: float = 60.0,
        prewarm_keys: int = 64,
        join_timeout_s: float = 30.0,
        drain_timeout_s: float = 30.0,
        p95_up_threshold_s: float | None = None,
        degrade_up_level: int = 0,
        scrape_timeout_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]"
            )
        self.fleet = fleet
        self.pool = pool
        self.scrape = scrape
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.up_burn_threshold = float(up_burn_threshold)
        self.down_burn_threshold = float(down_burn_threshold)
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.cooldown_s = float(cooldown_s)
        self.prewarm_keys = int(prewarm_keys)
        self.join_timeout_s = float(join_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.p95_up_threshold_s = p95_up_threshold_s
        # brownout coupling (serving/degrade.py): a fleet-wide ladder
        # level >= this sustains a breach — degraded fidelity is capacity
        # debt the slow path (more replicas) pays back; 0 disables
        self.degrade_up_level = int(degrade_up_level)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.clock = clock
        # _lock guards the decision state (cheap, never held over I/O);
        # _scale_lock serializes whole scale EVENTS (network-bearing:
        # spawn, pre-warm, handoff) so tick() and scale_to() never
        # interleave two membership changes
        self._lock = threading.Lock()
        self._scale_lock = threading.Lock()
        self._breach_ticks = 0  # guarded-by: _lock
        self._calm_ticks = 0  # guarded-by: _lock
        self._last_event_at: float | None = None  # guarded-by: _lock
        self._last_burns: dict[str, float] = {}  # guarded-by: _lock
        self._last_p95: float | None = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fleet.metrics.autoscale_target.set(len(self.fleet.replicas))

    # -- signals -------------------------------------------------------------

    def _scrape_text(self) -> str:
        scrape = self.scrape
        if callable(scrape):
            return scrape()
        if isinstance(scrape, str):
            status, _, body = _urllib_transport(
                "GET", scrape, None, {}, self.scrape_timeout_s,
            )
            if status != 200:
                raise ConnectionError(f"scrape {scrape} answered {status}")
            return body.decode("utf-8", "replace")
        # no scrape target: read the co-located router's registry the way
        # its /metrics endpoint would (SLO gauges refreshed first)
        self.fleet.slo.evaluate()
        return self.fleet.metrics.render()

    # -- decisions -----------------------------------------------------------

    def tick(self, now: float | None = None) -> dict:
        """One control-loop iteration: scrape, decide, maybe scale.
        Returns the decision record; never raises."""
        now = self.clock() if now is None else now
        try:
            text = self._scrape_text()
        except (TimeoutError, ConnectionError, OSError):
            # no signal is not a reason to move the fleet
            self.fleet.metrics.autoscale_decisions.inc(action="hold")
            return {"action": "hold", "reason": "scrape_failed"}
        burns = burn_rates_from_exposition(text)
        p95 = p95_from_exposition(text)
        level = degradation_from_exposition(text)
        with self._scale_lock:
            current = len(self.fleet.replicas)
            with self._lock:
                action = self._decide_locked(burns, p95, level, current, now)
            self.fleet.metrics.autoscale_decisions.inc(action=action)
            record = {
                "action": action, "replicas": current,
                "burn_rates": burns, "router_p95_s": p95,
                "degradation_level": level,
            }
            if action == "scale_up":
                record["ok"] = self._join_locked()
            elif action == "scale_down":
                record["ok"] = self._drain_locked()
            record["replicas_after"] = len(self.fleet.replicas)
        return record

    def _decide_locked(self, burns: dict[str, float], p95: float | None,
                       level: float | None, current: int, now: float) -> str:
        breach = any(
            b >= self.up_burn_threshold for b in burns.values()
        )
        if (not breach and self.p95_up_threshold_s is not None
                and p95 is not None):
            breach = p95 >= self.p95_up_threshold_s
        if (not breach and self.degrade_up_level > 0 and level is not None):
            # sustained brownout IS overload even while every request still
            # answers 200 — the ladder bought availability by spending
            # fidelity; scaling up is what buys the fidelity back
            breach = level >= self.degrade_up_level
        calm = not breach and all(
            b <= self.down_burn_threshold for b in burns.values()
        )
        if calm and self.degrade_up_level > 0 and level is not None:
            # no scale-DOWN while any replica is still degraded: L0
            # stability is the all-clear, shrinking a browned-out fleet
            # would re-trigger the ladder it just climbed down from
            calm = level <= 0
        if breach:
            self._breach_ticks += 1
            self._calm_ticks = 0
        elif calm:
            self._calm_ticks += 1
            self._breach_ticks = 0
        else:
            self._breach_ticks = 0
            self._calm_ticks = 0
        self._last_burns = dict(burns)
        self._last_p95 = p95
        in_cooldown = (
            self._last_event_at is not None
            and now - self._last_event_at < self.cooldown_s
        )
        if self._breach_ticks >= self.up_after:
            if current >= self.max_replicas:
                return "at_max"
            if in_cooldown:
                return "cooldown"
            self._breach_ticks = 0
            return "scale_up"
        if self._calm_ticks >= self.down_after:
            if current <= self.min_replicas:
                return "at_min"
            if in_cooldown:
                return "cooldown"
            self._calm_ticks = 0
            return "scale_down"
        return "hold"

    def status(self) -> dict:
        with self._lock:
            return {
                "replicas": len(self.fleet.replicas),
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "breach_ticks": self._breach_ticks,
                "calm_ticks": self._calm_ticks,
                "burn_rates": dict(self._last_burns),
                "router_p95_s": self._last_p95,
            }

    def _mark_event(self) -> None:
        with self._lock:
            self._last_event_at = self.clock()

    # -- scale events --------------------------------------------------------

    def scale_to(self, n: int) -> int:
        """Drive membership to n (clamped to [min, max]) through the same
        join/drain protocols a tick would use; returns the final count."""
        with self._scale_lock:
            n = max(self.min_replicas, min(self.max_replicas, int(n)))
            while len(self.fleet.replicas) < n:
                if not self._join_locked():
                    break
            while len(self.fleet.replicas) > n:
                if not self._drain_locked():
                    break
            return len(self.fleet.replicas)

    def _membership(self) -> dict[str, str]:
        # fleet.replicas is replaced wholesale under the fleet lock, so
        # iterating the grabbed reference is a consistent snapshot
        reps = self.fleet.replicas
        return {name: r.base_url for name, r in reps.items()}

    def _join_locked(self) -> bool:
        """spawn -> pre-warm -> admit. Caller holds _scale_lock. A joiner
        that fails ANY step before admission is retired — the ring (and
        the peer maps) never saw it."""
        try:
            name, url = self.pool.spawn()
        except Exception:
            self.fleet.metrics.autoscale_events.inc(
                direction="join", outcome="aborted")
            return False
        try:
            deadline = self.clock() + self.join_timeout_s
            chaos.maybe_raise("join_stall")  # fault seam (resilience/chaos.py)
            members = self._membership()
            candidate = HashRing([*members, name])
            for owner, owner_url in members.items():
                budget = deadline - self.clock()
                if budget <= 0:
                    raise TimeoutError("join pre-warm budget exhausted")
                hot = self.pool.hot_keys(owner, self.prewarm_keys)
                arc = [
                    k for k, _nbytes in hot
                    if candidate.candidates(routing_digest(k))[0] == name
                ]
                if arc:
                    self.pool.prewarm(name, arc, [owner_url],
                                      timeout_s=budget)
        except Exception:
            self.pool.retire(name)
            self.fleet.metrics.autoscale_events.inc(
                direction="join", outcome="aborted")
            return False
        # peers first, ring last: the joiner is fully wired before the
        # router remaps its arc onto it
        self.pool.configure_peers({**members, name: url})
        self.fleet.add_replica(name, url)
        self.fleet.metrics.autoscale_events.inc(
            direction="join", outcome="ok")
        self.fleet.metrics.autoscale_target.set(len(self.fleet.replicas))
        self._mark_event()
        return True

    def _drain_locked(self) -> bool:
        """shed -> hand off -> leave. Caller holds _scale_lock. The drain
        ALWAYS completes once shedding starts — a handoff failure only
        costs the cache warmth, never the membership change."""
        members = self._membership()
        managed = [n for n in self.pool.names() if n in members]
        if not managed:
            self.fleet.metrics.autoscale_events.inc(
                direction="drain", outcome="aborted")
            return False
        victim = managed[-1]  # newest join drains first
        victim_url = members[victim]
        survivors = {n: u for n, u in members.items() if n != victim}
        if not survivors:
            self.fleet.metrics.autoscale_events.inc(
                direction="drain", outcome="aborted")
            return False
        self.pool.set_draining(victim, True)
        outcome = "ok"
        try:
            deadline = self.clock() + self.drain_timeout_s
            chaos.maybe_raise("drain_timeout")  # fault seam (resilience/chaos.py)
            ring = HashRing(list(survivors))
            by_owner: dict[str, list[str]] = {}
            for k, _nbytes in self.pool.hot_keys(victim, self.prewarm_keys):
                owner = ring.candidates(routing_digest(k))[0]
                by_owner.setdefault(owner, []).append(k)
            for owner, arc in by_owner.items():
                budget = deadline - self.clock()
                if budget <= 0:
                    raise TimeoutError("drain handoff budget exhausted")
                self.pool.prewarm(owner, arc, [victim_url], timeout_s=budget)
        except Exception:
            # the arc stays cold on the new owners; survivors peer-fetch
            # from whoever has each entry, and only then re-predict
            outcome = "handoff_aborted"
        self.fleet.remove_replica(victim)
        self.pool.configure_peers(survivors)
        self.pool.retire(victim)
        self.fleet.metrics.autoscale_events.inc(
            direction="drain", outcome=outcome)
        self.fleet.metrics.autoscale_target.set(len(self.fleet.replicas))
        self._mark_event()
        return True

    # -- interval loop -------------------------------------------------------

    def start(self) -> "AutoscaleController":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="autoscale",
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def controller_from_config(
    fleet: FleetApp,
    pool: Any,
    cfg: Config,
    scrape: Callable[[], str] | str | None = None,
    clock: Callable[[], float] = time.monotonic,
) -> AutoscaleController:
    """An AutoscaleController from the one config spelling
    (serving.autoscale_* in configs/default.yaml). The p95 up-signal
    ceiling is the latency SLO itself (serving.slo_p95_ms)."""
    s = cfg.serving
    return AutoscaleController(
        fleet, pool, scrape,
        min_replicas=s.autoscale_min_replicas,
        max_replicas=s.autoscale_max_replicas,
        interval_s=s.autoscale_interval_s,
        up_burn_threshold=s.autoscale_up_burn_threshold,
        down_burn_threshold=s.autoscale_down_burn_threshold,
        up_after=s.autoscale_up_after,
        down_after=s.autoscale_down_after,
        cooldown_s=s.autoscale_cooldown_s,
        prewarm_keys=s.autoscale_prewarm_keys,
        join_timeout_s=s.autoscale_join_timeout_s,
        drain_timeout_s=s.autoscale_drain_timeout_s,
        p95_up_threshold_s=s.slo_p95_ms / 1000.0,
        degrade_up_level=s.degrade_scaleup_level,
        clock=clock,
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="elastic fleet: replica subprocesses behind one "
        "router, membership driven by the SLO autoscale controller",
    )
    parser.add_argument(
        "--workspace", required=True,
        help="training workspace dir every replica serves from",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9000,
                        help="router port (replicas bind ephemeral ports)")
    parser.add_argument(
        "--replicas", type=int, default=0,
        help="initial fleet size (0 = serving.autoscale_min_replicas)",
    )
    parser.add_argument("--probe-interval", type=float, default=2.0)
    parser.add_argument(
        "--extra_config", default=None,
        help="JSON dot-key overrides (e.g. the serving.autoscale_* knobs)",
    )
    parser.add_argument(
        "--server-arg", action="append", default=[], metavar="ARG",
        help="extra argument passed through to every replica's "
        "serving CLI (repeatable; e.g. --server-arg=--zoo-buckets)",
    )
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    cfg = Config()
    if args.extra_config:
        cfg = cfg.replace(**json.loads(args.extra_config))
    pool = SubprocessPool(args.workspace, host=args.host,
                          server_args=args.server_arg)
    initial = args.replicas or cfg.serving.autoscale_min_replicas
    fleet = None
    fleet_srv = None
    controller = None
    try:
        urls: dict[str, str] = {}
        for _ in range(initial):
            name, url = pool.spawn()
            urls[name] = url
            print(f"replica {name} up at {url}")
        fleet = FleetApp(urls, probe_interval_s=args.probe_interval).start()
        pool.configure_peers(urls)
        fleet_srv = make_fleet_server(fleet, args.host, args.port,
                                      verbose=args.verbose)
        host, port = fleet_srv.server_address[:2]
        controller = controller_from_config(
            fleet, pool, cfg, scrape=f"http://{host}:{port}/metrics",
        ).start()
        print(
            f"elastic fleet on http://{host}:{port} "
            f"({len(urls)} replicas, "
            f"[{controller.min_replicas}, {controller.max_replicas}] "
            f"every {controller.interval_s:g}s)"
        )
        fleet_srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if controller is not None:
            controller.close()
        if fleet_srv is not None:
            fleet_srv.shutdown()
            fleet_srv.server_close()
        if fleet is not None:
            fleet.close()
        pool.close()


if __name__ == "__main__":
    main()
