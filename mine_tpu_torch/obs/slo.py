"""SLO and error-budget tracking over the serving metric families (the port's
own copy of mine_tpu/obs/slo.py).

The serving stack already counts what an availability or latency objective
needs (`mine_serve_requests_total{endpoint,status}` or
`mine_fleet_requests_total`, and the cumulative-bucket latency histograms),
so the objectives are evaluated over those families, in rolling windows,
with no second accounting path:

  Objective   one target: `availability` (fraction of non-error responses)
              or `latency` (fraction of requests answered within
              `threshold_s`; target 0.95 with a threshold reads
              "p95 <= threshold").
  SLOTracker  snapshots the counter or histogram children on each
              evaluate(), diffs against the newest snapshot at least
              `window_s` old, and publishes three gauges per objective on
              the same registry:

                mine_slo_compliance{slo}             good / total
                mine_slo_burn_rate{slo}              error rate / budget
                mine_slo_error_budget_remaining{slo} 1 - burn rate

An availability error is any 5xx except the `exempt_statuses` (default 503:
admission control's honest "retry later" with a Retry-After). An empty
window passes vacuously: compliance 1, burn 0.

ServingApp (a replica) and FleetApp (the router) each evaluate a tracker on
every /metrics scrape. The exposition readers at the end parse a /metrics
text page, for the autoscale controller (serving/autoscale.py).
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from mine_tpu_torch.utils.metrics import Counter, Histogram, MetricsRegistry

# the endpoints whose responses count: the product surface, not the scrape
# and introspection endpoints (a draining replica's /healthz 503 is the
# health contract, not unavailability)
DEFAULT_ENDPOINTS = ("predict", "render", "mpi")


@dataclass(frozen=True)
class Objective:
    """One objective over an existing metric family.

    "availability": `family` is a requests-total counter with `endpoint`
    and `status` labels; compliance = non-error / total over the window,
    restricted to `endpoints`.

    "latency": `family` is a cumulative-bucket histogram with an `endpoint`
    label; compliance = the fraction of the window's observations at or
    under `threshold_s`, interpolated inside the containing bucket."""

    name: str
    kind: str  # "availability" | "latency"
    family: str
    target: float
    threshold_s: float = 0.0
    endpoints: tuple[str, ...] = DEFAULT_ENDPOINTS
    exempt_statuses: tuple[int, ...] = (503,)
    window_s: float = 300.0

    def __post_init__(self):
        if self.kind not in ("availability", "latency"):
            raise ValueError(f"objective {self.name}: unknown kind "
                             f"{self.kind!r} (availability|latency)")
        if not (0.0 < self.target <= 1.0):
            raise ValueError(f"objective {self.name}: target {self.target} "
                             "must be in (0, 1]")
        if self.kind == "latency" and self.threshold_s <= 0:
            raise ValueError(f"objective {self.name}: latency objectives "
                             "need threshold_s > 0")


def default_objectives(
    availability_target: float = 0.995,
    p95_s: float = 2.0,
    window_s: float = 300.0,
    family_prefix: str = "mine_serve",
) -> tuple[Objective, ...]:
    """Availability over the requests counter and p95 over the request
    latency histogram; the router passes family_prefix='mine_fleet'."""
    return (
        Objective(
            name="availability", kind="availability",
            family=f"{family_prefix}_requests_total",
            target=availability_target, window_s=window_s,
        ),
        Objective(
            name="latency_p95", kind="latency",
            family=f"{family_prefix}_request_latency_seconds",
            target=0.95, threshold_s=p95_s, window_s=window_s,
        ),
    )


@dataclass
class _Snapshot:
    ts: float
    # (good, total), already reduced over the family's children
    good: float = 0.0
    total: float = 0.0


class SLOTracker:
    """Rolling-window evaluator of a set of objectives on one registry.
    Thread-safe: scrapes may evaluate concurrently."""

    def __init__(
        self,
        registry: MetricsRegistry,
        objectives: tuple[Objective, ...] | list[Objective],
        clock: Callable[[], float] = time.monotonic,
    ):
        if not objectives:
            raise ValueError("SLOTracker needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {sorted(names)}")
        self.registry = registry
        self.objectives = tuple(objectives)
        self.clock = clock
        self._lock = threading.Lock()
        self._history: dict[str, deque[_Snapshot]] = {
            o.name: deque() for o in self.objectives
        }
        # a baseline at construction: the first evaluate() measures "since
        # the tracker existed", not an empty window
        now0 = self.clock()
        for obj in self.objectives:
            self._history[obj.name].append(_Snapshot(now0, *self._reduce(obj)))
        self.compliance = registry.gauge(
            "mine_slo_compliance",
            "fraction of in-window requests meeting the objective, by slo "
            "(1.0 on an empty window — idle is not a violation)",
        )
        self.burn_rate = registry.gauge(
            "mine_slo_burn_rate",
            "in-window error rate over the error budget (1 - target), by "
            "slo: 1.0 = burning exactly at budget, > 1.0 = violating",
        )
        self.budget_remaining = registry.gauge(
            "mine_slo_error_budget_remaining",
            "1 - burn_rate, by slo — negative when the window has already "
            "overspent its budget (honest, not clamped)",
        )

    def _reduce(self, obj: Objective) -> tuple[float, float]:
        """(good, cumulative total) of one objective right now."""
        family = self.registry._families.get(obj.family)
        if family is None:
            return 0.0, 0.0
        if obj.kind == "availability":
            if not isinstance(family, Counter):
                raise TypeError(f"objective {obj.name}: {obj.family} is "
                                f"{family.kind}, availability needs a counter")
            good = total = 0.0
            for labels, value in family.labeled_values().items():
                d = dict(labels)
                if obj.endpoints and d.get("endpoint") not in obj.endpoints:
                    continue
                total += value
                if not self._is_error(d.get("status", ""), obj):
                    good += value
            return good, total
        if not isinstance(family, Histogram):
            raise TypeError(f"objective {obj.name}: {obj.family} is {family.kind}, "
                            "latency needs a histogram")
        good = total = 0.0
        edges = list(family.buckets) + [float("inf")]
        for labels, counts in family.labeled_buckets().items():
            d = dict(labels)
            if obj.endpoints and d.get("endpoint") not in obj.endpoints:
                continue
            cum = 0.0
            within = None
            prev_edge, prev_cum = 0.0, 0.0
            for edge, n in zip(edges, counts):
                cum += n
                if within is None and obj.threshold_s <= edge:
                    if edge == float("inf"):
                        # a threshold past the last finite bucket: only what
                        # is provably under that edge is within it
                        within = prev_cum
                    elif edge == prev_edge:
                        within = cum
                    else:
                        frac = (obj.threshold_s - prev_edge) / (edge - prev_edge)
                        within = prev_cum + frac * (cum - prev_cum)
                prev_edge, prev_cum = edge, cum
            total += cum
            good += cum if within is None else min(within, cum)
        return good, total

    @staticmethod
    def _is_error(status: str, obj: Objective) -> bool:
        try:
            code = int(status)
        except (TypeError, ValueError):
            return False
        return code >= 500 and code not in obj.exempt_statuses

    def evaluate(self, now: float | None = None) -> dict[str, dict[str, Any]]:
        """Snapshot, window, publish the gauges; returns {name: verdict}."""
        now = self.clock() if now is None else now
        out: dict[str, dict[str, Any]] = {}
        with self._lock:
            for obj in self.objectives:
                good, total = self._reduce(obj)
                hist = self._history[obj.name]
                hist.append(_Snapshot(now, good, total))
                # the baseline: the newest snapshot at least window_s old,
                # else the oldest held
                while len(hist) > 1 and hist[1].ts <= now - obj.window_s:
                    hist.popleft()
                base = hist[0]
                w_total = total - base.total
                w_good = good - base.good
                if w_total <= 0:
                    compliance, burn = 1.0, 0.0
                else:
                    compliance = max(0.0, min(1.0, w_good / w_total))
                    budget = max(1.0 - obj.target, 1e-9)
                    burn = (1.0 - compliance) / budget
                remaining = 1.0 - burn
                self.compliance.set(compliance, slo=obj.name)
                self.burn_rate.set(burn, slo=obj.name)
                self.budget_remaining.set(remaining, slo=obj.name)
                out[obj.name] = {
                    "slo": obj.name,
                    "kind": obj.kind,
                    "target": obj.target,
                    "window_requests": round(w_total, 1),
                    "compliance": round(compliance, 6),
                    "burn_rate": round(burn, 4),
                    "error_budget_remaining": round(remaining, 4),
                    "ok": burn <= 1.0,
                }
                if obj.kind == "latency":
                    out[obj.name]["threshold_s"] = obj.threshold_s
        return out


def tracker_from_config(registry: MetricsRegistry, cfg: Any,
                        family_prefix: str = "mine_serve") -> SLOTracker:
    """The serving.slo_* knobs into the default objective pair."""
    s = cfg.serving
    return SLOTracker(registry, default_objectives(
        availability_target=s.slo_availability_target,
        p95_s=s.slo_p95_ms / 1e3,
        window_s=s.slo_window_s,
        family_prefix=family_prefix,
    ))


# -- reading a /metrics text page (the autoscale controller's input) --------

_EXPO_LABELS_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def _exposition_children(text: str, family: str) -> list[tuple[dict, float]]:
    """[(labels, value)] of one family's sample lines on a text page."""
    out: list[tuple[dict, float]] = []
    for line in text.splitlines():
        if not line.startswith(family):
            continue
        rest = line[len(family):]
        if not rest or rest[0] not in " {":
            continue  # a longer family name sharing the prefix
        labels: dict[str, str] = {}
        if rest[0] == "{":
            body, _, rest = rest[1:].partition("}")
            labels = dict(_EXPO_LABELS_RE.findall(body))
        try:
            value = float(rest.strip().split()[0])
        except (ValueError, IndexError):
            continue
        out.append((labels, value))
    return out


def burn_rates_from_exposition(text: str) -> dict[str, float]:
    """{slo name: burn rate} from a page's mine_slo_burn_rate gauges; empty
    when the page carries none."""
    return {
        labels.get("slo", ""): value
        for labels, value in _exposition_children(text, "mine_slo_burn_rate")
        if labels.get("slo")
    }


def degradation_from_exposition(
    text: str, family: str = "mine_fleet_degradation_level"
) -> float | None:
    """The worst brownout level on a page (the router's fleet-wide gauge by
    default, or a replica's `mine_serve_degradation_level`); None when the
    page carries no such gauge: no signal, distinct from a healthy 0."""
    samples = _exposition_children(text, family)
    if not samples:
        return None
    return max(value for _, value in samples)


def p95_from_exposition(
    text: str,
    family: str = "mine_fleet_request_latency_seconds",
    endpoints: tuple[str, ...] = DEFAULT_ENDPOINTS,
    q: float = 0.95,
) -> float | None:
    """The q-quantile (seconds) of a cumulative-bucket histogram on a text
    page, summed over its `endpoints` children, interpolated linearly in the
    bucket; None without observations. An observation in the +Inf bucket
    reports the last finite edge."""
    per_le: dict[float, float] = {}
    for labels, value in _exposition_children(text, f"{family}_bucket"):
        if endpoints and labels.get("endpoint") not in endpoints:
            continue
        le = labels.get("le", "")
        edge = float("inf") if le == "+Inf" else float(le)
        per_le[edge] = per_le.get(edge, 0.0) + value
    if not per_le:
        return None
    edges = sorted(per_le)
    total = per_le[edges[-1]]
    if total <= 0:
        return None
    target = q * total
    prev_edge, prev_cum = 0.0, 0.0
    for edge in edges:
        cum = per_le[edge]
        if cum >= target:
            if edge == float("inf"):
                return prev_edge
            if cum == prev_cum:
                return edge
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_edge + frac * (edge - prev_edge)
        prev_edge, prev_cum = edge, cum
    return prev_edge
