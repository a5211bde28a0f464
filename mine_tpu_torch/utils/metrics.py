"""Process-local metrics registry with Prometheus text exposition (the
port's own copy of mine_tpu/utils/metrics.py; the same families render the
same text).

Counters, gauges, label sets, cumulative-bucket histograms and a windowed
summary, rendered as text exposition format 0.0.4 for the server's
/metrics. Every mutation takes the registry-wide lock: HTTP handler threads
and the batcher's worker update metrics concurrently, and one lock keeps
`render()` a consistent snapshot.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from collections import deque


def _format_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _format_value(v: float) -> str:
    # Prometheus wants plain decimals; ints render without the trailing .0
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Family:
    """One named metric family: help text, type, and labeled children."""

    def __init__(self, registry: "MetricsRegistry", name: str, help_text: str,
                 kind: str):
        self.registry = registry
        self.name = name
        self.help = help_text
        self.kind = kind
        self._children: dict[tuple[tuple[str, str], ...], float] = {}

    def _key(self, labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for labels in sorted(self._children):
            lines.append(
                f"{self.name}{_format_labels(labels)} "
                f"{_format_value(self._children[labels])}"
            )
        return lines


class Counter(_Family):
    """Monotonically increasing counter (optionally labeled)."""

    def __init__(self, registry, name, help_text):
        super().__init__(registry, name, help_text, "counter")

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        key = self._key(labels)
        with self.registry._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def value(self, **labels: str) -> float:
        with self.registry._lock:
            return self._children.get(self._key(labels), 0.0)

    def labeled_values(self) -> dict[tuple[tuple[str, str], ...], float]:
        """One consistent snapshot of every child: {sorted label tuple ->
        cumulative value}."""
        with self.registry._lock:
            return dict(self._children)


class Gauge(_Family):
    """Settable point-in-time value (optionally labeled)."""

    def __init__(self, registry, name, help_text):
        super().__init__(registry, name, help_text, "gauge")

    def set(self, v: float, **labels: str) -> None:
        with self.registry._lock:
            self._children[self._key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self.registry._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels: str) -> None:
        self.inc(-n, **labels)

    def value(self, **labels: str) -> float:
        with self.registry._lock:
            return self._children.get(self._key(labels), 0.0)


class Histogram(_Family):
    """Cumulative-bucket histogram (`le`-labeled monotone bucket counters
    plus `_sum`/`_count`). `quantile()` interpolates linearly inside the
    winning bucket, for a quick p50/p95 without a Prometheus server."""

    # latency-shaped default: 1ms .. 60s, roughly x2.5 per step
    DEFAULT_BUCKETS = (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    )

    def __init__(self, registry, name, help_text,
                 buckets: tuple[float, ...] | None = None):
        super().__init__(registry, name, help_text, "histogram")
        buckets = self.DEFAULT_BUCKETS if buckets is None else tuple(
            float(b) for b in buckets
        )
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(
                f"histogram {name} buckets must be ascending, got {buckets}"
            )
        self.buckets = buckets
        # per-label-set: per-bucket NON-cumulative counts (cumulated at
        # collect time — one increment per observe, not len(buckets))
        self._bucket_counts: dict[tuple, list[int]] = {}
        self._count: dict[tuple, int] = {}
        self._sum: dict[tuple, float] = {}

    def observe(self, v: float, **labels: str) -> None:
        v = float(v)
        key = self._key(labels)
        with self.registry._lock:
            counts = self._bucket_counts.get(key)
            if counts is None:
                # one slot per finite bucket + the +Inf overflow slot
                counts = self._bucket_counts[key] = [0] * (len(self.buckets) + 1)
            # first edge >= v gets the observation (`le` semantics);
            # v beyond the last finite edge lands in the +Inf slot
            counts[bisect_left(self.buckets, v)] += 1
            self._count[key] = self._count.get(key, 0) + 1
            self._sum[key] = self._sum.get(key, 0.0) + v

    def count(self, **labels: str) -> int:
        with self.registry._lock:
            return self._count.get(self._key(labels), 0)

    def sum(self, **labels: str) -> float:
        with self.registry._lock:
            return self._sum.get(self._key(labels), 0.0)

    def labeled_buckets(self) -> dict[tuple, list[int]]:
        """One consistent snapshot of every child's NON-cumulative per-
        bucket counts (index-aligned with `self.buckets` + the +Inf slot)."""
        with self.registry._lock:
            return {k: list(v) for k, v in self._bucket_counts.items()}

    def bucket_counts(self, **labels: str) -> dict[float, int]:
        """Upper-bound -> CUMULATIVE count (the exposition's view)."""
        key = self._key(labels)
        with self.registry._lock:
            counts = list(self._bucket_counts.get(key, []))
        out: dict[float, int] = {}
        running = 0
        edges = list(self.buckets) + [float("inf")]
        for edge, n in zip(edges, counts or [0] * len(edges)):
            running += n
            out[edge] = running
        return out

    def quantile(self, q: float, **labels: str) -> float:
        """Histogram-estimated quantile: linear interpolation within the
        bucket holding rank q*count (lower bound 0 for the first bucket,
        clamped to the last finite edge for the +Inf bucket). NaN when no
        observations exist for this label set."""
        cum = self.bucket_counts(**labels)
        total = self._count.get(self._key(labels), 0)
        if not total:
            return float("nan")
        rank = q * total
        prev_edge, prev_cum = 0.0, 0
        for edge, c in cum.items():
            if c >= rank and c > prev_cum:
                if edge == float("inf"):
                    return self.buckets[-1]
                frac = (rank - prev_cum) / (c - prev_cum)
                return prev_edge + frac * (edge - prev_edge)
            prev_edge, prev_cum = (0.0 if edge == float("inf") else edge), c
        return self.buckets[-1]

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key in sorted(self._bucket_counts):
            running = 0
            for edge, n in zip(
                list(self.buckets) + [float("inf")], self._bucket_counts[key]
            ):
                running += n
                le = "+Inf" if edge == float("inf") else _format_value(edge)
                blabels = key + (("le", le),)
                lines.append(
                    f"{self.name}_bucket{_format_labels(blabels)} {running}"
                )
            lines.append(
                f"{self.name}_sum{_format_labels(key)} "
                f"{_format_value(self._sum[key])}"
            )
            lines.append(
                f"{self.name}_count{_format_labels(key)} "
                f"{self._count[key]}"
            )
        return lines


class Summary(_Family):
    """Windowed summary: running count/sum plus nearest-rank quantiles over
    the last `window` observations."""

    def __init__(self, registry, name, help_text, window: int = 1024,
                 quantiles: tuple[float, ...] = (0.5, 0.95)):
        super().__init__(registry, name, help_text, "summary")
        self.window = window
        self.quantiles = quantiles
        self._obs: dict[tuple[tuple[str, str], ...], deque] = {}
        self._count: dict[tuple[tuple[str, str], ...], float] = {}
        self._sum: dict[tuple[tuple[str, str], ...], float] = {}

    def observe(self, v: float, **labels: str) -> None:
        key = self._key(labels)
        with self.registry._lock:
            dq = self._obs.setdefault(key, deque(maxlen=self.window))
            dq.append(float(v))
            self._count[key] = self._count.get(key, 0.0) + 1
            self._sum[key] = self._sum.get(key, 0.0) + float(v)

    def quantile(self, q: float, **labels: str) -> float:
        """Nearest-rank quantile over the current window (nan when empty)."""
        key = self._key(labels)
        with self.registry._lock:
            dq = self._obs.get(key)
            if not dq:
                return float("nan")
            ordered = sorted(dq)
        idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
        return ordered[idx]

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} summary"]
        for key in sorted(self._obs):
            ordered = sorted(self._obs[key])
            for q in self.quantiles:
                idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
                qlabels = key + (("quantile", repr(float(q))),)
                lines.append(
                    f"{self.name}{_format_labels(tuple(sorted(qlabels)))} "
                    f"{_format_value(ordered[idx])}"
                )
            lines.append(
                f"{self.name}_sum{_format_labels(key)} "
                f"{_format_value(self._sum[key])}"
            )
            lines.append(
                f"{self.name}_count{_format_labels(key)} "
                f"{_format_value(self._count[key])}"
            )
        return lines


class MetricsRegistry:
    """Families by name; renders the whole set as one text page."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _register(self, family: _Family) -> _Family:
        with self._lock:
            existing = self._families.get(family.name)
            if existing is not None:
                if type(existing) is not type(family):
                    raise ValueError(
                        f"metric {family.name} already registered as "
                        f"{existing.kind}"
                    )
                return existing
            self._families[family.name] = family
            return family

    def counter(self, name: str, help_text: str) -> Counter:
        return self._register(Counter(self, name, help_text))

    def gauge(self, name: str, help_text: str) -> Gauge:
        return self._register(Gauge(self, name, help_text))

    def summary(self, name: str, help_text: str, window: int = 1024,
                quantiles: tuple[float, ...] = (0.5, 0.95)) -> Summary:
        return self._register(
            Summary(self, name, help_text, window=window, quantiles=quantiles)
        )

    def histogram(self, name: str, help_text: str,
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        return self._register(Histogram(self, name, help_text, buckets=buckets))

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4, trailing newline."""
        with self._lock:
            families = list(self._families.values())
            lines: list[str] = []
            for fam in families:
                lines.extend(fam.collect())
        return "\n".join(lines) + "\n"
