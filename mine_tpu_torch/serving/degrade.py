"""Brownout serving: a load-adaptive degradation ladder (the port's own copy
of mine_tpu/serving/degrade.py).

A per-replica `DegradationController` maps live pressure (the batcher's
queue depth over its bound, the worst SLO burn rate, the breaker's state)
onto an ordered ladder of cheaper serving modes, engaged before any 503:

  L0 normal    full fidelity at the configured operating point.
  L1 compress  new predicts land in the int8 tier with default-eps
               transmittance pruning: a quarter of the slab bytes, fewer
               planes, smaller render plane buckets.
  L2 stale     stale-while-revalidate: on a cache miss an older-step entry
               of the same scene answers; the peer-fetch hop is skipped.
  L3 coalesce  the micro-batcher's coalescing window widens; only past this
               does the 503 shed fire.

Escalation takes `engage_after` consecutive breach ticks; relaxing takes
`relax_after` consecutive calm ticks and `dwell_s` at the level. Either way
the ladder moves one level at a time. Every degraded answer carries
`X-Degraded: level=<n>;tier=<t>`. Pure host-side state on an injectable
clock: no threads, no sleeps.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from mine_tpu_torch.serving.compress import DEFAULT_PRUNE_EPS

# level -> (name, what it trades)
LADDER: dict[int, tuple[str, str]] = {
    0: ("normal", "full fidelity at the configured operating point"),
    1: ("compress", "new predicts land in the int8 tier + default-eps "
        "pruning (quarter slab bytes, smaller render buckets)"),
    2: ("stale", "stale-while-revalidate: older-generation cache entries "
        "keep serving on a miss; peer-fetch skipped"),
    3: ("coalesce", "micro-batcher coalescing window widened; only past "
        "this does the 503 shed fire"),
}
MAX_LEVEL = max(LADDER)


@dataclass(frozen=True)
class PressureSample:
    """One tick's pressure, gathered by the serving app: queue_frac = the
    batcher's depth over its bound, burn_rate = the worst
    `mine_slo_burn_rate` the tracker last published, breaker_open = the
    breaker is rejecting."""

    queue_frac: float = 0.0
    burn_rate: float = 0.0
    breaker_open: bool = False


class DegradationController:
    """The per-replica ladder state machine.

    tick() classifies a sample as breach (queue_frac >= queue_high, or
    burn_rate >= burn_high, or the breaker open), calm (queue_frac <=
    queue_low and burn_rate <= burn_low and the breaker closed) or the
    deadband between, which holds the level and restarts both streaks.
    Thread-safe: ticks arrive from every handler thread."""

    def __init__(
        self,
        *,
        queue_high: float = 0.75,
        queue_low: float = 0.25,
        burn_high: float = 2.0,
        burn_low: float = 0.5,
        engage_after: int = 2,
        relax_after: int = 3,
        dwell_s: float = 5.0,
        max_level: int = MAX_LEVEL,
        clock=time.monotonic,
        on_level=None,
    ):
        if not 0 <= queue_low <= queue_high:
            raise ValueError(f"need 0 <= queue_low <= queue_high, "
                             f"got {queue_low}/{queue_high}")
        if not 0 <= burn_low <= burn_high:
            raise ValueError(f"need 0 <= burn_low <= burn_high, got {burn_low}/{burn_high}")
        if engage_after < 1 or relax_after < 1:
            raise ValueError(f"engage_after/relax_after must be >= 1, "
                             f"got {engage_after}/{relax_after}")
        if dwell_s < 0:
            raise ValueError(f"dwell_s must be >= 0, got {dwell_s}")
        if not 0 <= max_level <= MAX_LEVEL:
            raise ValueError(f"max_level must be in [0, {MAX_LEVEL}], got {max_level}")
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.engage_after = int(engage_after)
        self.relax_after = int(relax_after)
        self.dwell_s = float(dwell_s)
        self.max_level = int(max_level)
        self._clock = clock
        self._on_level = on_level
        self._lock = threading.Lock()
        self._level = 0  # guarded-by: _lock
        self._level_since = float(clock())  # guarded-by: _lock
        self._breach_ticks = 0  # guarded-by: _lock
        self._calm_ticks = 0  # guarded-by: _lock
        self._synthetic_ticks = 0  # guarded-by: _lock; inject()'s remaining breaches
        self._transitions: list[tuple[float, int]] = [(self._level_since, 0)]
        self._degraded_responses = 0  # guarded-by: _lock

    def tick(self, sample: PressureSample, now: float | None = None) -> int:
        """Advance one observation; returns the (possibly new) level. The
        on_level hook runs outside the lock, on transitions only."""
        moved = False
        with self._lock:
            now = float(self._clock()) if now is None else float(now)
            synthetic = self._synthetic_ticks > 0
            if synthetic:
                self._synthetic_ticks -= 1
            breach = (synthetic or sample.breaker_open or sample.queue_frac >= self.queue_high
                      or sample.burn_rate >= self.burn_high)
            calm = (not breach and sample.queue_frac <= self.queue_low
                    and sample.burn_rate <= self.burn_low)
            if breach:
                self._calm_ticks = 0
                self._breach_ticks += 1
                if self._breach_ticks >= self.engage_after and self._level < self.max_level:
                    moved = self._move_locked(self._level + 1, now)
            elif calm:
                self._breach_ticks = 0
                self._calm_ticks += 1
                if (self._calm_ticks >= self.relax_after and self._level > 0
                        and now - self._level_since >= self.dwell_s):
                    moved = self._move_locked(self._level - 1, now)
            else:
                self._breach_ticks = 0
                self._calm_ticks = 0
            level = self._level
        if moved and self._on_level is not None:
            self._on_level(level)
        return level

    def inject(self, ticks: int | None = None) -> None:
        """Synthetic overload (the `overload_spike@request=N` chaos seam):
        the next `ticks` observations classify as breach whatever the real
        signals say. The default is exactly enough consecutive breaches to
        walk the ladder to max_level, so a drill proves the full climb and
        the one-step-at-a-time descent deterministically."""
        if ticks is None:
            ticks = self.engage_after * self.max_level + 1
        with self._lock:
            self._synthetic_ticks = max(self._synthetic_ticks, int(ticks))

    def _move_locked(self, level: int, now: float) -> bool:
        self._level = level
        self._level_since = now
        self._breach_ticks = 0
        self._calm_ticks = 0
        self._transitions.append((now, level))
        return True

    # -- what each level changes ----------------------------------------------

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def tier_override(self) -> str | None:
        """L>=1: new predicts compress to int8."""
        return "int8" if self.level >= 1 else None

    def prune_eps_override(self) -> float:
        """L>=1: default-eps transmittance pruning joins the tier drop."""
        return DEFAULT_PRUNE_EPS if self.level >= 1 else 0.0

    def serve_stale(self) -> bool:
        """L>=2: an older-step cache entry of the same scene answers a miss."""
        return self.level >= 2

    def skip_peer_fetch(self) -> bool:
        """L>=2: no peer-fetch round trip on a miss."""
        return self.level >= 2

    def widen_coalesce(self) -> bool:
        """L3: the micro-batcher's coalescing window widens."""
        return self.level >= 3

    def announcement(self, tier: str) -> str:
        """The X-Degraded header value at the current level and `tier`."""
        return f"level={self.level};tier={tier}"

    def record_response(self) -> None:
        with self._lock:
            self._degraded_responses += 1

    def snapshot(self) -> dict:
        """State for /healthz."""
        with self._lock:
            return {
                "level": self._level,
                "name": LADDER[self._level][0],
                "level_since": self._level_since,
                "breach_ticks": self._breach_ticks,
                "calm_ticks": self._calm_ticks,
                "degraded_responses": self._degraded_responses,
            }

    def transitions(self) -> list[tuple[float, int]]:
        """Every (time, level) the ladder visited, the starting L0 first."""
        with self._lock:
            return list(self._transitions)


def controller_from_config(cfg, clock=time.monotonic, on_level=None) -> DegradationController:
    """The controller from the `serving.degrade_*` knobs."""
    s = cfg.serving
    return DegradationController(
        queue_high=s.degrade_queue_high,
        queue_low=s.degrade_queue_low,
        burn_high=s.degrade_burn_high,
        burn_low=s.degrade_burn_low,
        engage_after=s.degrade_engage_after,
        relax_after=s.degrade_relax_after,
        dwell_s=s.degrade_dwell_s,
        max_level=s.degrade_max_level,
        clock=clock,
        on_level=on_level,
    )
