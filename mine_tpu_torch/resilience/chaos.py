"""Deterministic fault injection at named seams (`MINE_TPU_FAULTS`; the
port's own copy of mine_tpu/resilience/chaos.py, under the same variable, so
a drill's spec means the same on either package).

Every behaviour the resilience layer promises (sentinel skip, preemption
save and resume, loader retry, breaker trip, rejected swap, the ladder's
climb, the autoscaler's aborted join and drain) must be provable without
real hardware faults. Production code calls a seam
(`maybe_raise("loader_raise")`, `should("nan_loss", at=step)`) that is a
single `is None` check when no schedule is installed; tests and drills
install one that fires each fault exactly once at a deterministic point.

Grammar (comma-separated, whitespace-free):

    MINE_TPU_FAULTS = fault ("," fault)*
    fault           = kind "@" counter "=" int

e.g. ``nan_loss@step=7,loader_raise@batch=3,engine_raise@render=2``. The
counter must be the kind's canonical one (below): a mismatch is a parse
error, not a silently dead fault.

Kinds and their seams:

  nan_loss@step=N      training/loop.py poisons step N's batch with NaNs.
  spike_loss@step=N    resilience/sentinel.py inflates the logged loss at
                       step N.
  sigterm@step=N       training/loop.py SIGTERMs its own process after
                       completing step N (preemption).
  sigusr2@step=N       the same with SIGUSR2 (save and continue).
  preempt_exit@step=N  training/loop.py raises PreemptedError after step N:
                       the in-process stand-in for a preemption.
  loader_raise@batch=N data/pipeline.py raises a transient ChaosFault on the
                       Nth produced batch (the bounded retry absorbs it).
  engine_raise@render=N  serving/engine.py raises on the Nth render.
  predict_raise@predict=N  serving/engine.py raises on the Nth predict.
  corrupt_swap@swap=N  serving/server.py's swap worker raises while loading
                       the Nth swap's checkpoint (rejected swap, old
                       generation serving).
  corrupt_ckpt@swap=N  the same worker raises CheckpointCorrupt on the Nth
                       swap (refused with reason=corrupt).
  overload_spike@request=N  serving/server.py injects synthetic overload
                       into the brownout ladder on its Nth handled request.
  replica_kill@request=N  serving/server.py closes this replica's listener
                       on its Nth handled request, dropping the connection.
  join_stall@scale=N   serving/autoscale.py raises in the Nth join's
                       pre-warm (the joiner never enters the ring).
  drain_timeout@scale=N  serving/autoscale.py raises in the Nth drain's
                       handoff (the drain still completes).

The JAX package's multi-host kinds (`host_kill`, `host_stall`,
`coord_down`) have no seam here yet: a spec naming one is a parse error that
names ROADMAP queue 1 item 6.

Two trigger styles share one `should()` call: value-keyed kinds (counter
`step`) fire when the caller's `at=` equals the trigger; invocation-keyed
kinds keep an internal per-kind call count. Each configured fault fires
ONCE: retries and replays after a rollback do not re-fire it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

ENV_VAR = "MINE_TPU_FAULTS"

# kind -> canonical counter name; value-keyed kinds use counter "step"
KINDS: dict[str, str] = {
    "nan_loss": "step",
    "spike_loss": "step",
    "sigterm": "step",
    "sigusr2": "step",
    "preempt_exit": "step",
    "loader_raise": "batch",
    "engine_raise": "render",
    "predict_raise": "predict",
    "corrupt_swap": "swap",
    "corrupt_ckpt": "swap",
    "replica_kill": "request",
    "overload_spike": "request",
    "join_stall": "scale",
    "drain_timeout": "scale",
}
_VALUE_KEYED = frozenset(k for k, c in KINDS.items() if c == "step")
# the JAX package's multi-host kinds: a spec naming one is refused, never a
# silently dead fault, until the port has their seams
MULTIHOST_KINDS = frozenset({"host_kill", "host_stall", "coord_down"})


class ChaosFault(RuntimeError):
    """The injected fault. Transient by construction (fires once), so retry
    paths treat it as retryable; non-retry paths see an ordinary error."""

    def __init__(self, kind: str, trigger: int):
        super().__init__(
            f"injected chaos fault {kind}@{KINDS[kind]}={trigger} "
            f"({ENV_VAR} schedule)"
        )
        self.kind = kind
        self.trigger = trigger


class PreemptedError(RuntimeError):
    """In-process preemption stand-in (`preempt_exit@step=N`): unwinds the
    training loop through the emergency-checkpoint path without a signal."""


@dataclass
class _Fault:
    kind: str
    trigger: int
    fired: bool = False


@dataclass
class ChaosSchedule:
    """A parsed fault schedule. Thread-safe: seams fire from the training
    main thread, the prefetch worker, and the batcher worker."""

    spec: str
    faults: list[_Fault] = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        for part in filter(None, self.spec.replace(" ", "").split(",")):
            try:
                kind_at, value = part.split("=", 1)
                kind, counter = kind_at.split("@", 1)
                trigger = int(value)
            except ValueError:
                raise ValueError(
                    f"bad {ENV_VAR} fault {part!r}: expected kind@counter=int"
                ) from None
            if kind in MULTIHOST_KINDS:
                raise ValueError(
                    f"{ENV_VAR} fault kind {kind!r} has no seam in the port: "
                    "multi-host training waits for ROADMAP queue 1 item 6"
                )
            if kind not in KINDS:
                raise ValueError(
                    f"unknown {ENV_VAR} fault kind {kind!r} "
                    f"(known: {sorted(KINDS)})"
                )
            if counter != KINDS[kind]:
                raise ValueError(
                    f"{ENV_VAR} fault {kind!r} counts {KINDS[kind]!r}, "
                    f"not {counter!r}"
                )
            if trigger < 1:
                raise ValueError(f"{ENV_VAR} trigger must be >= 1: {part!r}")
            self.faults.append(_Fault(kind, trigger))

    def should(self, kind: str, at: int | None = None) -> bool:
        """True exactly once per configured (kind, trigger) match.

        Value-keyed kinds require `at` (the caller's own counter, e.g. the
        global step); invocation-keyed kinds count calls to this method.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown chaos kind {kind!r}")
        with self._lock:
            if at is None:
                if kind in _VALUE_KEYED:
                    raise ValueError(f"chaos kind {kind!r} needs at=<step>")
                self._counts[kind] = at = self._counts.get(kind, 0) + 1
            for f in self.faults:
                if f.kind == kind and not f.fired and f.trigger == at:
                    f.fired = True
                    return True
        return False

    def pending(self) -> list[str]:
        """Unfired faults, for end-of-drill assertions ("did every
        configured fault actually reach its seam?")."""
        with self._lock:
            return [
                f"{f.kind}@{KINDS[f.kind]}={f.trigger}"
                for f in self.faults if not f.fired
            ]


_UNPARSED = object()
_active: ChaosSchedule | None | object = _UNPARSED
_active_lock = threading.Lock()


def active() -> ChaosSchedule | None:
    """The process-wide schedule: parsed from $MINE_TPU_FAULTS on first
    call, None when unset/empty. `install()`/`uninstall()` override (tests)."""
    global _active
    if _active is _UNPARSED:
        with _active_lock:
            if _active is _UNPARSED:
                spec = os.environ.get(ENV_VAR, "")
                _active = ChaosSchedule(spec) if spec else None
    return _active  # type: ignore[return-value]


def install(spec: str) -> ChaosSchedule:
    """Install a schedule programmatically (tests); returns it."""
    global _active
    with _active_lock:
        _active = ChaosSchedule(spec)
        return _active


def uninstall() -> None:
    """Drop any schedule; the next active() re-reads the environment."""
    global _active
    with _active_lock:
        _active = _UNPARSED


def should(kind: str, at: int | None = None) -> bool:
    """Module-level seam: False (one attribute check) with no schedule."""
    schedule = active()
    return schedule.should(kind, at) if schedule is not None else False


def maybe_raise(kind: str, at: int | None = None) -> None:
    """Raise ChaosFault when the schedule says this seam fires now."""
    schedule = active()
    if schedule is not None and schedule.should(kind, at):
        trigger = at if at is not None else schedule._counts[kind]
        raise ChaosFault(kind, trigger)
