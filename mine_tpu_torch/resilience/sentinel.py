"""Training sentinel: detect a poisoned run and apply a recovery policy (the
port's copy of mine_tpu/resilience/sentinel.py, with plain counters in place
of the metrics registry). A trip dumps the flight recorder when one is
given; the `spike_loss` chaos seam inflates the logged loss.

Detectors
  finiteness  every train step computes `isfinite(loss) & isfinite(|grad|)`
              (training/step.py) and, for any policy but "off", skips the
              update: parameters, optimizer state and BatchNorm statistics
              keep their values. The step's flag (`update_skipped`, a device
              scalar) is queued by `observe()` without a device sync; queued
              flags resolve in one transfer at each log interval and
              checkpoint boundary.
  spike       the logged loss against `spike_factor` x the running median of
              the last `spike_window` logged losses, after
              `spike_min_history` of them.

Policies on a trip
  skip      count it and continue: the step already dropped the update.
  rollback  raise SentinelRollback; the training loop restores the last-good
            checkpoint and resumes the data stream there, at most
            `resilience.max_rollbacks` times, then aborts.
  abort     raise SentinelAbort (the loop's emergency checkpoint keeps the
            last completed step).
"""

from __future__ import annotations

import logging
import math
import statistics
from collections import Counter, deque
from typing import Any

import torch

from mine_tpu_torch.resilience import chaos

POLICIES = ("off", "skip", "rollback", "abort")


class SentinelTrip(RuntimeError):
    """Base of the raising sentinel outcomes."""


class SentinelRollback(SentinelTrip):
    """Restore last-good and resume the data stream there (caught by the
    training loop)."""


class SentinelAbort(SentinelTrip):
    """Unrecoverable by policy: stop training."""


class TrainingSentinel:
    """The per-run sentinel: counters `nonfinite_steps`, `skipped_updates`,
    `rollbacks` and `trips` ({(reason, action): n})."""

    def __init__(self, res_cfg: Any, logger: logging.Logger, flight: Any | None = None):
        if res_cfg.sentinel_policy not in POLICIES:
            raise ValueError(f"resilience.sentinel_policy={res_cfg.sentinel_policy!r} "
                             f"must be one of {POLICIES}")
        self.policy = res_cfg.sentinel_policy
        self.spike_factor = float(res_cfg.sentinel_spike_factor)
        self.spike_min_history = int(res_cfg.sentinel_spike_min_history)
        self.logger = logger
        self.flight = flight  # obs/flight.py FlightRecorder: a trip dumps it
        self._pending: list[tuple[int, torch.Tensor]] = []
        # a bad vet() verdict parks here until the next check() applies it
        self._deferred_reason: str | None = None
        self._history: deque[float] = deque(maxlen=max(int(res_cfg.sentinel_spike_window), 1))
        self.nonfinite_steps = 0
        self.skipped_updates = 0
        self.rollbacks = 0
        self.trips: Counter = Counter()

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    def observe(self, step: int, skipped_flag: torch.Tensor | None) -> None:
        """Queue one step's flag (1.0: the update was non-finite and
        skipped) for the next check(); no device sync."""
        if self.enabled and skipped_flag is not None:
            self._pending.append((step, skipped_flag))

    def _resolve_flags(self) -> str | None:
        """Fetch the queued flags in one transfer, count; "nonfinite" when
        any step's update was skipped. Never raises."""
        if not self._pending:
            return None
        flags = torch.stack([f.detach().float().reshape(()) for _, f in self._pending]).cpu()
        bad = [s for (s, _), v in zip(self._pending, flags.tolist()) if v > 0.0]
        self._pending.clear()
        if not bad:
            return None
        self.nonfinite_steps += len(bad)
        self.skipped_updates += len(bad)
        self.logger.warning("sentinel: non-finite loss/grad at step(s) %s; update(s) skipped",
                            bad)
        return "nonfinite"

    def vet(self, step: int) -> bool:
        """Resolve pending flags without raising; True: clean, safe to mark
        as last-good. A bad verdict is deferred to the next check()."""
        if not self.enabled:
            return True
        reason = self._resolve_flags()
        if reason is not None:
            self._deferred_reason = reason
            return False
        return self._deferred_reason is None

    def check(self, host_loss: float | None, step: int) -> None:
        """Resolve pending flags and spike-check the logged loss; raises
        SentinelRollback / SentinelAbort per policy. host_loss=None is a
        flags-only flush."""
        if not self.enabled:
            return
        reason, self._deferred_reason = self._deferred_reason, None
        reason = self._resolve_flags() or reason
        if host_loss is not None:
            if chaos.should("spike_loss", at=step):
                # observation-level injection: a deterministic genuine spike
                # cannot be induced from data alone (resilience/chaos.py)
                host_loss = host_loss * max(self.spike_factor, 1.0) * 100.0
            if not math.isfinite(host_loss):
                reason = reason or "nonfinite"
            else:
                if (reason is None and self.spike_factor > 0
                        and len(self._history) >= self.spike_min_history):
                    median = statistics.median(self._history)
                    if median > 0 and host_loss > self.spike_factor * median:
                        reason = "spike"
                        self.logger.warning("sentinel: loss spike at step %d: %.4g > %.3g x "
                                            "median %.4g", step, host_loss, self.spike_factor,
                                            median)
                if reason is None:
                    # poisoned samples stay out of the median baseline
                    self._history.append(host_loss)
        if reason is not None:
            self._trip(reason, step, host_loss)

    def flush(self, step: int) -> None:
        """Flags-only check (checkpoint boundaries, the end of fit)."""
        self.check(None, step)

    def _trip(self, reason: str, step: int, host_loss: float | None) -> None:
        self.trips[reason, self.policy] += 1
        if self.flight is not None:
            self.flight.dump(f"sentinel_{reason}", extra={
                "sentinel_step": step, "sentinel_loss": host_loss,
                "sentinel_action": self.policy})
        msg = (f"sentinel trip at step {step}: reason={reason} action={self.policy} "
               f"loss={host_loss}")
        if self.policy == "rollback":
            raise SentinelRollback(msg)
        if self.policy == "abort":
            raise SentinelAbort(msg)
        self.logger.warning("%s (continuing)", msg)

    def reset_after_rollback(self) -> None:
        """Drop flags queued before the restore and restart the spike
        baseline."""
        self._pending.clear()
        self._history.clear()
        self._deferred_reason = None
