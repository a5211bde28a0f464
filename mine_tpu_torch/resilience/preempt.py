"""Preemption guard: an out-of-band checkpoint save on SIGTERM/SIGUSR2 (the
port's own copy of mine_tpu/resilience/preempt.py).

A preemption delivers SIGTERM with a short grace window; everything since
the last periodic checkpoint is lost unless the process saves now. The guard
installs handlers that run the caller's `save_fn` first and then CHAIN to
whatever handler was installed before it:

  * Installed after the flight recorder (obs/flight.py), the SIGTERM order
    is: checkpoint save -> flight dump -> re-delivered SIGTERM with the
    original disposition (termination unchanged; the save and the evidence
    are the only additions).
  * With no previous Python handler, SIGTERM still terminates (the default
    disposition is restored and the signal re-delivered); SIGUSR2 is
    save-and-continue (its default action, terminate, is NOT chained).

CPython runs signal handlers on the main thread between bytecodes, so a
signal can land in the middle of a train step: inside `optimizer.step()`,
halfway through the parameter groups, since the port updates its
parameters in place. The JAX loop saves an immutable state of the last
completed step; here the loop marks each step (and each checkpoint write)
with `deferring()`, and a signal arriving inside one only records itself:
the save, and then the chain, run when that region ends, on the state of
the step it completed. Outside such a region the handler saves at once. A
step takes 0.4-0.7 s at the default recipe on an H100, well inside a
preemption's grace window.

On several ranks (`collective=True`) a save is a collective: under a
sharded layout every rank gathers the state, and a rank that saved alone
would leave its peers blocked in their next collective. There the handler
only records the request; the loop reads `pending()` at each step boundary,
all-reduces it (MAX) over the ranks, and every rank calls `resolve()` with
the result together: each saves (save_fn, a collective), then takes the
signal's disposition as if it had received it: SIGTERM ends every rank as
it ends one process, SIGUSR2 lets every rank continue. A SIGTERM that was
recorded but never resolved (the run raised first) is re-delivered by
`redeliver()` once the caller has cleaned up.

`save_fn` failures are logged, never raised: a broken save must not block
the chain.
"""

from __future__ import annotations

import os
import signal
import threading
from contextlib import contextmanager
from typing import Any, Callable, Iterator

# a request's weight in the ranks' MAX: termination outranks save-and-continue
SEVERITY = {signal.SIGUSR2: 1, signal.SIGTERM: 2}


class PreemptionGuard:
    def __init__(
        self,
        save_fn: Callable[[str], None],
        logger: Any = None,
        signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGUSR2),
        collective: bool = False,
    ):
        self.save_fn = save_fn
        self.logger = logger
        self.collective = collective
        self._signals = signals
        self._prev: dict[int, Any] = {}
        self.triggered: list[str] = []  # signal names handled, oldest first
        self._depth = 0  # open deferring() regions (main thread only)
        self._deferred: list[tuple[int, Any]] = []
        self._requested: dict[int, Any] = {}  # collective: signum -> frame, unresolved

    def install(self) -> "PreemptionGuard":
        """Install handlers (main thread only, CPython's rule); a no-op off
        the main thread so library use inside tests/workers stays safe."""
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):  # exotic platform / nested ctx
                pass
        return self

    def uninstall(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()

    @contextmanager
    def deferring(self) -> Iterator[None]:
        """A region whose state is inconsistent until it ends (a train step,
        a checkpoint write): a signal inside it saves, then chains, when the
        outermost region ends, however it ends."""
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                while self._deferred:
                    self._handle(*self._deferred.pop(0))

    def _on_signal(self, signum: int, frame: Any) -> None:
        name = signal.Signals(signum).name
        self.triggered.append(name)
        if self.collective:
            if self.logger is not None:
                self.logger.warning("%s: saving with every rank at the next step boundary",
                                    name)
            self._requested[signum] = frame
            return
        if self._depth > 0:
            if self.logger is not None:
                self.logger.warning("%s inside a step: saving when it completes", name)
            self._deferred.append((signum, frame))
            return
        self._handle(signum, frame)

    def pending(self) -> int:
        """The strongest unresolved request (SEVERITY), 0 when none."""
        return max((SEVERITY.get(sig, 0) for sig in self._requested), default=0)

    def resolve(self, severity: int) -> None:
        """The ranks' agreed request (the MAX of their `pending()`): save,
        then the disposition of its signal, on every rank alike."""
        signum = next(sig for sig, level in SEVERITY.items() if level == severity)
        frame = self._requested.get(signum)
        self._requested.clear()
        self._handle(signum, frame)

    def redeliver(self) -> None:
        """Re-deliver a recorded SIGTERM that was never resolved, through
        the handler restored by uninstall()."""
        if signal.SIGTERM in self._requested:
            self._requested.clear()
            os.kill(os.getpid(), signal.SIGTERM)

    def _handle(self, signum: int, frame: Any) -> None:
        name = signal.Signals(signum).name
        try:
            self.save_fn(f"signal_{name.lower()}")
        except BaseException:  # noqa: BLE001 - never block termination
            if self.logger is not None:
                self.logger.exception("preemption save failed (%s)", name)
        prev = self._prev.get(signum)
        if callable(prev):
            # chain (e.g. the flight recorder's dump-then-terminate)
            prev(signum, frame)
        elif signum == signal.SIGTERM:
            # no Python handler underneath: termination must still
            # terminate; restore the original disposition and re-deliver
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        # SIGUSR2 with no previous handler: save-and-continue by design
