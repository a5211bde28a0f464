"""Multi-process training survival: retrying bring-up, heartbeat exchange
and the cross-host stall watchdog (counterpart of
mine_tpu/resilience/multihost.py, with the same file formats, so a tool that
reads either package's sidecar reads both).

The dominant failure at scale is a host dying or wedging mid-step: every
collective then blocks on the missing peer and the job hangs without a
word. Three pieces turn that into a bounded, named abort:

  bring_up()            init_distributed with bounded retry and backoff for
                        FAST failures (a coordinator not accepting yet). A
                        bring-up TIMEOUT stays terminal: the stuck
                        rendezvous thread cannot be torn down in-process.
                        Chaos seam: `coord_down@init=N` fires on the Nth
                        attempt (resilience/chaos.py).

  HeartbeatWriter       one JSON file per process under a shared directory
                        (`host_<i>.json`: step, wall ts, host data bytes,
                        done flag), atomically replaced at each log-interval
                        sync, which the loop already pays for.

  CrossHostWatchdog     a daemon thread polling EVERY heartbeat file (its
                        own too: a process wedged in a collective freezes
                        its own file and so detects itself). A file stale
                        past `window_s`: flight dump (reason `host_stall`),
                        an abort marker next to the heartbeats, then
                        `os._exit(EXIT_HOST_STALL)`. A process that finished
                        `fit()` marks itself done and is never judged.

Clock discipline: staleness compares each file's recorded wall-clock `ts`
with the local `time.time()`: processes of one host share a clock; hosts
must keep their skew well under the window. The heartbeat directory must be
storage every process can read (one host: the workspace's `heartbeats/`;
several: a shared file system, resilience.multihost_heartbeat_dir).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable

from mine_tpu_torch.resilience import chaos

# the named abort's exit code: distinct from signal deaths (negative), 0/1
# success/failure, and crashes: a supervisor can tell "watchdog abort" from
# "crash" by this alone
EXIT_HOST_STALL = 83

# the startup beat's staleness allowance: steady-state beats only begin at
# the first completed log interval, so without an initial beat a host
# killed during the first steps (kernel builds, cuDNN autotuning) would
# leave nothing for peers' watchdogs to judge. Every host writes one beat
# at watchdog start carrying this allowance: wide enough for any first
# step, narrow enough that an early death still ends in the NAMED abort.
STARTUP_ALLOWANCE_S = 600.0

# start()-time cleanup only removes PREVIOUS runs' heartbeat/marker files;
# fresh files are this run's peers racing us to start (their startup
# beats must survive process 0's sweep). Peers reach start() within a few
# seconds of each other — it sits right after the bring-up rendezvous
# they all exited together — while a dead run's files are at least a
# restart-latency old. A restart launched within this many seconds of a
# crash can leave the dead run's beats standing and false-trip the
# watchdog once the grace expires; wait out the margin (or clear the
# heartbeat dir) before hot-relaunching a just-crashed workspace.
_CLEANUP_MIN_AGE_S = 10.0

_MARKER_PREFIX = "multihost_abort_p"


def named_abort(
    directory: str,
    process_index: int,
    reason: str,
    detail: dict | None = None,
    flight: Any = None,
    logger: Any = None,
    exit_fn: Callable[[int], None] = os._exit,
    linger_s: float = 0.0,
) -> None:
    """THE bounded named exit: abort marker -> flight dump -> (linger) ->
    exit_fn(EXIT_HOST_STALL). Shared by the cross-host watchdog (reason
    `host_stall`), the marker broadcast (`peer_abort`), and the teardown
    failsafe (`teardown_hang`). Every step is best-effort — a
    half-written dump beats an abort helper that dies before exiting.

    The MARKER goes first and the exit waits `linger_s`: the first host
    to exit takes the rendezvous store down with it (when it is rank 0,
    which hosts torch.distributed's TCPStore), and a peer still blocked on
    it then fails without evidence; the marker broadcast plus the linger
    gives every peer's watchdog one poll to see the marker and take ITS
    OWN named exit with evidence."""
    detail = dict(detail or {}, process_index=process_index)
    try:
        marker = os.path.join(
            directory, f"{_MARKER_PREFIX}{process_index}.json"
        )
        tmp = f"{marker}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(dict(detail, reason=reason,
                           exit_code=EXIT_HOST_STALL), fh)
        os.replace(tmp, marker)
    except OSError:
        pass
    if logger is not None:
        try:
            logger.error(
                "multihost named abort (%s): %s — exit code %d",
                reason, detail, EXIT_HOST_STALL,
            )
        except Exception:  # noqa: BLE001
            pass
    if flight is not None:
        try:
            flight.dump(reason, extra=detail)
        except Exception:  # noqa: BLE001
            pass
    if linger_s > 0:
        time.sleep(linger_s)
    exit_fn(EXIT_HOST_STALL)


class HostStallAbort(RuntimeError):
    """A peer host went silent past the watchdog window. Raised by the
    synchronous `check()` API; the watchdog THREAD never raises (nothing
    would catch it) — it dumps, writes the marker, and exits the process
    with EXIT_HOST_STALL."""

    def __init__(self, stale: dict[int, float], window_s: float):
        peers = ", ".join(
            f"host {i} silent {age:.1f}s" for i, age in sorted(stale.items())
        )
        super().__init__(
            f"cross-host watchdog: {peers} (window {window_s:.1f}s) — a "
            "host died or wedged in a collective; aborting instead of "
            "hanging"
        )
        self.stale = stale
        self.window_s = window_s


# ----------------------------------------------------------- bring-up retry


def bring_up(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    attempts: int = 3,
    backoff_s: float = 2.0,
    timeout_s: float | None = None,
    initialize_fn: Any = None,
    logger: Any = None,
    sleep_fn: Callable[[float], None] = time.sleep,
    backend: str | None = None,
    device: Any = None,
) -> bool:
    """init_distributed with bounded retry for fast bring-up failures;
    returns whether a process group exists.

    Retryable: ConnectionError/OSError from a coordinator that is not
    accepting yet (torch.distributed's store raises a RuntimeError subclass
    DistNetworkError for a refused connection, retried too), and the
    `coord_down` chaos seam (invocation-keyed on the attempt). NOT
    retryable: MultihostInitTimeout (the timed-out rendezvous thread is
    still blocked; the process must be rescheduled) and any other error. A
    no-op exactly when init_distributed is (one-process runs), except that
    the chaos seam still counts its attempt."""
    from mine_tpu_torch.parallel.mesh import init_distributed

    if logger is None:
        # bring-up runs before the workspace logger exists; logging's last
        # resort handler still puts WARNINGs on stderr
        logger = logging.getLogger("mine_tpu_torch")
    retryable: tuple = (OSError, chaos.ChaosFault)
    try:
        from torch.distributed import DistNetworkError

        retryable += (DistNetworkError,)
    except ImportError:  # pragma: no cover - older torch
        pass
    last: BaseException | None = None
    for attempt in range(1, max(attempts, 1) + 1):
        try:
            chaos.maybe_raise("coord_down")
            return init_distributed(
                coordinator=coordinator,
                num_processes=num_processes,
                process_id=process_id,
                backend=backend,
                device=device,
                timeout_s=timeout_s,
                initialize_fn=initialize_fn,
            )
        except retryable as exc:
            last = exc
            if attempt >= max(attempts, 1):
                raise
            delay = backoff_s * (2.0 ** (attempt - 1))
            logger.warning(
                "multi-host bring-up attempt %d/%d failed (%s: %s); "
                "retrying in %.1fs",
                attempt, attempts, type(exc).__name__, exc, delay,
            )
            sleep_fn(delay)
    raise last  # pragma: no cover - loop always returns or raises


# ------------------------------------------------------- heartbeat exchange

# THE heartbeat file schema, the JAX package's. Required keys appear in
# every beat; optional keys only when the writer had the value. Three
# consumers read these files: the cross-host watchdog, the straggler table
# below and the trace collector (obs/collect.py training_timeline).
BEAT_REQUIRED_KEYS = frozenset(
    {"process_index", "pid", "ts", "step", "data_bytes", "done"}
)
BEAT_OPTIONAL_KEYS = frozenset({"allowance_s", "sync_wait_ms"})


def beat_path(directory: str, process_index: int) -> str:
    return os.path.join(directory, f"host_{process_index}.json")


def read_beat(path: str) -> dict | None:
    """The beat, or None for missing/garbled files (a half-written beat is
    impossible — writes are atomic renames — but a peer may not have
    beaten yet, and evidence reading must never raise)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


class HeartbeatWriter:
    """Atomically-replaced per-host heartbeat file. One instance per
    process; `beat()` is called from the training loop's log-interval
    block (it already syncs host-side there, so the write piggybacks on an
    existing pause, never on the step hot path)."""

    def __init__(self, directory: str, process_index: int,
                 now_fn: Callable[[], float] = time.time):
        self.directory = directory
        self.process_index = int(process_index)
        self._now = now_fn
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int | None = None, data_bytes: int | None = None,
             done: bool = False, allowance_s: float | None = None,
             sync_wait_ms: float | None = None) -> None:
        """`allowance_s` widens THIS beat's staleness window beyond the
        watchdog's (the startup beat carries the compile-sized allowance:
        a host killed during the minutes-long first compile is still
        detected — just on the startup clock, not the steady-state one).
        `sync_wait_ms` is the host's last log-interval device sync wall
        time — the collectives block until the SLOWEST host, so a host
        with a LOW sync wait next to peers with high ones is itself the
        straggler everyone else is waiting for (straggler_table)."""
        record = {
            "process_index": self.process_index,
            "pid": os.getpid(),
            "ts": self._now(),
            "step": step,
            # host-materialized loader bytes: the per-host data-sharding
            # measurement rides the heartbeat, so a reader can check that
            # each host loaded 1/N of the global batch
            "data_bytes": data_bytes,
            "done": bool(done),
        }
        if allowance_s is not None:
            record["allowance_s"] = float(allowance_s)
        if sync_wait_ms is not None:
            record["sync_wait_ms"] = round(float(sync_wait_ms), 3)
        path = beat_path(self.directory, self.process_index)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(record, fh)
            os.replace(tmp, path)  # readers see old or new, never half
        except OSError:
            # heartbeating is evidence, not correctness: a full disk must
            # not kill training (the watchdog on peers will judge us stale
            # — which, with a dead evidence disk, is the right verdict)
            pass


# ------------------------------------------------------ cross-host watchdog


class CrossHostWatchdog:
    """Judge every host's heartbeat file; abort boundedly on staleness.

    A file is judged only once it EXISTS: hosts write no beat until their
    first completed log interval, so the (minutes-long) initial compile
    can never false-trip the window, and after the first beats land, all
    hosts are in lockstep at collectives, so beats stay aligned. `done`
    beats are exempt (normal completion is not a stall).

    `check()` is the synchronous core (unit-testable with an injected
    clock); `start()` wraps it in a poll thread whose verdict is: flight
    dump -> abort marker -> exit_fn(EXIT_HOST_STALL). The marker
    (`multihost_abort_p<i>.json` next to the heartbeats) is what the
    launcher, or an operator, reads for the named diagnosis; the exit
    code is what a supervisor reacts to."""

    def __init__(
        self,
        directory: str,
        process_index: int,
        window_s: float,
        poll_s: float | None = None,
        grace_s: float | None = None,
        flight: Any = None,
        logger: Any = None,
        now_fn: Callable[[], float] = time.time,
        exit_fn: Callable[[int], None] = os._exit,
    ):
        self.directory = directory
        self.process_index = int(process_index)
        self.window_s = float(window_s)
        self.poll_s = poll_s if poll_s is not None else max(
            min(self.window_s / 4.0, 1.0), 0.05
        )
        # startup grace: judgments begin one full window after start() —
        # process 0 clears the PREVIOUS run's heartbeat files at its own
        # start (an elastic restart at fewer hosts would otherwise judge
        # the dead 4th host's leftover file instantly), and peers' first
        # polls must not race that cleanup
        self.grace_s = float(grace_s) if grace_s is not None else self.window_s
        self.flight = flight
        self.logger = logger
        self._now = now_fn
        self._exit = exit_fn
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check(self) -> dict[int, float]:
        """{process_index: staleness seconds} for every live (not-done)
        heartbeat file older than the window. Empty dict = healthy."""
        stale: dict[int, float] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return stale
        now = self._now()
        for name in names:
            if not (name.startswith("host_") and name.endswith(".json")):
                continue
            beat = read_beat(os.path.join(self.directory, name))
            if beat is None or beat.get("done"):
                continue
            age = now - float(beat.get("ts", 0.0))
            # a beat may carry its own (wider) allowance — the startup
            # beat's compile-sized window (HeartbeatWriter.beat)
            window = max(self.window_s, float(beat.get("allowance_s", 0.0)))
            if age > window:
                stale[int(beat.get("process_index", -1))] = age
        return stale

    def check_or_raise(self) -> None:
        stale = self.check()
        if stale:
            raise HostStallAbort(stale, self.window_s)

    # -- the poll thread ----------------------------------------------------

    def start(self) -> "CrossHostWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, name="mine-multihost-watchdog",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _watch(self) -> None:
        started = self._now()
        while not self._stop.wait(self.poll_s):
            if self._now() - started < self.grace_s:
                continue  # startup grace (see __init__)
            # marker broadcast: a peer that already took the named abort
            # is about to exit (and may take the in-process coordination
            # service with it) — join it NOW with our own evidence rather
            # than eat the runtime's evidence-less SIGABRT moments later
            peers = {
                i: m for i, m in abort_markers(self.directory).items()
                if i != self.process_index
            }
            if peers:
                named_abort(
                    self.directory, self.process_index, "peer_abort",
                    detail={"peer_markers": {
                        str(i): m.get("reason") for i, m in peers.items()
                    }},
                    flight=self.flight, logger=self.logger,
                    exit_fn=self._exit, linger_s=self._linger_s(),
                )
                return
            stale = self.check()
            if stale:
                self._abort(stale)
                return

    def _linger_s(self) -> float:
        """Only process 0 lingers: it hosts the rendezvous store, whose
        end fails any peer still talking to it. Process 0 waiting ~3 polls
        lets every peer see the marker broadcast and exit first; other
        processes' exits endanger nobody, so they leave immediately."""
        if self.process_index != 0:
            return 0.0
        return min(3.0 * self.poll_s, 5.0)

    def _abort(self, stale: dict[int, float]) -> None:
        """The bounded-exit verdict (named_abort with the stall detail)."""
        suspect = max(stale, key=stale.get)
        named_abort(
            self.directory, self.process_index, "host_stall",
            detail={
                "stale_hosts": {
                    str(i): round(a, 3) for i, a in stale.items()
                },
                # oldest silence: the host that froze first
                "suspect": suspect,
                "window_s": self.window_s,
            },
            flight=self.flight, logger=self.logger, exit_fn=self._exit,
            linger_s=self._linger_s(),
        )


def straggler_table(directory: str) -> dict:
    """Per-host progress attribution off the heartbeat files: who is the
    slowest host, and by how much — the question a wedged-but-not-dead
    host raises BEFORE the watchdog window expires and kills the run.

    Reference time is the NEWEST beat (not the wall clock), so the table
    reads identically live and post-mortem (a launcher or a drill reads
    it after the processes exited). Per row: the host's last
    step, how many steps behind the front-runner it is, how long it has
    been silent relative to the newest beat, and its last log-interval
    sync wait (a straggler shows a LOW sync wait while every peer's is
    high — the peers are waiting for it in the collective). `suspect` is
    the worst live (not-done) host, named only when it is actually behind;
    `skew_fraction` = its deficit over the front-runner's step count."""
    beats: list[dict] = []
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for name in names:
        if name.startswith("host_") and name.endswith(".json"):
            beat = read_beat(os.path.join(directory, name))
            if beat is not None:
                beats.append(beat)
    if not beats:
        return {"rows": [], "suspect": None, "skew_fraction": 0.0}
    ref_ts = max(float(b.get("ts", 0.0)) for b in beats)
    ref_step = max(int(b.get("step") or 0) for b in beats)
    rows = []
    for b in sorted(beats, key=lambda b: int(b.get("process_index", -1))):
        step = int(b.get("step") or 0)
        rows.append({
            "host": int(b.get("process_index", -1)),
            "step": b.get("step"),
            "behind_steps": max(ref_step - step, 0),
            "silent_s": round(
                max(ref_ts - float(b.get("ts", ref_ts)), 0.0), 3
            ),
            "sync_wait_ms": b.get("sync_wait_ms"),
            "done": bool(b.get("done")),
        })
    live = [r for r in rows if not r["done"]]
    suspect = None
    skew_fraction = 0.0
    if live:
        worst = max(live, key=lambda r: (r["behind_steps"], r["silent_s"]))
        skew_fraction = round(
            worst["behind_steps"] / max(ref_step, 1), 4
        )
        if worst["behind_steps"] > 0:
            suspect = worst["host"]
    return {"rows": rows, "suspect": suspect, "skew_fraction": skew_fraction}


# what a gloo collective raises when the connection to a peer goes
_PEER_LOSS_MESSAGES = ("Connection closed by peer", "Connection reset by peer")


def is_peer_loss(error: BaseException) -> bool:
    """Whether a collective raised `error` because a peer's connection went
    (the peer process died, or its host): gloo raises a RuntimeError naming
    the closed or reset connection."""
    return isinstance(error, RuntimeError) and any(m in str(error) for m in _PEER_LOSS_MESSAGES)


def abort_markers(directory: str) -> dict[int, dict]:
    """{process_index: marker} for every abort marker under `directory` —
    the operator's read side of the watchdog's verdict."""
    out: dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if name.startswith(_MARKER_PREFIX) and name.endswith(".json"):
            marker = read_beat(os.path.join(directory, name))
            if marker is not None:
                out[int(name[len(_MARKER_PREFIX):-len(".json")])] = marker
    return out


# ----------------------------------------------------- trainer convenience


class MultihostSurvival:
    """The Trainer-facing bundle: heartbeat writer + watchdog, created
    only when this run actually spans processes. One object so the loop's
    integration is three calls (start / beat / stop)."""

    def __init__(self, directory: str, process_index: int, window_s: float,
                 flight: Any = None, logger: Any = None,
                 exit_fn: Callable[[int], None] = os._exit):
        self.directory = directory
        self.process_index = int(process_index)
        self.window_s = float(window_s)
        self.flight = flight
        self.logger = logger
        self._exit = exit_fn
        self.writer = HeartbeatWriter(directory, process_index)
        self._failsafe: threading.Timer | None = None
        self.watchdog = None
        if window_s > 0:
            self.watchdog = CrossHostWatchdog(
                directory, process_index, window_s,
                flight=flight, logger=logger,
            )

    @classmethod
    def maybe_create(cls, cfg: Any, sidecar_dir: str, flight: Any = None,
                     logger: Any = None) -> "MultihostSurvival | None":
        """None on single-process runs: the module costs nothing there."""
        from mine_tpu_torch.parallel.mesh import process_count, process_index

        if process_count() <= 1:
            return None
        directory = cfg.resilience.multihost_heartbeat_dir or os.path.join(
            sidecar_dir, "heartbeats"
        )
        return cls(
            directory, process_index(),
            cfg.resilience.multihost_watchdog_s,
            flight=flight, logger=logger,
        )

    def start(self) -> None:
        if self.process_index == 0:
            # clear the PREVIOUS run's evidence: an elastic restart at
            # fewer hosts must not judge a dead host's leftover heartbeat
            # (or re-read its abort markers as fresh). Age-gated so the
            # sweep cannot eat THIS run's peers' fresh startup beats —
            # the previous run's files are minutes old by any restart.
            now = time.time()
            try:
                for name in os.listdir(self.directory):
                    if not (name.startswith("host_") or
                            name.startswith(_MARKER_PREFIX)):
                        continue
                    path = os.path.join(self.directory, name)
                    try:
                        if now - os.path.getmtime(path) > _CLEANUP_MIN_AGE_S:
                            os.remove(path)
                    except OSError:
                        pass
            except OSError:
                pass
        # the startup beat: a host that dies before its first log-interval
        # beat (bring-up straggler, killed mid-compile) is still judged —
        # on the compile-sized allowance instead of the steady window
        self.writer.beat(allowance_s=STARTUP_ALLOWANCE_S)
        if self.watchdog is not None:
            self.watchdog.start()

    def beat(self, step: int, data_bytes: int | None = None,
             sync_wait_ms: float | None = None) -> None:
        self.writer.beat(step=step, data_bytes=data_bytes,
                         sync_wait_ms=sync_wait_ms)

    def peer_aborted(self) -> bool:
        """Whether another process has taken the named abort (its marker is
        next to the heartbeats)."""
        return any(i != self.process_index for i in abort_markers(self.directory))

    def abort_after_peer(self, error: BaseException) -> None:
        """Exit under the peer's verdict (EXIT_HOST_STALL, reason
        `peer_abort`, this error in the marker). torch.distributed's
        collectives, unlike the JAX package's, do not hang when a peer
        exits: the connection closes and the collective raises, and that
        error is the peer abort's echo, not a failure of its own."""
        markers = abort_markers(self.directory)
        linger_s = 3.0 if self.process_index == 0 else 0.0
        if self.process_index in markers:
            # this process's watchdog has given its verdict already: keep it
            time.sleep(linger_s)
            self._exit(EXIT_HOST_STALL)
            return
        peers = {i: m.get("reason") for i, m in markers.items() if i != self.process_index}
        named_abort(
            self.directory, self.process_index, "peer_abort",
            detail={"peer_markers": {str(i): r for i, r in peers.items()},
                    "error": f"{type(error).__name__}: {error}"[:500]},
            flight=self.flight, logger=self.logger, exit_fn=self._exit, linger_s=linger_s,
        )

    def lost_peer(self, error: BaseException) -> bool:
        """Whether `error` is a collective's peer gone without a word (a
        gloo connection closed or reset: the peer was killed or its host
        lost) that this process's watchdog can judge: no peer has taken the
        named abort, and the watchdog runs."""
        return (self.watchdog is not None and is_peer_loss(error)
                and not self.peer_aborted())

    def await_verdict(self, error: BaseException) -> None:
        """Wait for the named abort after `lost_peer(error)`. The JAX
        package's collectives hang on such a peer until the watchdog judges
        its heartbeat stale; torch.distributed's raise at once, so this
        thread waits in their place while the watchdog thread judges the
        heartbeats (`host_stall`, naming the silent peer), or joins a peer's
        marker (`peer_abort`). Bounded by the failsafe, armed here at two
        windows: the peer's last beat is at most one window plus the
        watchdog's startup grace from its verdict."""
        self.arm_failsafe(seconds=2.0 * self.window_s + self.watchdog.grace_s)
        if self.logger is not None:
            self.logger.error("a collective lost its peer (%s: %s); waiting for the "
                              "cross-host watchdog's verdict", type(error).__name__,
                              str(error)[:300])
        while True:
            if self.peer_aborted():
                self.abort_after_peer(error)
                return
            time.sleep(self.watchdog.poll_s)

    def stragglers(self) -> dict:
        """The straggler table over this run's heartbeat dir — what the
        training loop logs each interval and the drill verdict embeds."""
        return straggler_table(self.directory)

    def arm_failsafe(self, seconds: float | None = None,
                     reason: str = "teardown_hang",
                     linger_s: float | None = None) -> None:
        """Bound this process's remaining lifetime: it is on a failure
        path, and everything left to do (the emergency checkpoint, a
        collective a dead peer never joins, the process group's teardown)
        can block on peers that will never answer. If the process is still
        alive `seconds` from now, take the named abort instead. Arming twice
        keeps the first deadline; a process that exits sooner never sees it
        (daemon timer)."""
        if self._failsafe is not None:
            return
        if seconds is None:
            seconds = self.window_s if self.window_s > 0 else 60.0
        if linger_s is None:
            # the watchdog's rule: only process 0 lingers (it hosts the
            # rendezvous store; see _linger_s)
            linger_s = 3.0 if self.process_index == 0 else 0.0
        self._failsafe = threading.Timer(
            seconds,
            named_abort,
            args=(self.directory, self.process_index, reason),
            kwargs={
                "detail": {"failsafe_s": seconds},
                "flight": self.flight, "logger": self.logger,
                "exit_fn": self._exit,
                # same idea as the watchdog's linger: let peers see the
                # marker before this exit can take the store down with it
                "linger_s": linger_s,
            },
        )
        self._failsafe.daemon = True
        self._failsafe.start()

    def stop(self, done: bool, step: int | None = None,
             data_bytes: int | None = None,
             sync_wait_ms: float | None = None) -> None:
        """`done=True` on clean fit completion ONLY: watchdog off, final
        done beat (exempts this host from peers' staleness judgment; the
        last sync wait rides along so a finished run's straggler table
        keeps the attribution column). `done=False` is a FAILING exit:
        the watchdog stays armed and the failsafe deadline arms on top —
        a crashing host must stay "silent" for peers to judge, and its
        own teardown must stay bounded (arm_failsafe)."""
        if done:
            if self.watchdog is not None:
                self.watchdog.stop()
            if self._failsafe is not None:
                self._failsafe.cancel()
            self.writer.beat(step=step, data_bytes=data_bytes, done=True,
                             sync_wait_ms=sync_wait_ms)
        else:
            self.arm_failsafe()
