"""The port's multi-process survival (mine_tpu_torch/resilience/multihost.py,
parallel/mesh.py's bring-up, obs/collect.py training_timeline) against
mine_tpu/resilience/multihost.py and mine_tpu/obs/collect.py on the same
files, on the CPU.

  * heartbeats: the pinned schema, and beats written by either package read
    the same by both; the watchdog's staleness, its thread's named abort
    and marker, the startup grace and allowance, the start-of-run sweep and
    the teardown failsafe, with injected clocks and exit functions;
  * the straggler table and training_timeline of either package on the
    same files agree;
  * bring_up: the coord_down seam retried with the JAX package's backoff,
    exhaustion, a timeout that is terminal, a no-op one-process run; the
    named MultihostInitTimeout;
  * one spawn of two gloo ranks training through Trainer.fit (data=2) on a
    shared workspace: rank 0 alone writes the workspace, both ranks beat
    heartbeats with equal per-host data bytes, and training_timeline merges
    their host-span exports.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from mine_tpu.obs import collect as jcollect
from mine_tpu.resilience import multihost as jmh
from mine_tpu_torch.obs import collect
from mine_tpu_torch.obs.trace import Tracer
from mine_tpu_torch.resilience import chaos
from mine_tpu_torch.resilience import multihost as mh

PACKAGES = {"port": mh, "jax": jmh}


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    chaos.uninstall()


def test_heartbeat_schema_is_pinned_and_shared(tmp_path):
    """The beat file's keys are the JAX package's, and a beat written by
    either package reads the same in both."""
    assert mh.BEAT_REQUIRED_KEYS == jmh.BEAT_REQUIRED_KEYS == {
        "process_index", "pid", "ts", "step", "data_bytes", "done"}
    assert mh.BEAT_OPTIONAL_KEYS == jmh.BEAT_OPTIONAL_KEYS == {"allowance_s", "sync_wait_ms"}
    assert mh.EXIT_HOST_STALL == jmh.EXIT_HOST_STALL == 83
    for i, writer_pkg in enumerate(PACKAGES.values()):
        d = str(tmp_path / str(i))
        w = writer_pkg.HeartbeatWriter(d, 2, now_fn=lambda: 123.5)
        w.beat(step=7, data_bytes=4096, allowance_s=600.0, sync_wait_ms=12.345)
        beats = [pkg.read_beat(pkg.beat_path(d, 2)) for pkg in PACKAGES.values()]
        assert beats[0] == beats[1]
        assert set(beats[0]) == mh.BEAT_REQUIRED_KEYS | mh.BEAT_OPTIONAL_KEYS
        assert (beats[0]["ts"], beats[0]["step"], beats[0]["sync_wait_ms"]) == (123.5, 7, 12.345)
        w.beat()
        assert set(mh.read_beat(mh.beat_path(d, 2))) == mh.BEAT_REQUIRED_KEYS


@pytest.mark.parametrize("name", PACKAGES)
def test_watchdog_staleness_on_port_beats(tmp_path, name):
    """The port's beats judged by either package's watchdog: the same
    stale hosts, allowances and done exemptions."""
    pkg, d, now = PACKAGES[name], str(tmp_path), [1000.0]
    w0 = mh.HeartbeatWriter(d, 0, now_fn=lambda: now[0])
    w1 = mh.HeartbeatWriter(d, 1, now_fn=lambda: now[0])
    w0.beat(step=4, data_bytes=123)
    w1.beat(allowance_s=120.0)
    wd = pkg.CrossHostWatchdog(d, 0, window_s=10.0, now_fn=lambda: now[0],
                               exit_fn=lambda c: None)
    assert wd.check() == {}
    now[0] += 60.0
    w0.beat(step=5)
    assert wd.check() == {}  # inside host 1's startup allowance
    now[0] += 70.0
    w0.beat(step=6)
    assert wd.check() == {1: pytest.approx(130.0)}
    with pytest.raises(pkg.HostStallAbort, match="host 1 silent"):
        wd.check_or_raise()
    w1.beat(step=6, done=True)
    now[0] += 100.0
    assert 1 not in wd.check()


def test_watchdog_thread_aborts_named_as_jax(tmp_path):
    """The poll thread of each package on the same silent peer: the exit
    code and the marker's reason, suspect and stale hosts agree."""
    markers = {}
    for name, pkg in PACKAGES.items():
        d = str(tmp_path / name)
        w0, w1 = mh.HeartbeatWriter(d, 0), mh.HeartbeatWriter(d, 1)
        w0.beat(step=1)
        w1.beat(step=1)
        exits: list[int] = []
        wd = pkg.CrossHostWatchdog(d, 0, window_s=0.3, poll_s=0.05, grace_s=0.0,
                                   exit_fn=exits.append)
        wd.start()
        try:
            deadline = time.monotonic() + 5.0
            while not exits and time.monotonic() < deadline:
                w0.beat(step=2)
                time.sleep(0.05)
        finally:
            wd.stop()
        assert exits == [83], name
        markers[name] = mh.abort_markers(d)[0]
    for m in markers.values():
        assert (m["reason"], m["suspect"], m["exit_code"], sorted(m["stale_hosts"])) == \
            ("host_stall", 1, 83, ["1"])
    assert set(markers["port"]) == set(markers["jax"])


def test_watchdog_grace_sweep_and_failsafe(tmp_path):
    """The startup grace holds a judgment back; process 0's start sweeps
    the previous run's beats and markers but not a fresh peer's; a failing
    stop arms the failsafe, which takes the named abort; a clean stop
    cancels it and writes the done beat."""
    d = str(tmp_path / "grace")
    mh.HeartbeatWriter(d, 9, now_fn=lambda: 0.0).beat(step=1)
    exits: list[int] = []
    wd = mh.CrossHostWatchdog(d, 0, window_s=0.5, poll_s=0.05, grace_s=10.0,
                              exit_fn=exits.append)
    wd.start()
    time.sleep(0.3)
    wd.stop()
    assert exits == []

    d = str(tmp_path / "sweep")
    mh.HeartbeatWriter(d, 3).beat(step=7)
    mh.named_abort(d, 3, "host_stall", exit_fn=lambda c: None)
    mh.HeartbeatWriter(d, 1).beat(step=1)
    old = time.time() - mh._CLEANUP_MIN_AGE_S - 5.0
    for path in (mh.beat_path(d, 3), os.path.join(d, "multihost_abort_p3.json")):
        os.utime(path, (old, old))
    mh.MultihostSurvival(d, 0, window_s=0.0, exit_fn=lambda c: None).start()
    assert mh.read_beat(mh.beat_path(d, 3)) is None and mh.abort_markers(d) == {}
    assert mh.read_beat(mh.beat_path(d, 1))["step"] == 1
    assert jmh.read_beat(jmh.beat_path(d, 0))["allowance_s"] == jmh.STARTUP_ALLOWANCE_S

    d = str(tmp_path / "failsafe")
    s = mh.MultihostSurvival(d, 2, window_s=0.0, exit_fn=exits.append)
    s.arm_failsafe(seconds=0.1, linger_s=0.0)
    s.stop(done=False)  # keeps the first deadline
    time.sleep(0.5)
    assert exits == [83] and jmh.abort_markers(d)[2]["reason"] == "teardown_hang"
    clean: list[int] = []
    s2 = mh.MultihostSurvival(str(tmp_path / "clean"), 0, window_s=0.0, exit_fn=clean.append)
    s2.arm_failsafe(seconds=0.1)
    s2.stop(done=True, step=6, data_bytes=42)
    time.sleep(0.3)
    assert clean == []
    beat = jmh.read_beat(jmh.beat_path(str(tmp_path / "clean"), 0))
    assert beat["done"] is True and beat["data_bytes"] == 42


def test_a_collective_broken_by_a_peer_exits_under_its_verdict(tmp_path):
    """torch.distributed's collective raises when its peer exits (the JAX
    package's hangs): a process that sees a peer's marker takes the named
    abort, reason peer_abort, the error in its marker; one whose own
    watchdog already judged keeps that verdict."""
    d = str(tmp_path)
    mh.named_abort(d, 1, "host_stall", detail={"suspect": 0}, exit_fn=lambda c: None)
    exits: list[int] = []
    s = mh.MultihostSurvival(d, 2, window_s=0.0, exit_fn=exits.append)
    assert s.peer_aborted()
    s.abort_after_peer(RuntimeError("Connection closed by peer"))
    marker = jmh.abort_markers(d)[2]
    assert exits == [83] and marker["reason"] == "peer_abort"
    assert marker["peer_markers"] == {"1": "host_stall"} and "Connection closed" in marker["error"]
    own = mh.MultihostSurvival(d, 1, window_s=0.0, exit_fn=exits.append)
    own.abort_after_peer(RuntimeError("reset"))
    assert exits == [83, 83] and mh.abort_markers(d)[1]["reason"] == "host_stall"
    assert not mh.MultihostSurvival(str(tmp_path / "quiet"), 0, window_s=0.0).peer_aborted()


@pytest.mark.parametrize("healthy", [False, True])
def test_straggler_table_matches_jax(tmp_path, healthy):
    d, now = str(tmp_path), [1000.0]
    writers = {i: mh.HeartbeatWriter(d, i, now_fn=lambda: now[0]) for i in range(4)}
    if healthy:
        for w in writers.values():
            w.beat(step=4)
    else:
        writers[3].beat(step=5, done=True)
        writers[2].beat(step=2, sync_wait_ms=1.0)
        now[0] += 40.0
        writers[0].beat(step=6, sync_wait_ms=900.0)
        writers[1].beat(step=6, sync_wait_ms=850.0)
    table = mh.straggler_table(d)
    assert table == jmh.straggler_table(d)
    assert table["suspect"] == (None if healthy else 2)
    assert mh.straggler_table(str(tmp_path / "none")) == \
        {"rows": [], "suspect": None, "skew_fraction": 0.0}


def _write_host_export(profile: str, idx: int, step_s: float) -> None:
    """A process's host-span export, as the Trainer writes it: three step
    and three sync spans."""
    tracer = Tracer(enabled=True)
    for _ in range(3):
        with tracer.span("step", cat="train"):
            time.sleep(step_s)
        with tracer.span("sync", cat="train"):
            pass
    tracer.export(os.path.join(profile, f"host_spans_p{idx}.trace.json"))


def test_training_timeline_matches_jax(tmp_path):
    """Both packages' training_timeline on one synthetic sidecar (two
    process exports, a stale one-process export beside them, heartbeats
    with a frozen host): the same per-host distributions, members and
    straggler table; no sidecar export raises the named error in both."""
    sidecar = str(tmp_path)
    profile = os.path.join(sidecar, "profile")
    os.makedirs(profile)
    stale = Tracer(enabled=True)
    for _ in range(7):
        with stale.span("step", cat="train"):
            pass
    stale.export(os.path.join(profile, "host_spans.trace.json"))
    _write_host_export(profile, 0, 0.001)
    _write_host_export(profile, 1, 0.003)
    hb, now = os.path.join(sidecar, "heartbeats"), [500.0]
    mh.HeartbeatWriter(hb, 1, now_fn=lambda: now[0]).beat(step=1, sync_wait_ms=2.0)
    now[0] += 30.0
    mh.HeartbeatWriter(hb, 0, now_fn=lambda: now[0]).beat(step=3, sync_wait_ms=250.0)
    got, want = collect.training_timeline(sidecar), jcollect.training_timeline(sidecar)
    assert got["per_host"] == want["per_host"] and set(got["per_host"]) == {0, 1}
    assert got["per_host"][0]["step"]["count"] == 3
    assert got["stragglers"] == want["stragglers"] and got["stragglers"]["suspect"] == 1
    assert set(got["doc"]["metadata"]["members"]) == set(want["doc"]["metadata"]["members"]) \
        == {"p0", "p1"}
    assert len(got["doc"]["traceEvents"]) == len(want["doc"]["traceEvents"])
    for fn in (collect.training_timeline, jcollect.training_timeline):
        with pytest.raises(FileNotFoundError, match="host_spans"):
            fn(str(tmp_path / "empty"))


def test_bring_up_retries_as_jax():
    """coord_down@init=1 then a good rendezvous: one dial, one backoff of
    backoff_s; every attempt failing raises the fault; a timeout is
    terminal; a one-process run never dials."""
    calls, sleeps = [], []
    chaos.install("coord_down@init=1")
    assert mh.bring_up(coordinator="coord:1234", attempts=3, backoff_s=0.5, device="cpu",
                       initialize_fn=lambda **kw: calls.append(kw), sleep_fn=sleeps.append)
    assert len(calls) == 1 and calls[0]["init_method"] == "tcp://coord:1234"
    assert calls[0]["backend"] == "gloo"  # the CPU's transport
    assert sleeps == [0.5]  # backoff_s * 2**0, as the JAX bring_up
    chaos.install("coord_down@init=1,coord_down@init=2,coord_down@init=3")
    with pytest.raises(chaos.ChaosFault):
        mh.bring_up(coordinator="coord:1234", attempts=3, backoff_s=0.0, device="cpu",
                    initialize_fn=lambda **kw: None, sleep_fn=lambda s: None)
    chaos.uninstall()

    release = threading.Event()
    attempts = []

    def hanging(**kw):
        attempts.append(kw)
        release.wait(30)

    from mine_tpu_torch.parallel.mesh import MultihostInitTimeout

    with pytest.raises(MultihostInitTimeout) as exc:
        mh.bring_up(coordinator="coord:1234", attempts=3, timeout_s=0.2, device="cpu",
                    initialize_fn=hanging, sleep_fn=lambda s: None)
    release.set()
    assert len(attempts) == 1  # not retried
    msg = str(exc.value)
    assert "did not complete within" in msg and "MINE_TPU_MULTIHOST_TIMEOUT_S" in msg
    assert "coord:1234" in msg

    fresh: list = []
    os.environ.pop("WORLD_SIZE", None)
    assert mh.bring_up(initialize_fn=lambda **kw: fresh.append(kw)) is False
    assert fresh == []


def test_refused_connection_is_retried(monkeypatch):
    """A coordinator that refuses the connection (an OSError) is the
    retryable class; any other error is not retried."""
    calls = []

    def refusing(**kw):
        calls.append(kw)
        if len(calls) < 3:
            raise ConnectionRefusedError("not up yet")

    assert mh.bring_up(coordinator="c:1", attempts=3, backoff_s=0.0, device="cpu",
                       initialize_fn=refusing, sleep_fn=lambda s: None)
    assert len(calls) == 3

    def broken(**kw):
        calls.append(kw)
        raise ValueError("bad world size")

    calls.clear()
    with pytest.raises(ValueError, match="bad world size"):
        mh.bring_up(coordinator="c:1", attempts=3, device="cpu", initialize_fn=broken)
    assert len(calls) == 1


def test_train_metric_families_are_the_jax_families():
    """The trainer's gauges and counters, mine_train_data_host_bytes_total
    (the per-host loader bytes) now among them, are the JAX trainer's."""
    from mine_tpu.training.loop import TrainObsMetrics as JaxMetrics
    from mine_tpu_torch.training.loop import TrainObsMetrics

    assert set(TrainObsMetrics().registry._families) == set(JaxMetrics().registry._families)
    assert "mine_train_data_host_bytes_total" in TrainObsMetrics().registry._families


# -- two ranks through Trainer.fit ---------------------------------------------------------

FIT = {"data.img_h": 128, "data.img_w": 128, "model.num_layers": 18, "model.dtype": "float32",
       "mpi.num_bins_coarse": 2, "data.name": "synthetic", "data.visible_point_count": 16,
       "data.per_gpu_batch_size": 1, "data.num_workers": 0, "training.log_interval": 1,
       "training.checkpoint_interval": 100, "obs.enabled": True, "obs.cost_enabled": False,
       "resilience.multihost_watchdog_s": 60.0, "resilience.preempt_save": False}


def fit_rank(world: int, rank: int, port: int, ws: str) -> None:
    """One rank of a data=2 Trainer.fit of 2 steps on a shared workspace."""
    import torch
    import torch.distributed as dist

    from mine_tpu_torch.config import Config
    from mine_tpu_torch.data.synthetic import SyntheticDataset
    from mine_tpu_torch.training.loop import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    trainer = Trainer(Config().replace(**FIT), workspace=ws, device="cpu")
    ds = SyntheticDataset(128, 128, trainer.global_batch, steps_per_epoch=2, n_points=16,
                          host_slice=trainer.host_slice)
    out = trainer.fit(ds, max_steps=2)
    metrics = trainer.obs_metrics.registry.render()
    with open(os.path.join(ws, f"rank{rank}.json"), "w") as fh:
        json.dump({"loss": out["loss"], "host_slice": trainer.host_slice,
                   "global_batch": trainer.global_batch, "metrics": metrics}, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    from test_torch_parallel import spawn_ranks

    ws = str(tmp_path_factory.mktemp("ws"))
    spawn_ranks(fit_rank, 2, ws)
    return ws


def test_two_ranks_train_with_heartbeats_on_one_workspace(fitted):
    """data=2 through Trainer.fit: each rank builds its row of the global
    batch of 2; both ranks beat done heartbeats with equal data bytes, which
    the per-host counter counts too; rank 0 alone writes the train log,
    params.yaml and the checkpoint; the ranks log the same loss."""
    ranks = [json.load(open(os.path.join(fitted, f"rank{r}.json"))) for r in range(2)]
    assert [r["host_slice"] for r in ranks] == [[0, 1], [1, 1]]
    assert {r["global_batch"] for r in ranks} == {2}
    assert ranks[0]["loss"] == ranks[1]["loss"]
    beats = [jmh.read_beat(jmh.beat_path(os.path.join(fitted, "heartbeats"), r)) for r in range(2)]
    assert all(b["done"] and b["step"] == 2 for b in beats)
    assert beats[0]["data_bytes"] == beats[1]["data_bytes"] > 0
    for r, rank in enumerate(ranks):
        line = [ln.split() for ln in rank["metrics"].splitlines()
                if ln.startswith("mine_train_data_host_bytes_total{")]
        assert line == [[f'mine_train_data_host_bytes_total{{process_index="{r}"}}', line[0][1]]]
        assert float(line[0][1]) == beats[r]["data_bytes"]
    with open(os.path.join(fitted, "train_log.jsonl")) as fh:
        assert [json.loads(ln)["global_step"] for ln in fh] == [1, 2]
    assert os.path.exists(os.path.join(fitted, "params.yaml"))
    from mine_tpu_torch.training import checkpoint as ckpt

    assert ckpt.all_steps(fitted) == [2]
    timeline = collect.training_timeline(fitted)
    assert set(timeline["per_host"]) == {0, 1}
    assert all(h["step"]["count"] == 2 for h in timeline["per_host"].values())
    assert timeline["stragglers"]["suspect"] is None
    assert jcollect.training_timeline(fitted)["per_host"] == timeline["per_host"]
