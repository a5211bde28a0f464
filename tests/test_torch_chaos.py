"""The port's resilience seams against mine_tpu/resilience (chaos.py,
preempt.py) and its trainer's and server's fault paths, on the CPU.

  * ChaosSchedule: the same specs through both packages give the same
    should() sequences, the same pending lists and the same parse errors,
    the multi-host kinds included.
  * PreemptionGuard: saves then chains, a failed save still chains, and a
    signal inside a step (deferring()) saves at the step's end.
  * Trainer: preempt_exit@step=2 then a resume is bit-equal to an
    uninterrupted run; nan_loss@step=2 under the skip policy leaves the
    parameters at step 1's; loader_raise is retried and counted.
  * Serving over fake weights (serving/fake.py): predict_raise, engine_raise,
    corrupt_swap, corrupt_ckpt, overload_spike, replica_kill, and the
    autoscaler's join_stall and drain_timeout; the engine's predict cost
    gauges on a real tiny engine.
"""

from __future__ import annotations

import io
import json
import math
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from mine_tpu.resilience import chaos as jchaos
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.pipeline import prefetch
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.resilience import chaos
from mine_tpu_torch.resilience.chaos import PreemptedError
from mine_tpu_torch.resilience.preempt import PreemptionGuard
from mine_tpu_torch.serving import autoscale as tauto
from mine_tpu_torch.serving.engine import RenderEngine
from mine_tpu_torch.serving.fake import make_fake_app
from mine_tpu_torch.serving.server import make_server
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.training.loop import Trainer
from mine_tpu_torch.training.step import build_model
from tests.test_torch_autoscale import _Elastic
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    """Every test starts and ends without an installed fault schedule."""
    chaos.uninstall()
    jchaos.uninstall()
    yield
    chaos.uninstall()
    jchaos.uninstall()


# -- the schedule ------------------------------------------------------------------------

_CALLS = [("nan_loss", 6), ("nan_loss", 7), ("nan_loss", 7), ("loader_raise", None),
          ("loader_raise", None), ("loader_raise", None), ("loader_raise", None),
          ("engine_raise", None), ("sigterm", 11), ("spike_loss", 3), ("predict_raise", None),
          ("corrupt_swap", None), ("corrupt_ckpt", None), ("corrupt_ckpt", None),
          ("overload_spike", None), ("replica_kill", None), ("join_stall", None),
          ("drain_timeout", None), ("drain_timeout", None), ("preempt_exit", 2),
          ("sigusr2", 4)]


@pytest.mark.parametrize("spec", [
    "nan_loss@step=7,loader_raise@batch=3,engine_raise@render=2",
    "sigterm@step=11,spike_loss@step=3,predict_raise@predict=1",
    "corrupt_swap@swap=1,corrupt_ckpt@swap=2,overload_spike@request=1,replica_kill@request=1",
    "join_stall@scale=1,drain_timeout@scale=2,preempt_exit@step=2,sigusr2@step=4",
    " nan_loss@step=7 , nan_loss@step=7",
    "",
])
def test_schedules_fire_as_in_jax(spec):
    ours, theirs = chaos.ChaosSchedule(spec), jchaos.ChaosSchedule(spec)
    assert [ours.should(k, at) for k, at in _CALLS] == [theirs.should(k, at) for k, at in _CALLS]
    assert ours.pending() == theirs.pending()


@pytest.mark.parametrize("spec,match", [
    ("frobnicate@step=1", "unknown"), ("nan_loss@batch=1", "counts"),
    ("nan_loss=3", "kind@counter"), ("nan_loss@step=0", ">= 1"), ("nan_loss@step=x", "kind@c"),
])
def test_parse_errors_match_jax(spec, match):
    for module in (chaos, jchaos):
        with pytest.raises(ValueError, match=match):
            module.ChaosSchedule(spec)
    for module in (chaos, jchaos):
        with pytest.raises(ValueError, match="needs at="):
            module.ChaosSchedule("sigterm@step=1").should("sigterm")


@pytest.mark.parametrize("spec", ["host_kill@step=3", "host_stall@step=2", "coord_down@init=1"])
def test_multihost_kinds_are_refused_by_the_port(spec):
    """The multi-host kinds, refused until the parallel slice gave them
    their seams (training/loop.py, resilience/multihost.py bring_up), parse
    as in the JAX package, counter included; a wrong counter is still a
    parse error in both."""
    assert chaos.ChaosSchedule(spec).pending() == jchaos.ChaosSchedule(spec).pending() == [spec]
    kind = spec.split("@")[0]
    assert chaos.KINDS[kind] == jchaos.KINDS[kind]
    for module in (chaos, jchaos):
        with pytest.raises(ValueError):
            module.ChaosSchedule(f"{kind}@swap=1")


def test_environment_activation(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "sigusr2@step=5")
    assert chaos.ENV_VAR == jchaos.ENV_VAR == "MINE_TPU_FAULTS"
    chaos.uninstall()
    assert chaos.should("sigusr2", at=5) and not chaos.should("sigusr2", at=5)
    monkeypatch.delenv(chaos.ENV_VAR)
    chaos.uninstall()
    assert chaos.active() is None and not chaos.should("sigusr2", at=5)
    chaos.install("engine_raise@render=1")
    with pytest.raises(chaos.ChaosFault, match="engine_raise@render=1"):
        chaos.maybe_raise("engine_raise")
    chaos.maybe_raise("engine_raise")  # spent


def test_loader_seam_is_retried_inside_the_pipeline():
    """loader_raise@batch=2 with one retry: the batches equal a clean run's,
    and the retry is reported once."""
    items = [{"x": np.full(2, i)} for i in range(4)]
    clean = [b["x"][0] for b in prefetch(items, 2, fault_seam="loader_raise")]
    chaos.install("loader_raise@batch=2")
    retries = []
    got = [b["x"][0] for b in prefetch(items, 2, retries=1, retry_base_delay_s=0.0,
                                       on_retry=lambda n, e: retries.append(type(e)),
                                       fault_seam="loader_raise")]
    assert got == clean == [0, 1, 2, 3] and retries == [chaos.ChaosFault]
    chaos.install("loader_raise@batch=1")
    with pytest.raises(chaos.ChaosFault):
        list(prefetch(items, 0, fault_seam="loader_raise"))


# -- the preemption guard -------------------------------------------------------------------


def test_preemption_guard_saves_then_chains():
    events: list[str] = []
    prev_term = signal.signal(signal.SIGTERM, lambda s, f: events.append("prev_handler"))
    prev_usr2 = signal.getsignal(signal.SIGUSR2)
    try:
        guard = PreemptionGuard(lambda reason: events.append(f"save:{reason}")).install()
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            assert events == ["save:signal_sigterm", "prev_handler"]
            # SIGUSR2 with its default disposition: save and continue
            os.kill(os.getpid(), signal.SIGUSR2)
            assert events[-1] == "save:signal_sigusr2"
            assert guard.triggered == ["SIGTERM", "SIGUSR2"]
        finally:
            guard.uninstall()
        assert signal.getsignal(signal.SIGUSR2) == prev_usr2
    finally:
        signal.signal(signal.SIGTERM, prev_term)


def test_preemption_guard_save_failure_never_blocks_chain():
    events: list[str] = []
    prev = signal.signal(signal.SIGUSR2, lambda s, f: events.append("prev"))
    try:
        def broken_save(reason):
            raise RuntimeError("disk full")

        guard = PreemptionGuard(broken_save, signals=(signal.SIGUSR2,)).install()
        try:
            os.kill(os.getpid(), signal.SIGUSR2)
            assert events == ["prev"]
        finally:
            guard.uninstall()
    finally:
        signal.signal(signal.SIGUSR2, prev)


def test_a_signal_inside_a_step_saves_at_its_end():
    """The trap of in-place updates: a signal that lands inside
    optimizer.step() must not save a half-updated model. Inside deferring()
    the handler only records the signal; the save, then the chain, run when
    the outermost region ends, even when it ends by an exception. (The
    trainer's case, a signal inside a poisoned step, is in
    test_nan_loss_under_skip_keeps_the_parameters.)"""
    events: list[str] = []
    prev = signal.signal(signal.SIGUSR2, lambda s, f: events.append("prev"))
    try:
        guard = PreemptionGuard(lambda reason: events.append(f"save:{reason}"),
                                signals=(signal.SIGUSR2,)).install()
        try:
            with guard.deferring():
                with guard.deferring():  # a checkpoint write inside the step
                    os.kill(os.getpid(), signal.SIGUSR2)
                    events.append("mid-step")
                assert events == ["mid-step"]
            assert events == ["mid-step", "save:signal_sigusr2", "prev"]
            with pytest.raises(RuntimeError):
                with guard.deferring():
                    os.kill(os.getpid(), signal.SIGUSR2)
                    raise RuntimeError("the step failed")
            assert events[-2:] == ["save:signal_sigusr2", "prev"]
            os.kill(os.getpid(), signal.SIGUSR2)  # outside a step: at once
            assert events[-2:] == ["save:signal_sigusr2", "prev"] and len(events) == 7
        finally:
            guard.uninstall()
    finally:
        signal.signal(signal.SIGUSR2, prev)


# -- the trainer's fault paths ---------------------------------------------------------------

TINY = {"data.name": "synthetic", "data.img_h": 128, "data.img_w": 128,
        "model.num_layers": 18, "mpi.num_bins_coarse": 4, "data.per_gpu_batch_size": 1,
        "model.dtype": "float32", "model.imagenet_pretrained": False,
        "data.num_workers": 0, "training.log_interval": 1}


@pytest.fixture(scope="module")
def tiny_state():
    cfg = Config().replace(**TINY)
    return init_weights(build_model(cfg), torch.Generator().manual_seed(0)).state_dict()


def _params(trainer) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def test_preempt_exit_then_resume_is_bit_equal(tmp_path, tiny_state):
    """preempt_exit@step=2 unwinds fit through the emergency checkpoint (and
    the flight dump, obs on); a new Trainer on the workspace resumes at step
    2 and ends bit-equal to an uninterrupted 3-step run, with the SIGTERM
    and SIGUSR2 handlers restored after each fit. The uninterrupted run
    takes a sigusr2@step=1: the guard saves step 1 (and marks it last-good)
    and the run goes on, unperturbed."""
    cfg = Config().replace(**TINY)
    handlers = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR2)
    chaos.install("sigusr2@step=1")
    straight = Trainer(cfg, str(tmp_path / "a"), device="cpu", state_dict=tiny_state)
    straight.fit(build_dataset(cfg, "train", 1), max_steps=3)
    assert ckpt.all_steps(str(tmp_path / "a")) == [1, 3] and chaos.active().pending() == []

    ws = str(tmp_path / "b")
    chaos.install("preempt_exit@step=2")
    cut = Trainer(cfg.replace(**{"obs.enabled": True}), ws, device="cpu",
                  state_dict=tiny_state)
    with pytest.raises(PreemptedError):
        cut.fit(build_dataset(cfg, "train", 1), max_steps=3)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR2)) == handlers
    assert ckpt.all_steps(ws) == [2]
    dumps = os.listdir(os.path.join(ws, "flight", f"pid{os.getpid()}"))
    assert len(dumps) == 1 and dumps[0].endswith("train_exception")
    resumed = Trainer(cfg, ws, device="cpu", state_dict=tiny_state)
    resumed.fit(build_dataset(cfg, "train", 1), max_steps=3)
    assert resumed.global_step == 3
    want, got = _params(straight), _params(resumed)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_nan_loss_under_skip_keeps_the_parameters(tmp_path, tiny_state):
    """nan_loss@step=2 with resilience.sentinel_policy skip: the poisoned
    step's update is dropped (parameters and BatchNorm statistics equal
    step 1's), the sentinel counts it, and step 3 trains on with a finite
    loss. A loader_raise@batch=3 with one retry rides along and is counted.
    A SIGUSR2 sent inside the poisoned step saves it at the step's end but
    does not mark it last-good: its sentinel flag is queued before the
    guard's save vets it."""
    ws = str(tmp_path / "ws")
    cfg = Config().replace(**{**TINY, "resilience.sentinel_policy": "skip",
                              "data.loader_retries": 1})
    trainer = Trainer(cfg, ws, device="cpu", state_dict=tiny_state)
    after, losses = {}, {}
    step = trainer.step

    def record(batch):
        if trainer.global_step == 1:  # inside step 2, the poisoned one
            os.kill(os.getpid(), signal.SIGUSR2)
        out = step(batch)
        after[trainer.global_step] = _params(trainer)
        losses[trainer.global_step] = float(out["loss"])
        return out

    # the guard chains to this handler right after its save
    at_chain: list = []
    prev = signal.signal(signal.SIGUSR2, lambda s, f: at_chain.append(
        (ckpt.all_steps(ws), ckpt.last_good_step(ws))))
    try:
        trainer.step = record
        chaos.install("nan_loss@step=2,loader_raise@batch=3")
        trainer.fit(build_dataset(cfg, "train", 1), max_steps=3)
    finally:
        signal.signal(signal.SIGUSR2, prev)
    assert not math.isfinite(losses[2]) and math.isfinite(losses[3])
    assert all(torch.equal(after[2][k], after[1][k]) for k in after[1])
    assert not all(torch.equal(after[3][k], after[2][k]) for k in after[2])
    assert trainer.sentinel.skipped_updates == 1
    assert trainer.obs_metrics.data_retries.value(process_index="0") == 1
    assert chaos.active().pending() == []
    assert at_chain == [([2], None)]


# -- serving ------------------------------------------------------------------------------------


def _png(i: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 40 * i % 256, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _http(base, path, data=None, timeout=30):
    headers = {"Content-Type": "application/json" if path == "/render" else "image/png"}
    req = urllib.request.Request(base + path, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@pytest.fixture()
def fake_server():
    """A real ServingApp over FakeEngine behind its HTTP server."""
    served = []

    def start(**kwargs):
        app = make_fake_app(checkpoint_step=1, device="cpu", **kwargs)
        server = make_server(app)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        served.append((app, server))
        return app, "http://%s:%d" % server.server_address[:2]

    yield start
    for app, server in served:
        server.shutdown()
        server.server_close()
        app.close()


def test_predict_and_engine_raise_are_counted_5xx_then_recover(fake_server):
    app, base = fake_server()
    chaos.install("predict_raise@predict=1,engine_raise@render=1")
    code, body = _http(base, "/predict", _png(1))
    assert code == 500 and "predict_raise" in json.loads(body)["error"]
    assert app.metrics.engine_failures.value(kind="predict") == 1
    assert app.breaker.state == "closed"  # 1 of 5 consecutive failures
    code, body = _http(base, "/predict", _png(1))
    assert code == 200
    key = json.loads(body)["mpi_key"]
    render = json.dumps({"mpi_key": key, "offsets": [[0.01, 0.0, 0.0]]}).encode()
    code, body = _http(base, "/render", render)
    assert code == 500 and "engine_raise" in json.loads(body)["error"]
    assert app.metrics.engine_failures.value(kind="render") == 1
    assert _http(base, "/render", render)[0] == 200
    assert chaos.active().pending() == []


@pytest.mark.parametrize("kind,reason", [("corrupt_swap", "load"), ("corrupt_ckpt", "corrupt")])
def test_corrupt_swap_is_refused_and_the_old_weights_serve(fake_server, kind, reason):
    from mine_tpu_torch.serving.fake import fake_checkpoint

    app, base = fake_server(swap_source=lambda: fake_checkpoint(2))
    chaos.install(f"{kind}@swap=1")
    status = app.swap(wait=True)
    assert status["state"] == "failed" and status["reason"] == reason
    assert app.engine.generation == 0 and app.engine.checkpoint_step == 1
    assert app.metrics.swap_failures.value(reason=reason) == 1
    assert _http(base, "/predict", _png(2))[0] == 200
    status = app.swap(wait=True)  # the fault fired once: the next swap flips
    assert status["state"] == "ok" and app.engine.generation == 1


def test_overload_spike_walks_the_ladder_to_its_top(fake_server):
    cfg = Config().replace(**{"data.img_h": 128, "data.img_w": 128, "mpi.num_bins_coarse": 2,
                              "serving.degrade_enabled": True,
                              "serving.degrade_relax_after": 1000})
    app, base = fake_server(cfg=cfg)
    chaos.install("overload_spike@request=1")
    for _ in range(7):  # engage_after 2 x max_level 3 + 1 synthetic breaches
        assert _http(base, "/metrics")[0] == 200
    assert app.degrade.level == 3
    assert app.metrics.degradation_level.value() == 3


def test_replica_kill_drops_the_connection_and_the_listener(fake_server):
    app, base = fake_server()
    chaos.install("replica_kill@request=2")
    assert _http(base, "/healthz")[0] == 200
    with pytest.raises(OSError):  # the connection drops with no response
        _http(base, "/healthz", timeout=10)
    host, port = base.rsplit("/", 1)[1].split(":")
    deadline = time.monotonic() + 10.0
    while True:  # then the listener goes away
        try:
            socket.create_connection((host, int(port)), timeout=1.0).close()
        except ConnectionRefusedError:
            break
        assert time.monotonic() < deadline, "the killed replica still accepts"
        time.sleep(0.05)


def test_join_stall_and_drain_timeout_never_break_membership():
    pool = tauto.InProcessPool(lambda: make_fake_app(checkpoint_step=1, device="cpu"))
    ef = _Elastic(pool, 2, min_replicas=2, max_replicas=3)
    try:
        assert ef.predict(1)[0] == 200
        events = ef.fleet.metrics.autoscale_events
        chaos.install("join_stall@scale=1,drain_timeout@scale=1")
        assert ef.controller.scale_to(3) == 2  # the stalled joiner is retired
        assert events.value(direction="join", outcome="aborted") == 1
        assert len(ef.fleet.ring_members()) == 2 and len(pool.names()) == 2
        assert ef.controller.scale_to(3) == 3
        assert ef.controller.scale_to(2) == 2  # the handoff fails, the drain completes
        assert events.value(direction="drain", outcome="handoff_aborted") == 1
        assert len(ef.fleet.ring_members()) == 2 and len(pool.names()) == 2
        code, key = ef.predict(1)
        assert code == 200 and ef.render(1, key)[-1] == 200
    finally:
        ef.close()


def test_engine_predict_sets_the_cost_gauges(tiny_state):
    """A real engine at ResNet-18, 128x128, S=4: the warm-up counts the
    predict's FLOPs once; a predict then sets mine_serve_step_flops and a
    finite mine_serve_mfu against the given peak."""
    from mine_tpu_torch.serving.metrics import ServingMetrics

    cfg = Config().replace(**TINY)
    metrics = ServingMetrics()
    engine = RenderEngine(cfg, tiny_state, metrics=metrics, device="cpu",
                          peak_flops_override=1e12)
    engine.warmup(pose_counts=(1,))
    flops = engine.bucket().predict_cost.flops
    assert flops and flops > 1e9
    assert metrics.step_flops.value(kind="predict") == 0  # unset before a predict
    engine.predict(np.zeros((128, 128, 3), np.uint8))
    assert metrics.step_flops.value(kind="predict") == flops
    assert 0 < metrics.mfu.value() < math.inf
    assert metrics.achieved_tflops.value() == pytest.approx(metrics.mfu.value() * 1e12 / 1e12)
    assert "mine_serve_mfu " in metrics.render()


class _TimingEvent:
    """A CUDA timing event's query/elapsed_time, on a made-up clock (ms)."""

    def __init__(self, t_ms: float, done: bool = True):
        self.t_ms, self.done = t_ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "_TimingEvent") -> float:
        return end.t_ms - self.t_ms


def test_predict_costs_on_the_card_publish_once_their_end_event_completes(fake_server):
    """On the card, a predict queues its FLOPs with two timing events and
    nothing waits for them: publish_cost (the next predict, each /metrics
    scrape) sets the rate gauges from every predict whose end event has
    completed, oldest first, and keeps the others queued."""
    app, base = fake_server()
    engine, m = app.engine, app.metrics
    engine.peak_flops = 1e12
    late = _TimingEvent(12.0, done=False)
    engine._pending_costs.extend([(2e9, _TimingEvent(0.0), _TimingEvent(4.0)),
                                  (2e9, _TimingEvent(10.0), late)])
    engine.publish_cost()
    assert m.achieved_tflops.value() == pytest.approx(0.5, rel=1e-12)  # 2e9 in 4 ms
    assert m.mfu.value() == pytest.approx(0.5, rel=1e-12)
    assert len(engine._pending_costs) == 1
    late.done = True
    code, text = _http(base, "/metrics")
    assert code == 200 and not engine._pending_costs
    assert m.mfu.value() == pytest.approx(1.0, rel=1e-12)  # 2e9 in 2 ms
    assert [float(ln.split()[1]) for ln in text.decode().splitlines()
            if ln.startswith("mine_serve_mfu ")] == [1.0]


def test_a_counted_predict_never_lowers_the_served_peak_gauge(monkeypatch):
    """The cost counter reads the allocator's process-wide peak and never
    resets it: a bucket's first (counted) predict after start-up leaves
    mine_serve_hbm_peak_bytes where it was. torch.cuda's allocator is faked
    by a process-wide peak that only a reset lowers."""
    from mine_tpu_torch.obs.memlog import device_memory_stats

    alloc = {"live": 1e9, "peak": 10e9}

    def reset(device=None):
        alloc["peak"] = alloc["live"]

    for name, fn in {"is_available": lambda: True, "is_initialized": lambda: True,
                     "synchronize": lambda device=None: None,
                     "memory_allocated": lambda device=None: alloc["live"],
                     "max_memory_allocated": lambda device=None: alloc["peak"],
                     "reset_peak_memory_stats": reset}.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    app = make_fake_app(checkpoint_step=1, device="cpu")
    try:
        app.memlog._stats_fn = lambda: device_memory_stats("cuda")
        app.memlog.sample()
        peak = app.metrics.hbm_peak_bytes.value()
        assert peak == 10e9
        bucket = app.engine.bucket()
        assert bucket.predict_cost is None  # the predict below is the counted one
        app.engine.predict(np.zeros((8, 8, 3), np.uint8))
        assert bucket.predict_cost is not None
        assert bucket.predict_cost.peak_memory_bytes is None  # under the earlier peak
        app.memlog.sample()
        assert app.metrics.hbm_peak_bytes.value() == peak == alloc["peak"]
    finally:
        app.close()
