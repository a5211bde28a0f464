"""The port's multi-host harness (mine_tpu_torch/tools/multihost_harness.py,
the counterpart of tools/multihost_harness.py) on the CPU: gloo ranks of the
port's Trainer as subprocesses, their return codes, heartbeats, per-host data
bytes and straggler table; a SIGKILLed rank's survivor ending in the named
abort (exit 83) through the watchdog, as the JAX package's survivors do; the
chaos drill's training half resumed bit for bit; and the drill's multihost
half (slow)."""

import json

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from mine_tpu_torch.resilience import multihost as mh
from mine_tpu_torch.tools import chaos_drill
from mine_tpu_torch.tools import multihost_harness as harness

OVERRIDES = {
    "data.name": "synthetic", "data.img_h": 128, "data.img_w": 128,
    "data.per_gpu_batch_size": 1, "data.num_workers": 0,
    "model.num_layers": 18, "model.dtype": "float32", "model.imagenet_pretrained": False,
    "mpi.num_bins_coarse": 2, "training.epochs": 1, "training.log_interval": 1,
    "training.checkpoint_interval": 2, "obs.enabled": True,
    "resilience.multihost_watchdog_s": 20.0,
}
STEPS = 3


def _batch_bytes(rows: int) -> int:
    from mine_tpu_torch.data.synthetic import make_synthetic_batch

    batch = make_synthetic_batch(rows, 128, 128, n_points=32)
    batch.pop("src_depth")
    return sum(v.nbytes for v in batch.values())


@pytest.fixture(scope="module")
def healthy(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh")
    return harness.launch(str(root / "ws"), 2, STEPS, OVERRIDES, timeout_s=300.0,
                          workdir=str(root / "wd"), device="cpu")


def test_two_cpu_ranks_train_to_the_end(healthy):
    assert healthy.returncodes == [0, 0], [h.log[-2000:] for h in healthy.hosts]
    assert all("HARNESS_DONE" in h.log and not h.timed_out for h in healthy.hosts)
    assert not healthy.abort_markers() and not healthy.flight_dump_dirs()
    # on the CPU no kernel launches; every host wrote its counts
    assert set(healthy.launches()) == {0, 1}
    assert healthy.total_launches() == {"warp_bilinear": 0, "warp_bilinear_grad": 0,
                                        "warp_composite": 0}
    from mine_tpu_torch.training import checkpoint as ckpt

    assert ckpt.all_steps(healthy.workspace) == [2, 3]
    assert ckpt.last_good_step(healthy.workspace) == STEPS


def test_heartbeats_count_each_hosts_half_of_the_batch(healthy):
    beats = healthy.heartbeats()
    per_host = _batch_bytes(2) // 2
    assert set(beats) == {0, 1}
    for beat in beats.values():
        assert beat["done"] and beat["step"] == STEPS
        assert beat["data_bytes"] == STEPS * per_host
        assert set(beat) <= mh.BEAT_REQUIRED_KEYS | mh.BEAT_OPTIONAL_KEYS


def test_straggler_table_of_a_healthy_run_names_no_one(healthy):
    table = healthy.straggler_table()
    assert table["suspect"] is None and table["skew_fraction"] == 0.0
    assert [r["host"] for r in table["rows"]] == [0, 1]
    assert all(r["behind_steps"] == 0 and r["done"] and r["sync_wait_ms"] is not None
               for r in table["rows"])


def test_a_killed_ranks_survivor_ends_in_the_named_abort(tmp_path):
    """host_kill@step=2 on rank 1: rank 0's next collective raises (gloo:
    "Connection closed by peer"); the loop hands it to the watchdog, which
    judges rank 1's heartbeat stale and takes the named abort naming it, with
    a flight dump and no emergency checkpoint."""
    window = 12.0
    result = harness.launch(
        str(tmp_path / "ws"), 2, 5,
        dict(OVERRIDES, **{"resilience.multihost_watchdog_s": window}),
        faults={1: "host_kill@step=2"}, timeout_s=300.0, workdir=str(tmp_path / "wd"),
        device="cpu")
    assert result.hosts[1].died_by_signal == 9
    assert result.hosts[0].watchdog_aborted, result.hosts[0].log[-3000:]
    assert "waiting for the cross-host watchdog's verdict" in result.hosts[0].log
    markers = result.abort_markers()
    assert set(markers) == {0} and markers[0]["reason"] == "host_stall"
    assert markers[0]["suspect"] == 1 and markers[0]["stale_hosts"]["1"] > window
    assert len(result.flight_dump_dirs()[0]) >= 1
    table = result.straggler_table()
    assert table["suspect"] == 1 and table["skew_fraction"] > 0
    from mine_tpu_torch.training import checkpoint as ckpt

    assert ckpt.all_steps(result.workspace) == [2]  # no emergency save of step 2's peer loss
    assert ckpt.last_good_step(result.workspace) == 2


def test_peer_loss_is_told_from_other_errors(tmp_path):
    closed = RuntimeError("[pair.cc:553] Connection closed by peer [127.0.0.1]:1. This is "
                          "typically caused by a remote worker crashing.")
    assert mh.is_peer_loss(closed)
    assert mh.is_peer_loss(RuntimeError("Connection reset by peer"))
    assert not mh.is_peer_loss(RuntimeError("CUDA out of memory"))
    assert not mh.is_peer_loss(ValueError("Connection closed by peer"))
    exits = []
    d = str(tmp_path / "beats")
    off = mh.MultihostSurvival(d, 0, 0.0, exit_fn=exits.append)
    assert not off.lost_peer(closed)  # no watchdog: nothing would judge
    surv = mh.MultihostSurvival(d, 0, 5.0, exit_fn=exits.append)
    assert surv.lost_peer(closed)
    # a peer's marker already there: the wait ends under its verdict at once
    mh.named_abort(d, 1, "host_stall", detail={"suspect": 2}, exit_fn=lambda c: None)
    assert not surv.lost_peer(closed)
    surv.await_verdict(closed)
    surv._failsafe.cancel()
    marker = mh.abort_markers(d)[0]
    assert exits == [mh.EXIT_HOST_STALL] and marker["reason"] == "peer_abort"
    assert marker["peer_markers"] == {"1": "host_stall"}


def test_devices_and_cli(tmp_path, capsys, monkeypatch):
    assert harness.host_devices("cpu", 3) == ["cpu"] * 3
    assert harness.host_devices("cuda:1", 2) == ["cuda:1", "cuda:1"]
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.host_devices(None, 2)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    assert harness.host_devices("cuda", 3) == ["cuda:0"] * 3
    calls = {}

    def fake_launch(workspace, n_hosts, steps, overrides, faults, timeout_s, device):
        calls.update(n=n_hosts, steps=steps, overrides=overrides, faults=faults, device=device)
        return harness.LaunchResult(workspace, str(tmp_path), [
            harness.HostResult(i, 0, False, "") for i in range(n_hosts)], 1.0)

    monkeypatch.setattr(harness, "launch", fake_launch)
    rc = harness.main(["--n-hosts", "3", "--steps", "2", "--workspace", str(tmp_path / "ws"),
                       "--fault", "1:host_kill@step=1", "--override",
                       "resilience.multihost_watchdog_s=7", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1
    verdict = json.loads(out[0])
    assert verdict["returncodes"] == [0, 0, 0] and verdict["device"] == "cpu"
    assert calls["faults"] == {1: "host_kill@step=1"} and calls["device"] == "cpu"
    assert calls["overrides"]["resilience.multihost_watchdog_s"] == 7


def test_drill_training_resume_is_bitwise_on_the_cpu(tmp_path, monkeypatch):
    """The chaos drill's training half with its exactness run: four ranks of
    the data=2 x fsdp=2 mesh with ZeRO-1 preempted at step 4 and resumed end
    bit for bit with an uninterrupted run, every rank's restore too."""
    monkeypatch.setenv("MINE_TPU_PERF_LEDGER", str(tmp_path / "ledger.jsonl"))
    result = chaos_drill.training_half(str(tmp_path), steps=5, exact=True, timeout_s=600.0,
                                       device="cpu")
    assert result["ok"], json.dumps(result, indent=1)
    assert result["bitwise_mismatched_leaves"] == 0
    assert result["restore_mismatched_leaves"] == [0] * 4 and result["restore_ok"]
    assert result["exactness_rule"].startswith("bitwise")


@pytest.mark.slow
def test_multihost_drill_half(tmp_path, monkeypatch):
    """The 4-rank kill, the elastic 3-rank restart against the same step at 4
    ranks, and the exact 2-rank resume, as `python -m
    mine_tpu_torch.tools.chaos_drill --half multihost --device cpu` runs them."""
    monkeypatch.setenv("MINE_TPU_PERF_LEDGER", str(tmp_path / "ledger.jsonl"))
    verdict = chaos_drill.multihost_half(str(tmp_path), timeout_s=900.0, device="cpu")
    assert verdict["ok"], json.dumps(verdict, indent=2, default=str)
    assert verdict["bitwise_mismatched_leaves"] == 0
