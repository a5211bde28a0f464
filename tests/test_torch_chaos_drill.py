"""The port's chaos drill (python -m mine_tpu_torch.tools.chaos_drill, the
counterpart of tools/chaos_drill.py) on the CPU.

  * the fleet, scale and brownout halves (fake-weight engines) beside the
    JAX drill's halves, called in the same test: the same keys, and every
    boolean gate true in both;
  * the training half as the JAX drill's smoke runs it (`--half training
    --no-exact --steps 5`, its assertions: tests/test_resilience.py), on four
    gloo ranks of the data=2 x fsdp=2 mesh with ZeRO-1;
  * the serving half over that run's checkpoint;
  * the perf-ledger gate failing the drill on a regression.

Every run points $MINE_TPU_PERF_LEDGER at a temporary file: nothing writes
the checkout's default ledger."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from mine_tpu_torch.tools import chaos_drill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def temp_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("MINE_TPU_PERF_LEDGER", str(tmp_path / "ledger.jsonl"))


def _jax_drill():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_drill", os.path.join(REPO, "tools", "chaos_drill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gates(result: dict) -> dict:
    return {k: v for k, v in result.items() if isinstance(v, bool)}


@pytest.mark.parametrize("half", ["fleet", "scale", "brownout"])
def test_fake_weight_half_passes_every_gate_the_jax_half_passes(half):
    port = getattr(chaos_drill, f"{half}_half")(timeout_s=120.0, device="cpu")
    jax_half = getattr(_jax_drill(), f"{half}_half")
    if half == "brownout":
        # in a fresh process the JAX fake engine's first predict compiles
        # (~3 s), past the 2 s latency objective, and the burn it leaves in
        # the 300 s window keeps the ladder from relaxing
        # (recovered_to_zero): its first run warms the process
        jax_half(timeout_s=120.0)
    jax = jax_half(timeout_s=120.0)
    assert set(port) == set(jax) | {"seconds"}
    assert _gates(jax) and set(_gates(port)) == set(_gates(jax))
    assert all(_gates(jax).values()), {k: v for k, v in _gates(jax).items() if not v}
    assert all(_gates(port).values()), json.dumps(port, indent=1, default=str)
    for key in ("slo_kill", "slo_swap", "slo_join", "slo_stall", "slo_drain"):
        if key in jax:
            assert port[key]["ok"] and jax[key]["ok"]
            assert set(port[key]["objectives"]) == set(jax[key]["objectives"])


@pytest.fixture(scope="module")
def training_smoke(tmp_path_factory):
    """The drill's CLI, as the JAX smoke runs it, plus --device cpu."""
    workdir = tmp_path_factory.mktemp("drill")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MINE_TPU_PERF_LEDGER=str(workdir / "ledger.jsonl"))
    proc = subprocess.run(
        [sys.executable, "-m", "mine_tpu_torch.tools.chaos_drill", "--half", "training",
         "--no-exact", "--steps", "5", "--workdir", str(workdir), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=workdir)
    return workdir, proc


def test_training_half_smoke(training_smoke):
    workdir, proc = training_smoke
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    lines = proc.stdout.strip().splitlines()
    verdict = json.loads(lines[-1])
    assert verdict["ok"] is True and len(lines) == 1
    t = verdict["training"]
    assert t["died_by_sigterm"] and t["checkpoint_after_sigterm"] == 4
    assert t["sentinel_skip_logged"] and t["preempt_save_logged"]
    assert t["resume_logged"] and t["mid_epoch_skip_logged"]
    assert t["resumed_final_step"] == 5
    # every rank died by the SIGTERM, restored its (sharded) state bit for
    # bit and ran to the end on resume
    assert t["run1_returncode"] == [-15] * 4 and t["run2_returncode"] == [0] * 4
    assert t["restore_ok"] and t["restore_mismatched_leaves"] == [0] * 4
    assert verdict["perf_ledger"]["ok"] and verdict["perf_ledger"]["ledger"].startswith(
        str(workdir))
    assert not os.path.exists(os.path.join(workdir, "perf_ledger.jsonl"))


def test_serving_half_over_the_drills_checkpoint(training_smoke):
    workdir, proc = training_smoke
    assert proc.returncode == 0
    result = chaos_drill.serving_half(str(workdir), timeout_s=120.0, device="cpu")
    assert result["ok"], json.dumps(result, indent=1)
    assert result["engine_failure_codes"] == [500, 500]
    assert set(result["flood_codes"]) <= {200, 503, 504} and len(result["flood_codes"]) == 8
    assert result["breaker_trips_total"] >= 1 and result["device"] == "cpu"
    assert "k5_max_abs_err" not in result  # the plain version on the CPU: nothing to hold


def test_ledger_gate_fails_the_drill_on_a_regression(tmp_path, monkeypatch, capsys):
    from mine_tpu_torch.obs import ledger

    path = str(tmp_path / "regressed.jsonl")
    for v in (10.0, 10.0, 5.0):
        ledger.append(path, ledger.make_row("m", v, {"h": 1}, device="d", backend="cuda"))
    monkeypatch.setenv("MINE_TPU_PERF_LEDGER", path)
    monkeypatch.setattr(chaos_drill, "brownout_half", lambda timeout_s, device: {"ok": True})
    rc = chaos_drill.main(["--half", "brownout", "--device", "cpu", "--workdir", str(tmp_path)])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and not verdict["ok"] and verdict["perf_ledger"]["regressions"] == 1
    assert verdict["perf_ledger"]["failures"][0]["metric"] == "m"
    assert "static_analysis" not in verdict
    monkeypatch.setenv("MINE_TPU_PERF_LEDGER", "off")
    assert chaos_drill.main(["--half", "brownout", "--device", "cpu",
                             "--workdir", str(tmp_path)]) == 0
    assert "disabled" in json.loads(capsys.readouterr().out)["perf_ledger"]["note"]
