"""The port's perf ledger (mine_tpu_torch/obs/ledger.py) gives the JAX
module's (mine_tpu/obs/ledger.py) digests, stream keys, baselines and
verdicts on the same rows, and its CLI (python -m
mine_tpu_torch.tools.perf_ledger) prints one verdict line with the JAX CLI's
exit codes. A row the port writes names its card, so it never shares a
stream with a JAX row."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from mine_tpu.obs import ledger as jax_ledger
from mine_tpu_torch.obs import ledger
from mine_tpu_torch.tools import perf_ledger as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKLOADS = [
    {},
    {"h": 384, "w": 512, "planes": 32, "batch": 4},
    {"batch": 4, "planes": 32, "w": 512, "h": 384},  # key order does not matter
    {"nested": {"a": [1, 2.5, None]}, "path": "x/y", "flag": True},
]
NOTES = [None, "", "tpu", "cpu (forced)", "cpu (degraded: no TPU)", "cuda", "gpu extra words",
         "(odd)"]


def _row(metric, value, digest="d1", device="TPU v5e", backend="tpu", hib=True, **extra):
    return {"metric": metric, "value": value, "config_digest": digest, "device": device,
            "backend": backend, "backend_class": jax_ledger.backend_class(backend),
            "higher_is_better": hib, **extra}


def _rows() -> list[dict]:
    """Streams that exercise every branch of check_rows: a value regression
    and a steady one, aux fields in their own directions, min_history skips,
    a newest row without a value, a mesh-shaped stream and a port row."""
    rows = []
    for v in (100.0, 104.0, 98.0, 101.0, 85.0):  # higher is better, regressed
        rows.append(_row("imgs_per_s", v))
    for v in (10.0, 10.5, 9.8, 10.1):  # lower is better, steady value, p95 up
        rows.append(_row("step_ms", v, hib=False, p95_ms=20.0, peak_hbm_bytes=1e9))
    rows.append(_row("step_ms", 10.2, hib=False, p95_ms=26.0, peak_hbm_bytes=0.8e9))
    for rate in (0.8, 0.82, 0.81, 0.6):  # cache economics: higher is better
        rows.append(_row("fleet", 1.0, cache_hit_rate=rate, cache_entries_per_gib=50.0))
    rows.append(_row("young", 1.0))  # one row: skipped
    rows.append(_row("young2", 1.0))
    rows.append(_row("young2", 2.0))  # one prior row < min_history
    for v in (1.0, 1.0, None):  # newest has no value
        rows.append(_row("novalue", v))
    for v in (50.0, 51.0, 20.0):  # the same metric on a mesh: its own stream
        rows.append(_row("imgs_per_s", v, mesh_shape="4x2x1"))
    for v in (7.0, 7.0, 7.0):  # a port row of the same metric and digest
        rows.append(_row("imgs_per_s", v, device="NVIDIA H100 80GB HBM3", backend="cuda",
                         torch_version="2.x"))
    rows.append(_row("zero", 0.0))
    rows.append(_row("zero", 0.0))
    rows.append(_row("zero", 1.0))  # a zero baseline
    return rows


@pytest.mark.parametrize("workload", WORKLOADS)
def test_config_digest_matches_jax(workload):
    assert ledger.config_digest(workload) == jax_ledger.config_digest(workload)


@pytest.mark.parametrize("note", NOTES)
def test_backend_class_matches_jax(note):
    assert ledger.backend_class(note) == jax_ledger.backend_class(note)


def test_stream_keys_and_baselines_match_jax():
    rows = _rows()
    assert [ledger.stream_key(r) for r in rows] == [jax_ledger.stream_key(r) for r in rows]
    bare = [{k: v for k, v in r.items() if k != "backend_class"} for r in rows]
    assert [ledger.stream_key(r) for r in bare] == [jax_ledger.stream_key(r) for r in bare]
    for field in ("value", "p95_ms", "cache_hit_rate", "missing"):
        for window in (1, 2, 5, 100):
            assert ledger.rolling_baseline(rows, field, window) == \
                jax_ledger.rolling_baseline(rows, field, window)


@pytest.mark.parametrize("threshold,window,min_history",
                         [(0.10, 5, 2), (0.05, 2, 1), (0.5, 8, 3), (0.0, 5, 0)])
def test_check_rows_verdicts_match_jax(threshold, window, min_history):
    rows = _rows()
    got = ledger.check_rows(rows, threshold, window, min_history)
    assert got == jax_ledger.check_rows(rows, threshold, window, min_history)
    if (threshold, window, min_history) == (0.10, 5, 2):
        regressed = {(c["metric"], f["field"]) for c in got["checked"] for f in c["fields"]
                     if f["regressed"]}
        assert regressed == {("imgs_per_s", "value"), ("step_ms", "p95_ms"),
                             ("fleet", "cache_hit_rate")}
        # an aux field that improved is not a regression, in its direction
        hbm = [f for c in got["checked"] for f in c["fields"] if f["field"] == "peak_hbm_bytes"]
        assert hbm and not hbm[0]["regressed"]
        assert not got["ok"] and got["regressions"] == 4  # the mesh stream too
        skipped = {s["metric"] for s in got["skipped"]}
        assert {"young", "young2", "novalue"} <= skipped
        # the port's row of the same metric and workload is a stream of its own
        devices = {c["device"] for c in got["checked"] if c["metric"] == "imgs_per_s"}
        assert devices == {"TPU v5e", "NVIDIA H100 80GB HBM3"}


def test_check_reads_a_file_with_malformed_lines_as_jax(tmp_path):
    path = str(tmp_path / "sub" / "ledger.jsonl")
    for row in _rows():
        ledger.append(path, row)
    with open(path, "a") as fh:
        fh.write("{not json\n\n[1, 2]\n" + json.dumps({"no_metric": 1}) + "\n")
    for row in _rows()[:2]:
        jax_ledger.append(path, row)
    got, want = ledger.check(path), jax_ledger.check(path)
    assert got == want and got["malformed_lines"] == 3 and got["rows"] == len(_rows()) + 2
    assert ledger.read(path) == jax_ledger.read(path)
    assert ledger.read(str(tmp_path / "absent.jsonl")) == ([], 0)


def test_rows_carry_torch_version_and_name_the_card(tmp_path, monkeypatch):
    fields = dict(unit="img/s", higher_is_better=False, step_ms=3.0, device="d",
                  backend="cpu (forced)", mesh_shape=None)
    got = ledger.make_row("m", 1.5, {"h": 1}, **fields)
    want = jax_ledger.make_row("m", 1.5, {"h": 1}, **fields)
    assert set(got) == set(want) | {"torch_version"}
    assert {k: got[k] for k in want if k != "ts"} == {k: want[k] for k in want if k != "ts"}
    # the port's own device fields: never a JAX device kind
    dev = ledger.device_fields("cpu")
    assert dev["backend"] == "cpu" and dev["device"] not in ("", "cpu")
    path = str(tmp_path / "l.jsonl")
    row = ledger.append_bench_row({"metric": "m", "value": 2.0}, {"h": 1}, path=path,
                                  device="cpu")
    assert row["device"] == dev["device"] and row["backend_class"] == "cpu"
    jax_row = jax_ledger.make_row("m", 2.0, {"h": 1}, device="cpu", backend="cpu")
    assert ledger.stream_key(row) != jax_ledger.stream_key(jax_row)
    assert ledger.read(path)[0] == [row]
    # explicit fields win over the device's
    row = ledger.append_bench_row({"metric": "m", "value": 2.0, "device": "x"}, {}, path=path,
                                  device="cpu")
    assert row["device"] == "x"
    # disabled: nothing written; unwritable: None and a note, never a raise
    monkeypatch.setenv(ledger.LEDGER_ENV, "off")
    assert ledger.append_bench_row({"metric": "m", "value": 1.0}, {}) is None
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert ledger.append_bench_row({"metric": "m", "value": 1.0}, {},
                                   path=str(blocker / "x.jsonl")) is None


@pytest.mark.parametrize("env", [None, "", "0", "off", "None", " FALSE ", "/x/y.jsonl",
                                 "rel.jsonl"])
def test_ledger_path_matches_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv(ledger.LEDGER_ENV, raising=False)
    else:
        monkeypatch.setenv(ledger.LEDGER_ENV, env)
    assert ledger.ledger_path() == jax_ledger.ledger_path()
    assert ledger.LEDGER_ENV == jax_ledger.LEDGER_ENV
    assert ledger.AUX_METRICS == jax_ledger.AUX_METRICS


def test_default_ledger_is_a_gitignored_file(monkeypatch):
    monkeypatch.delenv(ledger.LEDGER_ENV, raising=False)
    assert ledger.ledger_path() == ledger.DEFAULT_LEDGER == "perf_ledger.jsonl"
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ledger.DEFAULT_LEDGER in [ln.strip() for ln in fh]
    if os.path.isdir(os.path.join(REPO, ".git")):
        out = subprocess.run(["git", "check-ignore", "-q", ledger.DEFAULT_LEDGER], cwd=REPO)
        assert out.returncode == 0


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_perf_ledger_cli", os.path.join(REPO, "tools", "perf_ledger.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("regressed", [False, True])
def test_cli_check_prints_one_verdict_line_as_jax(regressed, tmp_path, capsys):
    path = str(tmp_path / "ledger.jsonl")
    rows = _rows() if regressed else [r for r in _rows() if r["metric"] in ("young", "zero")][:2]
    for row in rows:
        ledger.append(path, row)
    rc = cli.main(["check", "--ledger", path])
    out = capsys.readouterr().out
    want_rc = _jax_cli().main(["check", "--ledger", path])
    want = capsys.readouterr().out
    assert out.count("\n") == 1 and json.loads(out) == json.loads(want)
    assert rc == want_rc == (1 if regressed else 0)
    rc = cli.main(["check", "--ledger", path, "--threshold", "0.9", "--window", "3",
                   "--min-history", "1"])
    assert json.loads(capsys.readouterr().out)["threshold"] == 0.9 and rc == 0


def test_cli_show_and_append(tmp_path, capsys):
    path = str(tmp_path / "ledger.jsonl")
    assert cli.main(["append", "--ledger", path, "--json",
                     json.dumps({"metric": "a", "value": 1.0, "workload": {"h": 1},
                                 **ledger.device_fields("cpu")})]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["config_digest"] == jax_ledger.config_digest({"h": 1})
    assert row["backend_class"] == "cpu" and "torch_version" in row
    ledger.append(path, _row("b", 2.0))
    with open(path, "a") as fh:
        fh.write("garbage\n")
    assert cli.main(["show", "--ledger", path, "--metric", "b"]) == 0
    shown = capsys.readouterr()
    assert [json.loads(ln)["metric"] for ln in shown.out.splitlines()] == ["b"]
    assert "1 malformed" in shown.err


def test_cli_exit_codes_as_a_process(tmp_path):
    """`python -m mine_tpu_torch.tools.perf_ledger`: exit 1 on a regression,
    0 on a clean ledger and when the ledger is disabled; the last stdout line
    is the verdict."""
    bad, good = str(tmp_path / "bad.jsonl"), str(tmp_path / "good.jsonl")
    for row in _rows():
        ledger.append(bad, row)
    ledger.append(good, _row("m", 1.0))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    results = {}
    for name, args, extra in (("bad", ["--ledger", bad], {}),
                              ("good", ["--ledger", good], {}),
                              ("env", [], {ledger.LEDGER_ENV: bad}),
                              ("off", [], {ledger.LEDGER_ENV: "off"})):
        out = subprocess.run([sys.executable, "-m", "mine_tpu_torch.tools.perf_ledger", "check",
                              *args], cwd=tmp_path, env={**env, **extra},
                             capture_output=True, text=True, timeout=120)
        results[name] = (out.returncode, json.loads(out.stdout.strip().splitlines()[-1]))
    assert results["bad"][0] == results["env"][0] == 1
    assert results["env"][1]["ledger"] == bad and results["env"][1]["regressions"] == 4
    assert results["good"] == (0, results["good"][1]) and results["good"][1]["ok"]
    assert results["off"][0] == 0 and "disabled" in results["off"][1]["note"]
    assert not os.path.exists(os.path.join(tmp_path, ledger.DEFAULT_LEDGER))
