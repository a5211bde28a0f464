"""Chaos drill: prove the resilience layer end to end (counterpart of
tools/chaos_drill.py), on the card or, with --device cpu, on the CPU.

Runs short real training jobs and live servers under scripted fault
schedules ($MINE_TPU_FAULTS, resilience/chaos.py) and asserts their end
state, ending in one JSON verdict line (utils/verdict.py) whose keys are the
JAX drill's, half by half:

Training half (4 ranks of one job through tools/multihost_harness.py, the
drill's data=2 x fsdp=2 mesh with ZeRO-1, so that resilience runs against
sharded state; the JAX drill runs this mesh on 4 virtual devices of one
process):
  run 1  `nan_loss@step=2,sigterm@step=4` in every rank's environment, with
         sentinel policy "skip": the poisoned step's update is dropped
         (sentinel warning in train.log); the SIGTERM every rank receives is
         resolved together at the step's end, every rank saves step 4
         (checkpoint + last_good) and dies by SIGTERM.
  run 2  no faults: resumes from step 4 (every rank's restored state, its
         shards gathered, equal to the checkpoint bit for bit), skips the 4
         already-trained batches of the epoch, completes the steps.
  exactness (skippable with --no-exact): an uninterrupted run with the same
         nan fault in a fresh workspace. On the CPU the resumed run's
         parameters equal it bit for bit. On the card they cannot (the
         warp backward's scatter adds in a run-dependent order): there the
         resumed run's largest parameter gap to the uninterrupted run is
         held within EXACT_MULTIPLE times the gap between two uninterrupted
         runs of the same seed. The verdict names the rule it applied.

Serving half (in-process live HTTP server over the training half's
checkpoint): `engine_raise@render=...` faults trip the circuit breaker,
requests shed 503 and /healthz degrades, it half-opens after
breaker_reset_s and a success closes it; a concurrent flood against a
slowed engine with a tiny queue bound and deadlines answers only
200/503/504. On the card the warp-composite kernel (K5) renders the served
entries; its launches are counted and it is held against its plain version
on a captured render's inputs.

Fleet, scale and brownout halves (in-process fake-weight engines,
serving/fake.py: control-plane truth needs no network): replica kill
mid-flood, hot swap mid-flood and a corrupt swap through the router; an
autoscale join mid-flood (cache-aware: nothing re-encoded), a wedged join
that never enters the ring and a drain whose handoff wedges; the brownout
ladder climbing one level at a time under `overload_spike` and relaxing back
to full fidelity, a `corrupt_ckpt` swap rejected by name.

Multihost half (tools/multihost_harness.py, one rank a host):
  kill run  4 hosts, global batch 12 (3 a host, each building only its
            rows), host 0's bring-up retried through `coord_down@init=1`;
            `host_kill@step=3` SIGKILLs host 1. Every survivor ends in the
            named abort (exit 83) inside the watchdog window with its abort
            marker and flight dump, last_good stays 2, each heartbeat counts
            exactly step x 1/4 of the global batch bytes, and the straggler
            table names host 1.
  elastic   the workspace restarts at 3 hosts (4 a host, the same global
            batch) from last_good: its first step against the same step
            resumed at 4 hosts, loss rel <= 2e-4 and per-leaf update gap
            <= 5 % (SGD, fixed disparities); the elastic run completed
            against an uninterrupted 3-host run's final loss (<= 10 %).
  bitwise   2 hosts interrupted by `preempt_exit@step=3`, restarted at the
            same topology: the final parameters against an uninterrupted
            2-host run (bit for bit on the CPU; on the card the rule of the
            training half's exactness).

Datasets half (--half datasets only, as in JAX): the dataset-conformance
matrix (data/conformance/runner.py run_matrix).

`--half all` runs every half but datasets: the training half (and the
serving half over its checkpoint) beside the multihost half, whose launches
share nothing but the machine, then the fake-weight halves.

After the halves, the perf-ledger gate (obs/ledger.py check over
$MINE_TPU_PERF_LEDGER, else ./perf_ledger.jsonl): a drill that survives its
faults but ships a perf regression still fails. The JAX drill's last gate,
the static-analysis suite, has no counterpart in the port yet.

On the card every rank shares it over gloo, with TF32 off (the gates of the
elastic phase were set for fp32 arithmetic).

    python -m mine_tpu_torch.tools.chaos_drill [--half training|serving|fleet|
        scale|brownout|multihost|datasets|all] [--workdir DIR] [--no-exact]
        [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import time

from mine_tpu_torch.tools import multihost_harness as mh
from mine_tpu_torch.utils.verdict import emit

# the training half's configuration (the JAX drill's TINY_OVERRIDES): the
# smallest model the architecture admits, on a data=2 x fsdp=2 mesh with
# ZeRO-1, so that the sentinel, the preemption save and the mid-epoch
# resume run against sharded state
DRILL_RANKS = 4
TINY_OVERRIDES = {
    "data.name": "synthetic",
    "data.img_h": 128, "data.img_w": 128,
    "data.per_gpu_batch_size": 1,
    "data.num_workers": 0,
    "model.num_layers": 18, "model.dtype": "float32",
    "model.imagenet_pretrained": False,
    "mpi.num_bins_coarse": 2,
    "mesh.data_parallel": 2,
    "mesh.fsdp_parallel": 2,
    "parallel.zero1": True,
    "training.epochs": 1,
    "training.log_interval": 1,
    "training.checkpoint_interval": 1000,  # only the preemption save writes
    "resilience.sentinel_policy": "skip",
}
# on the card, a resumed run's largest parameter gap to an uninterrupted one
# may reach this multiple of two uninterrupted runs' own gap: both are draws
# of the same scatter-order noise, so a 1x hold would fail about half the time
EXACT_MULTIPLE = 10.0
# the multihost half's configuration (the JAX drill's MULTIHOST_OVERRIDES).
# SGD: cross-topology parity holds to fp epsilon only under an update linear
# in the gradient; fixed disparities: a 4-host and a 3-host run would draw
# other samples; resume_from=last_good: an elastic restart trusts only the
# vetted pointer
MULTIHOST_OVERRIDES = {
    "data.name": "synthetic",
    "data.img_h": 128, "data.img_w": 128,
    "data.num_workers": 0,
    "model.num_layers": 18, "model.dtype": "float32",
    "model.imagenet_pretrained": False,
    "mpi.num_bins_coarse": 2,
    "mpi.fix_disparity": True,
    "training.epochs": 1,
    "training.log_interval": 1,
    "training.checkpoint_interval": 2,
    "training.optimizer": "sgd",
    "training.resume_from": "last_good",
    "obs.enabled": True,
    "resilience.multihost_watchdog_s": 20.0,
}
MULTIHOST_GLOBAL_BATCH = 12  # divisible by both 4 and 3 hosts
_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _on_card(device: str | None) -> bool:
    return device is None or not device.startswith("cpu")


def _log_text(workspace: str) -> str:
    try:
        with open(os.path.join(workspace, "train.log")) as fh:
            return fh.read()
    except OSError:
        return ""


def _model_of(workspace: str, step: int) -> dict:
    """The checkpoint's model state dict (parameters and BatchNorm
    statistics), on the host."""
    from mine_tpu_torch.training import checkpoint as ckpt

    return ckpt.load(workspace, step)["model"]


def _mismatched(a: dict, b: dict) -> int:
    """Entries of two state dicts that differ in any bit (or are missing)."""
    import torch

    if a.keys() != b.keys():
        return len(a.keys() ^ b.keys())
    return sum(not torch.equal(a[k], b[k]) for k in a)


def _max_gap(a: dict, b: dict) -> float:
    """The largest absolute difference over the parameters (BatchNorm
    statistics left out, as the JAX drill's `params`)."""
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a if not k.endswith(_BN_STATS))


def _note_failures(result: dict, name: str, launch: mh.LaunchResult, expect) -> None:
    """The last lines of every host of `launch` whose return code is not
    `expect` (a code, or a list of one a host), under
    result["failed_host_logs"][name]: the verdict carries its evidence."""
    want = expect if isinstance(expect, list) else [expect] * len(launch.hosts)
    bad = {str(h.process_id): h.log[-2000:] for h, rc in zip(launch.hosts, want)
           if h.returncode != rc}
    if bad:
        result.setdefault("failed_host_logs", {})[name] = bad


def _restored(launch: mh.LaunchResult) -> dict:
    """Every rank's state after the restore of a resumed launch against the
    checkpoint it restored, bit for bit (the harness's
    `host_<i>.restore.json`)."""
    checks = []
    for i in range(len(launch.hosts)):
        try:
            with open(mh.restore_path(launch.workdir, i)) as fh:
                checks.append(json.load(fh))
        except (OSError, ValueError):
            checks.append({})
    return {"restore_mismatched_leaves": [c.get("mismatched_leaves") for c in checks],
            "restore_ok": bool(checks) and all(c.get("mismatched_leaves") == 0
                                               and c.get("leaves", 0) > 0 for c in checks)}


def _exactness(ws: str, ws_ref: str, step: int, device: str | None, ref2=None) -> dict:
    """The resumed workspace's final parameters against an uninterrupted
    one's: bit for bit on the CPU; on the card within EXACT_MULTIPLE x the
    gap of two uninterrupted runs (`ref2`: a callable running the second
    one, returning its workspace)."""
    resumed, reference = _model_of(ws, step), _model_of(ws_ref, step)
    out = {"bitwise_mismatched_leaves": _mismatched(resumed, reference)}
    if not _on_card(device):
        out["exactness_rule"] = "bitwise: the resumed parameters equal the uninterrupted run's"
        out["ok"] = out["bitwise_mismatched_leaves"] == 0
        return out
    ws_ref2 = ref2()
    out["resumed_max_gap"] = _max_gap(resumed, reference)
    out["two_run_max_gap"] = _max_gap(_model_of(ws_ref2, step), reference)
    out["exactness_rule"] = (
        f"card: every rank's restored state equals the checkpoint bit for bit; the resumed "
        f"run's largest parameter gap <= {EXACT_MULTIPLE:g} x that of two uninterrupted runs "
        "(the warp backward's scatter adds in a run-dependent order)")
    out["ok"] = out["resumed_max_gap"] <= EXACT_MULTIPLE * out["two_run_max_gap"]
    return out


def training_half(workdir: str, steps: int, exact: bool, timeout_s: float,
                  device: str | None = None) -> dict:
    from mine_tpu_torch.training import checkpoint as ckpt

    def run(ws: str, faults: str, name: str, expect: int = 0) -> mh.LaunchResult:
        out = mh.launch(ws, DRILL_RANKS, steps, TINY_OVERRIDES,
                        faults={i: faults for i in range(DRILL_RANKS)}, timeout_s=timeout_s,
                        workdir=os.path.join(workdir, name), device=device)
        _note_failures(result, name, out, expect)
        return out

    ws = os.path.join(workdir, "ws")
    result: dict = {"steps_per_epoch": steps, "ranks": DRILL_RANKS, "mesh": "2x2x1",
                    "tf32": False if _on_card(device) else None}
    launches: dict[str, int] = {}

    def count(launch: mh.LaunchResult) -> None:
        for k, n in launch.total_launches().items():
            launches[k] = launches.get(k, 0) + n

    t0 = time.perf_counter()
    # run 1: nan at step 2 (skip policy), SIGTERM after step 4, on every rank
    run1 = run(ws, "nan_loss@step=2,sigterm@step=4", "train_run1", expect=-signal.SIGTERM)
    count(run1)
    result["run1_returncode"] = run1.returncodes
    result["died_by_sigterm"] = all(rc == -signal.SIGTERM for rc in run1.returncodes)
    log1 = _log_text(ws)
    result["sentinel_skip_logged"] = "sentinel: non-finite" in log1
    result["preempt_save_logged"] = "preemption save" in log1
    result["checkpoint_after_sigterm"] = ckpt.latest_step(ws)
    result["last_good"] = ckpt.last_good_step(ws)

    # run 2: resume to the end (no faults)
    run2 = run(ws, "", "train_run2")
    count(run2)
    result["run2_returncode"] = run2.returncodes
    log2 = _log_text(ws)
    result["resume_logged"] = "resumed from step 4" in log2
    result["mid_epoch_skip_logged"] = "mid-epoch resume: skipping 4" in log2
    result["resumed_final_step"] = ckpt.latest_step(ws)
    result.update(_restored(run2))

    ok = (
        result["died_by_sigterm"]
        and result["sentinel_skip_logged"]
        and result["preempt_save_logged"]
        and result["checkpoint_after_sigterm"] == 4
        and result["last_good"] in (4, steps)
        and all(rc == 0 for rc in run2.returncodes)
        and result["resume_logged"]
        and result["mid_epoch_skip_logged"]
        and result["resumed_final_step"] == steps
        and result["restore_ok"]
    )

    if exact and ok:
        # uninterrupted, the same nan fault, a fresh workspace
        ws_ref = os.path.join(workdir, "ws_ref")
        run3 = run(ws_ref, "nan_loss@step=2", "train_ref")
        count(run3)
        result["ref_returncode"] = run3.returncodes

        def second_reference() -> str:
            ws_ref2 = os.path.join(workdir, "ws_ref2")
            run4 = run(ws_ref2, "nan_loss@step=2", "train_ref2")
            count(run4)
            result["ref2_returncode"] = run4.returncodes
            if any(rc != 0 for rc in run4.returncodes):
                raise RuntimeError(f"the second reference run failed: {run4.returncodes}")
            return ws_ref2

        if all(rc == 0 for rc in run3.returncodes):
            ex = _exactness(ws, ws_ref, steps, device, second_reference)
            ok = ok and ex.pop("ok")
            result.update(ex)
        else:
            ok = False
    result["launches"] = launches
    result["seconds"] = round(time.perf_counter() - t0, 1)
    result["ok"] = ok
    return result


def serving_half(workdir: str, timeout_s: float, device: str | None = None) -> dict:
    """A live HTTP server over the training half's checkpoint, scripted
    faults."""
    import io
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from mine_tpu_torch.data.synthetic import _intrinsics, _render_view
    from mine_tpu_torch.inference.video import to_uint8
    from mine_tpu_torch.ops import mpi_render
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.resilience import chaos
    from mine_tpu_torch.serving.server import ServingApp, make_server
    from mine_tpu_torch.training.checkpoint import load_for_serving

    t0 = time.perf_counter()
    ws = os.path.join(workdir, "ws")
    cfg, state, step = load_for_serving(
        ws, allow_random_init=not os.path.isdir(os.path.join(ws, "checkpoints")))
    cfg = cfg.replace(**{"resilience.serve_max_queue_requests": 2,
                         "resilience.serve_deadline_s": 5.0,
                         "resilience.breaker_failure_threshold": 2,
                         "resilience.breaker_reset_s": 1.0,
                         "resilience.breaker_reset_jitter": 0.0})
    app = ServingApp(cfg, state, checkpoint_step=step, max_delay_ms=0.0, device=device)
    server = make_server(app)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    on_card = app.engine.device.type == "cuda"
    result: dict = {"device": str(app.engine.device)}
    # the first composite's inputs, for the kernel's check against its plain version
    captured: list = []
    real_composite = mpi_render.warp_composite

    def capturing(*args, **kwargs):
        if not captured:
            captured.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return real_composite(*args, **kwargs)

    if on_card:
        mpi_render.warp_composite = capturing
    before = dict(kw.launches)
    try:
        def http(path, data=None, headers=None, timeout=timeout_s):
            req = urllib.request.Request(base + path, data=data, headers=headers or {})
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as err:
                return err.code, err.read()

        img, _ = _render_view(128, 128, _intrinsics(128, 128), np.zeros(3), 0.7)
        buf = io.BytesIO()
        Image.fromarray(to_uint8(img)).save(buf, format="PNG")
        code, body = http("/predict", data=buf.getvalue(),
                          headers={"Content-Type": "image/png"})
        result["predict_status"] = code
        key = json.loads(body)["mpi_key"] if code == 200 else None

        def render(timeout_body=None):
            payload: dict = {"mpi_key": key, "offsets": [[0.01, 0.0, 0.0]]}
            if timeout_body is not None:
                payload["timeout_s"] = timeout_body
            return http("/render", data=json.dumps(payload).encode(),
                        headers={"Content-Type": "application/json"})

        # 2 injected engine failures trip the breaker...
        chaos.install("engine_raise@render=1,engine_raise@render=2")
        result["engine_failure_codes"] = [render()[0] for _ in range(2)]  # 500s: real errors
        code, body = http("/healthz")
        result["healthz_degraded"] = code == 503 and json.loads(body)["status"] == "degraded"
        result["shed_while_open"] = render()[0] == 503
        # ...and it half-opens and recovers after breaker_reset_s
        time.sleep(1.2)
        result["recovered_status"] = render()[0]
        code, body = http("/healthz")
        result["healthz_recovered"] = code == 200 and json.loads(body)["status"] == "ok"

        # overload flood: a slowed engine, a tiny queue and deadlines; every
        # answer must be 200/503/504, never a hang or a 500
        chaos.uninstall()
        real_render = app.engine.render

        def slow_render(entry, poses):
            time.sleep(0.4)
            return real_render(entry, poses)

        app.engine.render = slow_render
        codes: list[int] = []
        lock = threading.Lock()

        def one():
            c, _ = render(timeout_body=0.6)
            with lock:
                codes.append(c)

        threads = [threading.Thread(target=one) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout_s)
        app.engine.render = real_render
        result["flood_codes"] = sorted(codes)
        result["flood_all_answered"] = len(codes) == 8
        result["flood_no_500"] = all(c in (200, 503, 504) for c in codes)
        result["flood_shed_or_expired"] = any(c in (503, 504) for c in codes)

        text = app.metrics.render()

        def metric(name):
            for line in text.splitlines():
                if line.startswith(name + "{") or line.startswith(name + " "):
                    return float(line.rsplit(" ", 1)[1])
            return 0.0

        result["shed_total"] = metric("mine_serve_shed_requests_total")
        result["timeouts_total"] = metric("mine_serve_request_timeouts_total")
        result["breaker_trips_total"] = metric("mine_serve_breaker_trips_total")
        if on_card:
            torch.cuda.synchronize()
        result["launches"] = {k: v - before[k] for k, v in kw.launches.items()}
        k5_ok = True
        if on_card:
            # K5 on a served entry's render, against its plain version (this
            # check's launch is not counted above)
            if not captured:
                raise AssertionError("the served renders never reached warp_composite")
            ops = captured[0]
            got = kw.warp_composite(*ops)
            want = kw.warp_composite_matrix_plain(*ops)
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            result["k5_max_abs_err"] = max(errs)
            result["k5_tolerance"] = {"rtol": 1e-5, "atol": 1e-5}
            k5_ok = all(torch.allclose(g, w, rtol=1e-5, atol=1e-5) for g, w in zip(got, want))
            k5_ok = k5_ok and result["launches"]["warp_composite"] > 0
        result["ok"] = (
            result["predict_status"] == 200
            and result["healthz_degraded"]
            and result["shed_while_open"]
            and result["recovered_status"] == 200
            and result["healthz_recovered"]
            and result["flood_all_answered"]
            and result["flood_no_500"]
            and result["flood_shed_or_expired"]
            and result["breaker_trips_total"] >= 1
            and k5_ok
        )
    finally:
        mpi_render.warp_composite = real_composite
        chaos.uninstall()
        server.shutdown()
        server.server_close()
        app.close()
    result["seconds"] = round(time.perf_counter() - t0, 1)
    return result


def _png(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _http_client(base: str, with_headers: bool = False):
    import urllib.error
    import urllib.request

    def http(path, data=None, headers=None, timeout=30.0):
        req = urllib.request.Request(base + path, data=data, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out = (resp.status, resp.read(), dict(resp.headers))
        except urllib.error.HTTPError as err:
            out = (err.code, err.read(), dict(err.headers or {}))
        return out if with_headers else out[:2]

    return http


def _flooder(one_request, timeout_s: float):
    import threading

    def flood(n_threads: int, per_thread: int, mid_flood=None) -> list[int]:
        codes: list[int] = []
        lock = threading.Lock()

        def client():
            for i in range(per_thread):
                c = one_request(i)
                with lock:
                    codes.append(c)

        threads = [threading.Thread(target=client) for _ in range(n_threads)]
        for t in threads:
            t.start()
        if mid_flood is not None:
            time.sleep(0.15)  # let the flood establish
            mid_flood()
        for t in threads:
            t.join(timeout=timeout_s)
        return codes

    return flood


def _one_request(http, pngs: list[bytes], keys: list[str]):
    def one_request(i: int) -> int:
        """One logical client request honouring the documented 404 contract
        (the MPI is not cached on the answering replica after a membership
        change: re-predict, then render again)."""
        png, key = pngs[i % len(pngs)], keys[i % len(keys)]
        payload = json.dumps({"mpi_key": key, "offsets": [[0.01, 0.0, 0.0]]}).encode()
        hdr = {"Content-Type": "application/json"}
        code, _ = http("/render", data=payload, headers=hdr)
        if code == 404:
            pc, _ = http("/predict", data=png, headers={"Content-Type": "image/png"})
            if pc != 200:
                return pc
            code, _ = http("/render", data=payload, headers=hdr)
        return code

    return one_request


def fleet_half(timeout_s: float, device: str | None = None) -> dict:
    """Replica kill, hot swap and corrupt swap against a live fake-weight
    fleet of 3 replicas behind the router."""
    import threading

    import numpy as np

    from mine_tpu_torch.obs.slo import SLOTracker, default_objectives
    from mine_tpu_torch.resilience import chaos
    from mine_tpu_torch.serving.fake import fake_checkpoint, make_fake_app
    from mine_tpu_torch.serving.fleet import FleetApp, make_fleet_server
    from mine_tpu_torch.serving.server import make_server

    t0 = time.perf_counter()
    result: dict = {}
    apps, servers, urls = [], [], {}
    fleet = fleet_srv = None
    try:
        for i in range(3):
            app = make_fake_app(checkpoint_step=1, swap_source=lambda: fake_checkpoint(2),
                                device=device)
            srv = make_server(app)
            host, port = srv.server_address[:2]
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            apps.append(app)
            servers.append(srv)
            urls[f"r{i}"] = f"http://{host}:{port}"
        fleet = FleetApp(urls, probe_interval_s=0.25, probe_timeout_s=2.0, up_after=2,
                         down_after=2, max_attempts=3, deadline_s=15.0).start()
        fleet_srv = make_fleet_server(fleet)
        fh, fp = fleet_srv.server_address[:2]
        threading.Thread(target=fleet_srv.serve_forever, daemon=True).start()
        http = _http_client(f"http://{fh}:{fp}")

        pngs = []
        for i in range(6):
            img = np.full((8, 8, 3), (i * 41) % 256, np.uint8)
            img[0, 0] = (i, 0, 0)
            pngs.append(_png(img))
        keys = []
        for png in pngs:
            code, body = http("/predict", data=png, headers={"Content-Type": "image/png"})
            assert code == 200, body
            keys.append(json.loads(body)["mpi_key"])
        one_request = _one_request(http, pngs, keys)
        flood = _flooder(one_request, timeout_s)

        def phase_slo() -> SLOTracker:
            """A fresh tracker a phase: its baseline at construction makes
            the verdict cover that phase's traffic alone. Shedding 503s are
            the admission contract and exempt; any unplanned 5xx burns."""
            return SLOTracker(fleet.metrics.registry,
                              default_objectives(family_prefix="mine_fleet", p95_s=5.0))

        # ---- phase A: replica kill mid-flood --------------------------------
        slo_a = phase_slo()
        schedule = chaos.install("replica_kill@request=60")
        codes_a = flood(4, 50)
        result["kill_fired"] = schedule.pending() == []
        chaos.uninstall()
        result["slo_kill"] = slo_a.verdict()
        result["kill_flood_requests"] = len(codes_a)
        result["kill_flood_codes"] = sorted(set(codes_a))
        result["kill_flood_only_200_503"] = all(c in (200, 503) for c in codes_a)
        result["kill_flood_error_burst"] = sum(1 for c in codes_a if c != 200)
        deadline = time.monotonic() + 20.0
        while len(fleet.ring_members()) != 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        result["ring_converged_to"] = len(fleet.ring_members())
        result["post_kill_all_200"] = all(one_request(i) == 200 for i in range(12))

        # ---- phase B: hot swap mid-flood ------------------------------------
        slo_b = phase_slo()
        swap_results: dict = {}

        def trigger_swap():
            code, body = http("/admin/swap", data=json.dumps({"wait": True}).encode(),
                              headers={"Content-Type": "application/json"}, timeout=60.0)
            swap_results["status"] = code
            swap_results.update(json.loads(body))

        codes_b = flood(4, 50, mid_flood=trigger_swap)
        result["slo_swap"] = slo_b.verdict()
        result["swap_http_status"] = swap_results.get("status")
        replicas_swapped = swap_results.get("replicas", {})
        in_ring = [r for r in replicas_swapped.values() if r.get("in_ring")]
        dead = [r for r in replicas_swapped.values() if not r.get("in_ring")]
        # the fan-out reaches all 3 configured replicas: both survivors flip,
        # the killed one is reported unreachable
        result["swap_replicas_ok"] = (
            len(replicas_swapped) == 3 and len(in_ring) == 2
            and all(r.get("state") == "ok" for r in in_ring)
            and all("error" in r for r in dead)
        )
        result["swap_flood_requests"] = len(codes_b)
        result["swap_flood_codes"] = sorted(set(codes_b))
        result["swap_zero_5xx"] = all(c < 500 for c in codes_b)
        old_ok, _ = http("/render", data=json.dumps({
            "mpi_key": keys[0], "offsets": [[0.01, 0.0, 0.0]]}).encode(),
            headers={"Content-Type": "application/json"})
        result["old_generation_key_still_served"] = old_ok == 200
        code, body = http("/predict", data=pngs[0], headers={"Content-Type": "image/png"})
        new_key = json.loads(body)["mpi_key"] if code == 200 else ""
        result["post_swap_key_rotated"] = (code == 200 and new_key.split(":")[1] == "2"
                                           and new_key != keys[0])
        live_apps = [a for a in apps if a.engine.checkpoint_step == 2]
        result["swapped_generations"] = sorted(a.engine.generation for a in live_apps)

        # ---- phase C: corrupt-checkpoint swap rejected ----------------------
        victim = live_apps[0]
        gen_before = victim.engine.generation
        step_before = victim.engine.checkpoint_step
        chaos.install("corrupt_swap@swap=1")
        status = victim.swap(wait=True)
        chaos.uninstall()
        result["corrupt_swap_state"] = status.get("state")
        result["corrupt_swap_error_named"] = "ChaosFault" in str(status.get("error", ""))
        result["corrupt_swap_counter"] = victim.metrics.swap_failures.value(reason="load")
        result["corrupt_swap_rolled_back"] = (victim.engine.generation == gen_before
                                              and victim.engine.checkpoint_step == step_before)
        result["post_corrupt_all_200"] = all(one_request(i) == 200 for i in range(8))

        result["ok"] = (
            result["kill_fired"]
            and result["kill_flood_only_200_503"]
            and result["ring_converged_to"] == 2
            and result["post_kill_all_200"]
            and result["slo_kill"]["ok"]
            and result["slo_swap"]["ok"]
            and result["swap_http_status"] == 200
            and result["swap_replicas_ok"]
            and result["swap_zero_5xx"]
            and result["old_generation_key_still_served"]
            and result["post_swap_key_rotated"]
            and result["corrupt_swap_state"] == "failed"
            and result["corrupt_swap_error_named"]
            and result["corrupt_swap_counter"] >= 1
            and result["corrupt_swap_rolled_back"]
            and result["post_corrupt_all_200"]
        )
    finally:
        chaos.uninstall()
        for srv in servers:
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:
                pass
        if fleet_srv is not None:
            fleet_srv.shutdown()
            fleet_srv.server_close()
        if fleet is not None:
            fleet.close()
        for app in apps:
            app.close()
    result["seconds"] = round(time.perf_counter() - t0, 1)
    return result


def brownout_half(timeout_s: float, device: str | None = None) -> dict:
    """The degradation ladder and the checkpoint-integrity check against one
    live fake-weight replica: `overload_spike@request=1` climbs the ladder to
    its top one level at a time, every degraded answer announced (level and
    tier) and counted, then it relaxes one level per dwell to full fidelity;
    `corrupt_ckpt@swap=1` is rejected with reason "corrupt"
    (CheckpointCorrupt named), the old generation keeps serving and the next
    swap flips."""
    import threading

    import numpy as np

    from mine_tpu_torch.config import Config
    from mine_tpu_torch.resilience import chaos
    from mine_tpu_torch.serving.compress import DEFAULT_PRUNE_EPS
    from mine_tpu_torch.serving.fake import fake_checkpoint, make_fake_app
    from mine_tpu_torch.serving.server import make_server

    t0 = time.perf_counter()
    result: dict = {}
    app = srv = None
    try:
        cfg = Config().replace(**{
            "data.img_h": 128, "data.img_w": 128,
            "mpi.num_bins_coarse": 2,
            "serving.degrade_enabled": True,
            # one breach a level; a dwell long enough that the climb never
            # races a relax, short enough for the whole descent
            "serving.degrade_engage_after": 1,
            "serving.degrade_relax_after": 2,
            "serving.degrade_dwell_s": 1.0,
        })
        app = make_fake_app(checkpoint_step=1, swap_source=lambda: fake_checkpoint(2),
                            cfg=cfg, device=device)
        # the replica warms up as the serving CLI does at its start, and its
        # L1 tier too (a bench pre-seeds both): a bucket's first predict runs
        # under the FLOP counter (obs/cost.py) and the first int8 predict
        # compiles its compression kernels, slow on a loaded host, and no
        # user's request should carry either into the latency objective the
        # ladder reads
        app.engine.warmup()
        app.engine.set_degraded_compression("int8", DEFAULT_PRUNE_EPS)
        app.engine.predict(np.zeros((8, 8, 3), np.uint8))
        app.engine.clear_degraded_compression()
        srv = make_server(app)
        host, port = srv.server_address[:2]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        client = _http_client(f"http://{host}:{port}", with_headers=True)
        seconds: list[tuple[str, float]] = []

        def http(path, **kw):
            t = time.perf_counter()
            out = client(path, **kw)
            if path != "/metrics":
                seconds.append((path, round(time.perf_counter() - t, 3)))
            return out

        def png(i: int) -> bytes:
            img = np.full((8, 8, 3), (i * 53) % 256, np.uint8)
            img[0, 0] = (i, 1, 0)
            return _png(img)

        def degraded_header(headers: dict) -> tuple[int, str | None]:
            for k, v in headers.items():
                if k.lower() == "x-degraded":
                    lvl = int(str(v).split(";", 1)[0].split("=", 1)[1])
                    tier = str(v).split("tier=", 1)[1] if "tier=" in v else None
                    return lvl, tier
            return 0, None

        def metric(name: str) -> float:
            _, body, _ = http("/metrics")
            total, seen = 0.0, False
            for line in body.decode().splitlines():
                if line.startswith(name) and line[len(name)] in " {":
                    total += float(line.rsplit(" ", 1)[1])
                    seen = True
            return total if seen else 0.0

        # ---- phase A: the spike climbs the ladder, announced ---------------
        code, _, hdr = http("/predict", data=png(0), headers={"Content-Type": "image/png"})
        assert code == 200
        result["pre_spike_full_fidelity"] = degraded_header(hdr)[0] == 0
        schedule = chaos.install("overload_spike@request=1")
        climb: list[tuple[int, str | None]] = []
        for i in range(4):
            code, _, hdr = http("/predict", data=png(i + 1),
                                headers={"Content-Type": "image/png"})
            assert code == 200
            climb.append(degraded_header(hdr))
        chaos.uninstall()
        result["spike_fired"] = schedule.pending() == []
        levels = [lvl for lvl, _ in climb]
        result["climb_levels"] = levels
        result["climb_reaches_max"] = max(levels) == app.degrade.max_level
        result["climb_one_level_at_a_time"] = levels == sorted(levels) and \
            all(b - a <= 1 for a, b in zip([0] + levels, levels))
        result["degraded_answers_announced"] = all(lvl == 0 or tier is not None
                                                   for lvl, tier in climb)
        result["compressed_tier_announced"] = all(tier == "int8" for lvl, tier in climb
                                                  if lvl >= 1)
        result["degraded_responses_counted"] = metric(
            "mine_serve_degradation_responses_total") >= sum(1 for lvl, _ in climb if lvl > 0)
        result["gauge_at_max"] = metric("mine_serve_degradation_level") == app.degrade.max_level

        # ---- phase B: full recovery, one level per dwell --------------------
        deadline = time.monotonic() + min(timeout_s, 20.0)
        gauge = None
        while time.monotonic() < deadline:
            # every scrape ticks a real (calm) pressure sample: polling is the
            # relax cadence of an idle replica
            gauge = metric("mine_serve_degradation_level")
            if gauge == 0:
                break
            time.sleep(0.05)
        result["recovered_to_zero"] = gauge == 0
        # the log leads with its level-0 baseline entry; every step after it
        # moves exactly one level
        transitions = [lvl for _, lvl in app.degrade.transitions()]
        result["transitions"] = transitions
        result["never_skips_a_level"] = all(abs(b - a) == 1
                                            for a, b in zip(transitions, transitions[1:]))
        code, _, hdr = http("/predict", data=png(9), headers={"Content-Type": "image/png"})
        result["post_recovery_full_fidelity"] = (
            code == 200 and degraded_header(hdr)[0] == 0
            and app.engine.effective_tier() == cfg.serving.cache_tier)

        # ---- phase C: corrupt-checkpoint swap rejected ----------------------
        gen_before = app.engine.generation
        schedule = chaos.install("corrupt_ckpt@swap=1")
        status = app.swap(wait=True)
        chaos.uninstall()
        result["corrupt_fired"] = schedule.pending() == []
        result["corrupt_swap_state"] = status.get("state")
        result["corrupt_swap_reason"] = status.get("reason")
        result["corrupt_swap_error_named"] = "CheckpointCorrupt" in str(status.get("error", ""))
        result["corrupt_swap_counter"] = app.metrics.swap_failures.value(reason="corrupt")
        result["old_generation_still_serving"] = app.engine.generation == gen_before
        code, body, _ = http("/predict", data=png(11), headers={"Content-Type": "image/png"})
        result["post_corrupt_predict_old_step"] = (
            code == 200 and json.loads(body)["mpi_key"].split(":")[1] == "1")
        result["next_swap_ok"] = app.swap(wait=True).get("state") == "ok"

        result["ok"] = (
            result["pre_spike_full_fidelity"]
            and result["spike_fired"]
            and result["climb_reaches_max"]
            and result["climb_one_level_at_a_time"]
            and result["degraded_answers_announced"]
            and result["compressed_tier_announced"]
            and result["degraded_responses_counted"]
            and result["gauge_at_max"]
            and result["recovered_to_zero"]
            and result["never_skips_a_level"]
            and result["post_recovery_full_fidelity"]
            and result["corrupt_fired"]
            and result["corrupt_swap_state"] == "failed"
            and result["corrupt_swap_reason"] == "corrupt"
            and result["corrupt_swap_error_named"]
            and result["corrupt_swap_counter"] >= 1
            and result["old_generation_still_serving"]
            and result["post_corrupt_predict_old_step"]
            and result["next_swap_ok"]
        )
        if not result["ok"]:  # what held the ladder up
            result["slo_at_end"] = app.slo.evaluate()
            result["request_seconds"] = seconds
    finally:
        chaos.uninstall()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if app is not None:
            app.close()
    result["seconds"] = round(time.perf_counter() - t0, 1)
    return result


def scale_half(timeout_s: float, device: str | None = None) -> dict:
    """The autoscale controller's join and drain (serving/autoscale.py)
    under flood, with the scale chaos seams fired:

    phase A  a clean join 2 -> 3 mid-flood: the joiner pre-warms its arc
             before the router admits it, so fleet-wide encoder invocations
             stay == images, and nothing 5xxs.
    phase B  `join_stall@scale=1`: the wedged joiner never enters the ring
             (membership stays 3, the spawned replica retired, the abort
             counted), no 5xx.
    phase C  `drain_timeout@scale=1`: the drain completes without its
             handoff (the victim leaves the ring and is retired, membership
             2, no 5xx); the cost is cache warmth, measured as an
             encoder-invocation delta, and the abandoned handoff is counted.
    """
    import threading
    import urllib.request

    import numpy as np

    from mine_tpu_torch.obs.slo import SLOTracker, default_objectives
    from mine_tpu_torch.resilience import chaos
    from mine_tpu_torch.serving.autoscale import AutoscaleController, InProcessPool
    from mine_tpu_torch.serving.fake import make_fake_app
    from mine_tpu_torch.serving.fleet import FleetApp, make_fleet_server

    t0 = time.perf_counter()
    result: dict = {}
    pool = InProcessPool(app_factory=lambda: make_fake_app(checkpoint_step=1, device=device))
    fleet = fleet_srv = None
    images = 6
    try:
        for _ in range(2):
            pool.spawn()
        urls = pool.urls()
        pool.configure_peers(urls)
        fleet = FleetApp(urls, probe_interval_s=0.25, probe_timeout_s=2.0, up_after=2,
                         down_after=2, max_attempts=3, deadline_s=15.0).start()
        fleet_srv = make_fleet_server(fleet)
        fh, fp = fleet_srv.server_address[:2]
        threading.Thread(target=fleet_srv.serve_forever, daemon=True).start()
        base = f"http://{fh}:{fp}"
        controller = AutoscaleController(
            fleet, pool, scrape=f"{base}/metrics", min_replicas=2, max_replicas=4,
            up_after=10**6, down_after=10**6, cooldown_s=0.0,
            join_timeout_s=timeout_s, drain_timeout_s=timeout_s,
        )
        http = _http_client(base)

        pngs = []
        for i in range(images):
            img = np.full((8, 8, 3), (i * 43) % 256, np.uint8)
            img[0, 0] = (i, 1, 0)
            pngs.append(_png(img))
        keys = []
        for png in pngs:
            code, body = http("/predict", data=png, headers={"Content-Type": "image/png"})
            assert code == 200, body
            keys.append(json.loads(body)["mpi_key"])
        one_request = _one_request(http, pngs, keys)
        flood = _flooder(one_request, timeout_s)

        def phase_slo() -> SLOTracker:
            return SLOTracker(fleet.metrics.registry,
                              default_objectives(family_prefix="mine_fleet", p95_s=5.0))

        def encoder_total() -> float:
            total = 0.0
            for url in pool.urls().values():
                with urllib.request.urlopen(url + "/metrics", timeout=10.0) as resp:
                    text = resp.read().decode()
                for line in text.splitlines():
                    if line.startswith("mine_serve_encoder_invocations_total "):
                        total += float(line.rsplit(" ", 1)[1])
            return total

        events = fleet.metrics.autoscale_events

        # ---- phase A: clean join 2 -> 3 mid-flood ---------------------------
        slo_a = phase_slo()
        scaled: list[int] = []
        codes_a = flood(4, 30, mid_flood=lambda: scaled.append(controller.scale_to(3)))
        result["slo_join"] = slo_a.verdict()
        result["join_scaled_to"] = scaled[0] if scaled else 0
        result["join_ring_size"] = len(fleet.ring_members())
        result["join_flood_codes"] = sorted(set(codes_a))
        result["join_zero_5xx"] = all(c < 500 for c in codes_a)
        enc_after_join = encoder_total()
        # cache-aware: the joiner's arc was pre-warmed over the wire before
        # admission, nothing re-encoded
        result["join_encoder_invocations"] = enc_after_join
        result["join_conservation_ok"] = enc_after_join == float(images)
        result["join_events_ok"] = events.value(direction="join", outcome="ok")

        # ---- phase B: join_stall, the wedged join never enters the ring -----
        slo_b = phase_slo()
        schedule = chaos.install("join_stall@scale=1")
        scaled_b: list[int] = []
        codes_b = flood(4, 30, mid_flood=lambda: scaled_b.append(controller.scale_to(4)))
        result["stall_fired"] = schedule.pending() == []
        chaos.uninstall()
        result["slo_stall"] = slo_b.verdict()
        result["stall_ring_size"] = len(fleet.ring_members())
        result["stall_scaled_to"] = scaled_b[0] if scaled_b else 0
        result["stall_pool_size"] = len(pool.names())
        result["stall_flood_codes"] = sorted(set(codes_b))
        result["stall_zero_5xx"] = all(c < 500 for c in codes_b)
        result["stall_events_aborted"] = events.value(direction="join", outcome="aborted")

        # ---- phase C: drain_timeout, the drain completes without a handoff --
        slo_c = phase_slo()
        enc_before_drain = encoder_total()
        schedule = chaos.install("drain_timeout@scale=1")
        scaled_c: list[int] = []
        codes_c = flood(4, 30, mid_flood=lambda: scaled_c.append(controller.scale_to(2)))
        result["drain_fired"] = schedule.pending() == []
        chaos.uninstall()
        result["slo_drain"] = slo_c.verdict()
        result["drain_ring_size"] = len(fleet.ring_members())
        result["drain_scaled_to"] = scaled_c[0] if scaled_c else 0
        result["drain_pool_size"] = len(pool.names())
        result["drain_flood_codes"] = sorted(set(codes_c))
        result["drain_zero_5xx"] = all(c < 500 for c in codes_c)
        result["drain_events_handoff_aborted"] = events.value(direction="drain",
                                                              outcome="handoff_aborted")
        # the abandoned handoff's price is cache warmth: measured, not gated
        result["drain_reencode_delta"] = encoder_total() - enc_before_drain
        result["post_drain_all_200"] = all(one_request(i) == 200 for i in range(2 * images))

        result["ok"] = (
            result["join_scaled_to"] == 3
            and result["join_ring_size"] == 3
            and result["join_zero_5xx"]
            and result["join_conservation_ok"]
            and result["join_events_ok"] >= 1
            and result["slo_join"]["ok"]
            and result["stall_fired"]
            and result["stall_ring_size"] == 3
            and result["stall_scaled_to"] == 3
            and result["stall_pool_size"] == 3
            and result["stall_zero_5xx"]
            and result["stall_events_aborted"] >= 1
            and result["slo_stall"]["ok"]
            and result["drain_fired"]
            and result["drain_ring_size"] == 2
            and result["drain_scaled_to"] == 2
            and result["drain_pool_size"] == 2
            and result["drain_zero_5xx"]
            and result["drain_events_handoff_aborted"] >= 1
            and result["slo_drain"]["ok"]
            and result["post_drain_all_200"]
        )
    finally:
        chaos.uninstall()
        if fleet_srv is not None:
            fleet_srv.shutdown()
            fleet_srv.server_close()
        if fleet is not None:
            fleet.close()
        pool.close()
    result["seconds"] = round(time.perf_counter() - t0, 1)
    return result


def global_batch_bytes() -> int:
    """Host bytes of one global batch as the port's synthetic loader lays it
    out (the 1/N denominator of the per-host data check)."""
    from mine_tpu_torch.data.synthetic import make_synthetic_batch

    batch = make_synthetic_batch(MULTIHOST_GLOBAL_BATCH, MULTIHOST_OVERRIDES["data.img_h"],
                                 MULTIHOST_OVERRIDES["data.img_w"], n_points=32, seed=0)
    batch.pop("src_depth")
    return sum(v.nbytes for v in batch.values())


def _logged_loss(workspace: str, step: int) -> float | None:
    """The loss logged at `step`, last occurrence (a resumed workspace's
    train_log.jsonl carries every run appended)."""
    loss = None
    try:
        with open(os.path.join(workspace, "train_log.jsonl")) as fh:
            for line in fh:
                row = json.loads(line)
                if row.get("global_step") == step:
                    loss = float(row["loss"])
    except (OSError, ValueError):
        return None
    return loss



def _param_parity(ws_a: str, ws_b: str, final_step: int, base_step: int) -> dict:
    """Per-leaf final-parameter gaps measured against each run's own update
    (final - base checkpoint); leaves whose update norms stay under 1e-3 are
    left out (the JAX drill's rule). Parameters only, as the JAX drill's
    `params`: BatchNorm statistics are left out."""
    pa, pb = _model_of(ws_a, final_step), _model_of(ws_b, final_step)
    ba, bb = _model_of(ws_a, base_step), _model_of(ws_b, base_step)
    worst, compared = 0.0, 0
    for k in pa:
        if k.endswith(_BN_STATS):
            continue
        a, b = pa[k].double(), pb[k].double()
        ua = float((a - ba[k].double()).norm())
        ub = float((b - bb[k].double()).norm())
        if max(ua, ub) < 1e-3:
            continue
        compared += 1
        worst = max(worst, float((a - b).norm()) / max(ua, ub))
    return {"worst_update_rel": worst, "leaves_compared": compared}


def _clear_heartbeats(workspace: str) -> None:
    # relaunching a just-crashed workspace: the kill run's abort markers and
    # dead hosts' beats may be younger than the start() sweep's age cutoff
    # (resilience/multihost.py _CLEANUP_MIN_AGE_S), and copytree keeps
    # mtimes; a fresh run must never judge the previous run's evidence
    shutil.rmtree(os.path.join(workspace, "heartbeats"), ignore_errors=True)


def multihost_half(workdir: str, timeout_s: float, device: str | None = None) -> dict:
    """Kill, elastic resume and exact resume against real multi-process
    training (the module docstring)."""
    from mine_tpu_torch.resilience.multihost import EXIT_HOST_STALL
    from mine_tpu_torch.training import checkpoint as ckpt

    t0 = time.perf_counter()
    result: dict = {}
    launches: dict[str, int] = {}

    def run(ws: str, n_hosts: int, steps: int, name: str,
            faults: dict[int, str] | None = None, expect=0) -> mh.LaunchResult:
        out = mh.launch(ws, n_hosts=n_hosts, steps=steps,
                        overrides=dict(MULTIHOST_OVERRIDES, **{
                            "data.per_gpu_batch_size": MULTIHOST_GLOBAL_BATCH // n_hosts}),
                        faults=faults, timeout_s=timeout_s,
                        workdir=os.path.join(workdir, name), device=device)
        _note_failures(result, name, out, expect)
        for k, n in out.total_launches().items():
            launches[k] = launches.get(k, 0) + n
        return out

    # ---- phase A: kill host 1 of 4 mid-run ------------------------------
    ws = os.path.join(workdir, "mh_ws")
    kill = run(ws, 4, 6, "mh_kill", faults={1: "host_kill@step=3", 0: "coord_down@init=1"},
               expect=[EXIT_HOST_STALL, -signal.SIGKILL, EXIT_HOST_STALL, EXIT_HOST_STALL])
    result["kill_returncodes"] = kill.returncodes
    result["kill_wall_s"] = round(kill.wall_s, 1)
    result["victim_sigkilled"] = kill.hosts[1].died_by_signal == signal.SIGKILL
    survivors = [kill.hosts[i] for i in (0, 2, 3)]
    result["survivors_named_abort"] = all(h.returncode == EXIT_HOST_STALL for h in survivors)
    result["no_survivor_hung"] = not any(h.timed_out for h in survivors)
    result["bringup_retry_logged"] = "bring-up attempt 1" in kill.hosts[0].log
    markers = kill.abort_markers()
    result["abort_markers"] = sorted(markers)
    result["abort_reasons"] = {str(i): m.get("reason") for i, m in sorted(markers.items())}
    dumps = kill.flight_dump_dirs()
    result["survivor_flight_dumps"] = {str(i): len(dumps.get(i, [])) for i in (0, 2, 3)}
    result["last_good_after_kill"] = ckpt.last_good_step(ws)
    # per-host data: every heartbeat counts exactly step x 1/4 of the global
    # batch's bytes
    per_host_step_bytes = global_batch_bytes() // 4
    beats = kill.heartbeats()
    result["host_bytes_quarter"] = bool(beats) and all(
        b.get("data_bytes") == per_host_step_bytes * (b.get("step") or 0)
        for b in beats.values())
    # the victim's beat froze at its last step while the survivors went on:
    # the table names it before the watchdog's verdict. Read now, before
    # the elastic phase clears the heartbeats
    stragglers = kill.straggler_table()
    result["straggler_table"] = stragglers["rows"]
    result["straggler_suspect"] = stragglers["suspect"]
    result["straggler_skew_fraction"] = stragglers["skew_fraction"]
    result["sync_wait_in_beats"] = all(r.get("sync_wait_ms") is not None
                                       for r in stragglers["rows"])
    # how long after the victim's last beat each survivor's abort came
    victim_ts = (beats.get(1) or {}).get("ts")
    result["abort_after_victim_beat_s"] = {
        str(i): round(os.path.getmtime(os.path.join(ws, "heartbeats",
                                                    f"multihost_abort_p{i}.json")) - victim_ts, 2)
        for i in sorted(markers)} if victim_ts else None
    ok_kill = (
        result["victim_sigkilled"]
        and result["survivors_named_abort"]
        and result["no_survivor_hung"]
        and result["bringup_retry_logged"]
        and set(markers) == {0, 2, 3}
        and all(v >= 1 for v in result["survivor_flight_dumps"].values())
        and result["last_good_after_kill"] == 2
        and result["host_bytes_quarter"]
        and result["straggler_suspect"] == 1  # the killed host, by name
        and result["straggler_skew_fraction"] > 0
        and result["sync_wait_in_beats"]
    )
    result["kill_ok"] = ok_kill

    # ---- phase B: elastic restart at N-1 hosts --------------------------
    # the gate is the from-same-checkpoint control: the 4-host run's
    # last_good restored at 3 hosts and at 4, the same step on the same
    # global batch, the updates compared; the completed runs' trajectories
    # are a sanity bound only (fp noise grows through the loss surface's
    # discontinuities)
    ws_cont4 = os.path.join(workdir, "mh_ws_cont4")
    shutil.copytree(ws, ws_cont4)
    _clear_heartbeats(ws)
    _clear_heartbeats(ws_cont4)
    elastic_step = run(ws, 3, 3, "mh_elastic1")
    cont4_step = run(ws_cont4, 4, 3, "mh_cont4")
    result["elastic_step_returncodes"] = elastic_step.returncodes
    result["cont4_step_returncodes"] = cont4_step.returncodes
    result["elastic_resumed_logged"] = "resumed from step 2" in elastic_step.hosts[0].log
    ok_primitive = (all(rc == 0 for rc in elastic_step.returncodes)
                    and all(rc == 0 for rc in cont4_step.returncodes)
                    and result["elastic_resumed_logged"])
    if ok_primitive:
        loss_e, loss_c = _logged_loss(ws, 3), _logged_loss(ws_cont4, 3)
        result["elastic_step_loss_3h"] = loss_e
        result["elastic_step_loss_4h"] = loss_c
        result["elastic_step_loss_rel"] = (abs(loss_e - loss_c) / max(abs(loss_c), 1e-12)
                                           if loss_e is not None and loss_c is not None
                                           else None)
        result.update({f"elastic_step_{k}": v
                       for k, v in _param_parity(ws, ws_cont4, 3, 2).items()})
        ok_primitive = (result["elastic_step_loss_rel"] is not None
                        and result["elastic_step_loss_rel"] <= 2e-4
                        and result["elastic_step_worst_update_rel"] <= 0.05
                        and result["elastic_step_leaves_compared"] > 0)
    # the mechanism end to end: the 3-host workspace completes the run, its
    # final loss beside an uninterrupted 3-host run's
    elastic_full = run(ws, 3, 6, "mh_elastic2")
    ws_ref = os.path.join(workdir, "mh_ws_ref3")
    ref3 = run(ws_ref, 3, 6, "mh_ref3")
    result["elastic_full_returncodes"] = elastic_full.returncodes
    result["ref3_returncodes"] = ref3.returncodes
    result["elastic_final_step"] = ckpt.latest_step(ws)
    loss_full, loss_ref = _logged_loss(ws, 6), _logged_loss(ws_ref, 6)
    result["elastic_final_loss"] = loss_full
    result["ref3_final_loss"] = loss_ref
    result["final_loss_rel_diff"] = (abs(loss_full - loss_ref) / max(abs(loss_ref), 1e-12)
                                     if loss_full is not None and loss_ref is not None
                                     else None)
    ok_elastic = (ok_primitive
                  and all(rc == 0 for rc in elastic_full.returncodes)
                  and all(rc == 0 for rc in ref3.returncodes)
                  and result["elastic_final_step"] == 6
                  and result["final_loss_rel_diff"] is not None
                  and result["final_loss_rel_diff"] <= 0.10)
    result["elastic_ok"] = ok_elastic

    # ---- phase D: exact same-topology resume across processes -----------
    ws_bit = os.path.join(workdir, "mh_ws_bit")
    bit1 = run(ws_bit, 2, 6, "mh_bit1",
               faults={0: "preempt_exit@step=3", 1: "preempt_exit@step=3"}, expect=1)
    _clear_heartbeats(ws_bit)  # bit1 crashed on purpose
    bit2 = run(ws_bit, 2, 6, "mh_bit2")
    ws_bitref = os.path.join(workdir, "mh_ws_bitref")
    bitref = run(ws_bitref, 2, 6, "mh_bitref")
    result["bit_interrupt_returncodes"] = bit1.returncodes
    result["bit_resume_returncodes"] = bit2.returncodes
    result["bit_ref_returncodes"] = bitref.returncodes
    ok_bit = (all(rc not in (None, 0) for rc in bit1.returncodes)  # interrupted
              and all(rc == 0 for rc in bit2.returncodes)
              and all(rc == 0 for rc in bitref.returncodes))
    if ok_bit:
        def second_reference() -> str:
            ws_bitref2 = os.path.join(workdir, "mh_ws_bitref2")
            ref2 = run(ws_bitref2, 2, 6, "mh_bitref2")
            result["bit_ref2_returncodes"] = ref2.returncodes
            if any(rc != 0 for rc in ref2.returncodes):
                raise RuntimeError(f"the second reference run failed: {ref2.returncodes}")
            return ws_bitref2

        result.update(_restored(bit2))
        ex = _exactness(ws_bit, ws_bitref, 6, device, second_reference)
        ok_bit = ex.pop("ok") and result["restore_ok"]
        result.update(ex)
    result["bitwise_ok"] = ok_bit
    result["launches"] = launches
    result["seconds"] = round(time.perf_counter() - t0, 1)
    result["ok"] = ok_kill and ok_elastic and ok_bit
    return result


def datasets_half(workdir: str, timeout_s: float, device: str | None = None) -> dict:
    """The dataset-conformance matrix (data/conformance/): every shipped
    config's loader against its fixture through the train, evaluate and
    serve CLIs; each config's stage outcomes in the verdict. An explicit
    --half only, as in the JAX drill."""
    from mine_tpu_torch.data.conformance.runner import run_matrix

    summary = run_matrix(os.path.join(workdir, "conformance"), timeout_s=timeout_s,
                         device=device)
    return {
        "ok": summary["ok"],
        "configs_checked": summary["configs_checked"],
        "configs_ok": summary["configs_ok"],
        "per_config": {
            r["config"]: {"ok": r["ok"],
                          **{s: bool(res.get("ok")) for s, res in r["stages"].items()}}
            for r in summary["results"]
        },
        "failures": [
            {"config": r["config"],
             "stages": {s: res for s, res in r["stages"].items() if not res.get("ok")}}
            for r in summary["results"] if not r["ok"]
        ],
    }


def ledger_gate() -> dict:
    """The perf regression gate (obs/ledger.py check, the verdict `python -m
    mine_tpu_torch.tools.perf_ledger check` prints) over the configured
    ledger."""
    from mine_tpu_torch.obs import ledger

    path = ledger.ledger_path()
    if path is None:
        return {"ok": True, "note": f"ledger disabled (${ledger.LEDGER_ENV})"}
    lv = ledger.check(path)
    return {
        "ledger": lv["ledger"], "ok": lv["ok"], "rows": lv["rows"],
        "regressions": lv["regressions"],
        "streams_checked": len(lv["checked"]),
        "streams_skipped": len(lv["skipped"]),
        "streams": sorted({c["metric"] for c in lv["checked"]}),
        "failures": [
            {**{k: c[k] for k in ("metric", "device", "backend_class")},
             "fields": [f for f in c["fields"] if f["regressed"]]}
            for c in lv["checked"] if any(f["regressed"] for f in c["fields"])
        ],
    }


HALVES = ("training", "serving", "fleet", "scale", "brownout", "multihost")


def run_half(half: str, args: argparse.Namespace, workdir: str) -> dict:
    if half == "training":
        return training_half(workdir, args.steps, exact=not args.no_exact,
                             timeout_s=args.timeout_s, device=args.device)
    if half == "serving":
        return serving_half(workdir, args.timeout_s, args.device)
    if half == "multihost":
        return multihost_half(workdir, args.timeout_s, args.device)
    if half == "datasets":
        return datasets_half(workdir, args.timeout_s, args.device)
    return globals()[f"{half}_half"](args.timeout_s, args.device)


def run_all(args: argparse.Namespace, workdir: str) -> dict[str, dict]:
    """Every half but datasets: the training half (the serving half after
    it, over its checkpoint) beside the multihost half, then the fake-weight
    halves. The two launch series share nothing but the machine, and the
    ranks' start-up and first steps, most of either half's time, overlap."""
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    with ThreadPoolExecutor(1) as pool:
        multihost = pool.submit(run_half, "multihost", args, workdir)
        for half in ("training", "serving"):
            out[half] = run_half(half, args, workdir)
        out["multihost"] = multihost.result()
    for half in ("fleet", "scale", "brownout"):
        out[half] = run_half(half, args, workdir)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--half", choices=(*HALVES, "datasets", "all"), default="all",
                        help="'datasets' sweeps the dataset-conformance matrix (train, "
                             "evaluate and serve a config); it stays out of 'all'")
    parser.add_argument("--workdir", default=None, help="scratch dir (default: a fresh tempdir)")
    parser.add_argument("--steps", type=int, default=6,
                        help="steps an epoch of the training half's runs")
    parser.add_argument("--no-exact", action="store_true",
                        help="skip the training half's uninterrupted reference run(s)")
    parser.add_argument("--timeout-s", type=float, default=900.0,
                        help="a launch's or a request's hard deadline")
    parser.add_argument("--device", default=None,
                        help="the card (default) or cpu: the ranks', the server's and the "
                             "fake engines' device")
    args = parser.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_drill_")
    os.makedirs(workdir, exist_ok=True)
    verdict: dict = {"metric": "chaos_drill", "half": args.half, "workdir": workdir,
                     "device": args.device or "cuda"}
    ok = True
    t0 = time.perf_counter()
    try:
        if _on_card(args.device):
            import torch

            from mine_tpu_torch.ops.kernels import build

            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass --device cpu to run "
                                   "the drill on the CPU")
            verdict["gpu"] = torch.cuda.get_device_name(0)
            build.build_all()  # once here, not in every rank at its first launch
        results = (run_all(args, workdir) if args.half == "all"
                   else {args.half: run_half(args.half, args, workdir)})
        for half, out in results.items():
            verdict[half] = out
            ok = ok and out["ok"]
        # the last gate: a drill that survives its faults but ships a perf
        # regression still fails
        verdict["perf_ledger"] = ledger_gate()
        ok = ok and verdict["perf_ledger"]["ok"]
        verdict["value"] = 1.0 if ok else None
        verdict["ok"] = ok
    except Exception as exc:  # noqa: BLE001 - the verdict is the output
        import traceback

        traceback.print_exc(file=sys.stderr)
        verdict.update(value=None, ok=False, error=f"{type(exc).__name__}: {exc}"[:2000])
        ok = False
    verdict["seconds"] = round(time.perf_counter() - t0, 1)
    emit(verdict)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
