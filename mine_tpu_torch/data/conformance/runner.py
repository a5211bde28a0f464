"""The conformance runner (the port's own copy of
mine_tpu/data/conformance/runner.py): every shipped config, proven end to end.

Two rungs:

  * `check_contract(config)`: in-process, seconds. Writes the family
    fixture, builds the train/val datasets through the REGISTRY (the same
    factory the CLIs use), and verifies every LoaderContract claim against
    live batches: required keys/shapes/dtypes, K structure, pose
    composition, sparse-depth presence, point reprojection (where the
    family guarantees in-view points), wrap-padded val tails with
    eval_weight bookkeeping, and the host_slice bitwise slice-vs-global
    equality.
  * `check_loader(config)`: the contract checks PLUS the config driven
    through the port's CLIs against its fixture: `python -m
    mine_tpu_torch.train` (subprocess, tiny-shape overrides), `python -m
    mine_tpu_torch.evaluate` over the trained workspace, and `python -m
    mine_tpu_torch.serving` answering a live /predict -> /render ->
    /healthz round over HTTP (`serve_stage`).

Each config yields ONE JSON-serializable verdict dict; `run_matrix` sweeps a
config list and aggregates. `python -m mine_tpu_torch.data.conformance`
drives it from the command line (__main__.py).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from mine_tpu_torch.data.conformance.contract import (
    all_config_names,
    configs_dir,
    contract_for_config,
)
from mine_tpu_torch.data.conformance.fixtures import write_fixture

STAGES = ("contract", "train", "eval", "serve")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# smallest full-model shape: H, W must be 128-multiples (decoder
# receptive-field extension), resnet-18, S=2
_TINY_H, _TINY_W = 128, 128


def conformance_overrides(fixture_path: str) -> dict:
    """The tiny-shape override layer every stage shares: the config keeps
    its own recipe identity (dataset name, disparity range, loss weights, LR
    schedule) while the model/batch shrink to the smallest full-model shape
    and the data path points at the fixture."""
    return {
        "data.training_set_path": fixture_path,
        "data.img_h": _TINY_H, "data.img_w": _TINY_W,
        "data.img_pre_downsample_ratio": 1.0,
        "data.per_gpu_batch_size": 2,
        "data.num_tgt_views": 1,
        "data.visible_point_count": 16,
        "data.num_workers": 0,
        "model.num_layers": 18, "model.dtype": "float32",
        "model.imagenet_pretrained": False,
        "model.pretrained_backbone_path": "",
        "mpi.num_bins_coarse": 2, "mpi.num_bins_fine": 0,
        "training.epochs": 1,
        "training.eval_interval": 100000,  # the eval CLI is its own stage
        "training.checkpoint_interval": 2,
        "training.log_interval": 1,
        "training.pretrained_checkpoint_path": "",
        "training.lpips_weights_path": "",
        "mesh.data_parallel": 1, "mesh.fsdp_parallel": 1,
        "mesh.plane_parallel": 1,
    }


def _load_cfg(config_name: str, overrides: dict):
    from mine_tpu_torch.config import load_config

    return load_config(
        os.path.join(configs_dir(), "default.yaml"),
        os.path.join(configs_dir(), config_name + ".yaml"),
        overrides=overrides,
    )


# -- the in-process contract rung ---------------------------------------------


def _check(checks: dict, name: str, fn) -> None:
    try:
        fn()
        checks[name] = "ok"
    except Exception as exc:  # noqa: BLE001 - the verdict carries it
        checks[name] = f"FAIL: {type(exc).__name__}: {exc}"


def check_contract(config_name: str, fixture_root: str, overrides: dict | None = None,
                   fixture_kwargs: dict | None = None) -> dict:
    """Contract verification for one shipped config; writes (or reuses) the
    family fixture under `fixture_root`. `overrides` replace the tiny-shape
    layer (conformance_overrides, pointed at the fixture) key by key, and
    `fixture_kwargs` go to the fixture writer, so that the same checks run
    at a recipe's own shape."""
    from mine_tpu_torch.data.registry import build_dataset

    contract = contract_for_config(config_name)
    path = write_fixture(contract.family, fixture_root, **(fixture_kwargs or {}))
    cfg = _load_cfg(config_name, {**conformance_overrides(path), **(overrides or {})})
    checks: dict[str, str] = {}
    h, w = cfg.data.img_h, cfg.data.img_w
    global_batch = 2

    train_ds = build_dataset(cfg, "train", global_batch)
    val_ds = build_dataset(cfg, "val", global_batch)
    batch = next(iter(train_ds.epoch(0)))

    def keys_and_shapes():
        got = tuple(sorted(batch))
        want = tuple(sorted(contract.required_keys))
        assert got == want, f"batch keys {got} != contract {want}"
        b = global_batch
        assert batch["src_img"].shape == (b, h, w, 3), batch["src_img"].shape
        assert batch["tgt_img"].shape == (b, h, w, 3)
        assert batch["k_src"].shape == (b, 3, 3)
        assert batch["g_tgt_src"].shape == (b, 4, 4)
        for key, v in batch.items():
            assert v.dtype == np.float32, f"{key} dtype {v.dtype}"
            assert np.isfinite(v).all(), f"{key} carries non-finite values"
        assert batch["src_img"].min() >= 0.0 and batch["src_img"].max() <= 1.0

    _check(checks, "keys_and_shapes", keys_and_shapes)

    def intrinsics():
        for key in ("k_src", "k_tgt"):
            k = batch[key]
            np.testing.assert_allclose(k[:, 2], [[0.0, 0.0, 1.0]] * global_batch, atol=1e-6)
            assert (k[:, 0, 0] > 0).all() and (k[:, 1, 1] > 0).all()
            # pixels at the TARGET resolution: principal point inside
            assert ((k[:, 0, 2] > 0) & (k[:, 0, 2] < w)).all(), k[:, 0, 2]
            assert ((k[:, 1, 2] > 0) & (k[:, 1, 2] < h)).all(), k[:, 1, 2]

    _check(checks, "intrinsics_pixels_at_target", intrinsics)

    def pose():
        g = batch["g_tgt_src"]
        np.testing.assert_allclose(g[:, 3], [[0, 0, 0, 1]] * global_batch, atol=1e-6)
        r = g[:, :3, :3]
        np.testing.assert_allclose(np.einsum("bij,bkj->bik", r, r),
                                   np.tile(np.eye(3), (global_batch, 1, 1)), atol=1e-4)

    _check(checks, "pose_rigid", pose)

    def sparse_depth():
        present = "pt3d_src" in batch
        assert present == contract.sparse_depth, (
            f"sparse-depth presence {present} != contract {contract.sparse_depth} "
            "(training/step.py NO_DISP_SUPERVISION must agree)"
        )
        if present:
            n_pt = cfg.data.visible_point_count
            assert batch["pt3d_src"].shape == (global_batch, n_pt, 3)
            assert (batch["pt3d_src"][..., 2] > 0).all(), "points behind camera"
            assert (batch["pt3d_tgt"][..., 2] > 0).all()
            if contract.points_in_view:
                uvw = np.einsum("bij,bnj->bni", batch["k_src"], batch["pt3d_src"])
                uv = uvw[..., :2] / uvw[..., 2:]
                assert (uv[..., 0] > -0.5).all() and (uv[..., 0] < w + 0.5).all()
                assert (uv[..., 1] > -0.5).all() and (uv[..., 1] < h + 0.5).all()

    _check(checks, "sparse_depth", sparse_depth)

    def ragged_val_tail():
        batches = list(val_ds.epoch(0))
        assert len(batches) == len(val_ds)
        if contract.ragged_val_tail == "fixed_steps":
            assert all("eval_weight" not in b for b in batches)
            return
        assert contract.ragged_val_tail == "wrap_pad"
        assert all(b["src_img"].shape[0] == global_batch for b in batches)
        assert all("eval_weight" in b for b in batches)
        weights = np.concatenate([b["eval_weight"] for b in batches])
        assert weights.sum() == val_ds.num_eval_examples, (
            f"eval_weight sum {weights.sum()} != num_eval_examples "
            f"{val_ds.num_eval_examples}"
        )

    _check(checks, "ragged_val_tail", ragged_val_tail)

    def host_slice():
        assert contract.host_slice, "contract says no host_slice support"
        sliced_ds = build_dataset(cfg, "train", global_batch, host_slice=(1, 1))
        sliced = next(iter(sliced_ds.epoch(0)))
        for key in batch:
            assert np.array_equal(batch[key][1:2], sliced[key]), (
                f"host_slice rows of {key} differ from the global build's "
                "slice: per-example seeding is broken"
            )

    _check(checks, "host_slice_bitwise", host_slice)

    ok = all(v == "ok" for v in checks.values())
    return {"ok": ok, "checks": checks, "fixture": path}


# -- the product-CLI rung ----------------------------------------------------


def _run_cli(argv: list[str], timeout_s: float) -> dict:
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", *argv], cwd=REPO_ROOT,
            capture_output=True, text=True, timeout=timeout_s,
        )
        rc = proc.returncode
        out, err = proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out = -1, (exc.stdout or "")
        err = (exc.stderr or "") + f"\n[timeout after {timeout_s}s]"
        out, err = (v.decode() if isinstance(v, bytes) else v for v in (out, err))
    return {
        "ok": rc == 0, "rc": rc,
        "seconds": round(time.monotonic() - t0, 1),
        "stdout_tail": out[-2000:], "stderr_tail": err[-2000:],
    }


def _fixture_png() -> bytes:
    """One analytic-scene view as PNG bytes (the /predict payload)."""
    from PIL import Image

    from mine_tpu_torch.data.synthetic import _intrinsics, _render_view

    img, _ = _render_view(64, 64, _intrinsics(64, 64), np.zeros(3), phase=0.3)
    buf = io.BytesIO()
    Image.fromarray((img * 255).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def http_request(base: str, path: str, data=None, headers=None, timeout=60):
    """One HTTP request; (status, body), error statuses included."""
    req = urllib.request.Request(base + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def serve_stage(workspace: str, timeout_s: float, device: str | None = None) -> dict:
    """Start the port's serving CLI over a trained workspace (`--port 0`),
    drive one predict -> render -> healthz round over HTTP, stop it."""
    t0 = time.monotonic()
    device_args = ["--device", device] if device else []
    proc = subprocess.Popen(
        [sys.executable, "-m", "mine_tpu_torch.serving", "--workspace", workspace,
         "--port", "0", *device_args],
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    url_box: dict[str, str] = {}
    lines: list[str] = []
    errors: list[str] = []

    def read_stdout():
        for line in proc.stdout:  # type: ignore[union-attr]
            lines.append(line.rstrip())
            if " on http://" in line:
                url_box["base"] = line.split(" on ", 1)[1].split()[0]

    def read_stderr():  # drained, so that a chatty server never blocks on the pipe
        errors.extend(proc.stderr)  # type: ignore[arg-type]

    readers = [threading.Thread(target=fn, daemon=True) for fn in (read_stdout, read_stderr)]
    for reader in readers:
        reader.start()
    try:
        deadline = time.monotonic() + timeout_s
        while "base" not in url_box:
            if proc.poll() is not None or time.monotonic() > deadline:
                return {"ok": False, "error": "server never bound",
                        "stdout_tail": "\n".join(lines)[-2000:],
                        "stderr_tail": "".join(errors)[-2000:],
                        "seconds": round(time.monotonic() - t0, 1)}
            time.sleep(0.2)
        base = url_box["base"]
        code, body = http_request(base, "/predict", data=_fixture_png(),
                           headers={"Content-Type": "image/png"}, timeout=timeout_s)
        if code != 200:
            raise RuntimeError(f"/predict {code}: {body[:300]!r}")
        key = json.loads(body)["mpi_key"]
        code, body = http_request(base, "/render",
                           data=json.dumps({"mpi_key": key,
                                            "offsets": [[0.01, 0.0, 0.0]]}).encode(),
                           headers={"Content-Type": "application/json"}, timeout=timeout_s)
        if code != 200 or len(json.loads(body)["frames_png_b64"]) != 1:
            raise RuntimeError(f"/render {code}: {body[:300]!r}")
        code, body = http_request(base, "/healthz", timeout=30)
        if code != 200:
            raise RuntimeError(f"/healthz {code}: {body[:300]!r}")
        health = json.loads(body)
        return {"ok": True, "seconds": round(time.monotonic() - t0, 1), "mpi_key": key,
                "checkpoint_step": health.get("checkpoint_step"),
                "backend": health.get("backend"), "compiles": health.get("compiles")}
    except Exception as exc:  # noqa: BLE001 - the verdict carries it
        return {"ok": False, "error": f"{type(exc).__name__}: {exc}",
                "stderr_tail": "".join(errors)[-2000:],
                "seconds": round(time.monotonic() - t0, 1)}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def check_loader(
    config_name: str,
    workdir: str,
    stages: tuple[str, ...] = STAGES,
    timeout_s: float = 900.0,
    device: str | None = None,
) -> dict:
    """One config's conformance verdict: contract checks, then train ->
    eval -> serve through the port's CLIs, everything against the fixture
    under `workdir`. The CLIs run on `device` ("cpu", or the CUDA device
    when None)."""
    contract = contract_for_config(config_name)
    fixture_root = os.path.join(workdir, "fixtures", contract.family)
    workspace = os.path.join(workdir, "ws_" + config_name)
    verdict: dict = {
        "config": config_name,
        "dataset": contract.family,
        "contract": dataclasses.asdict(contract),
        "stages": {},
    }
    stage_results = verdict["stages"]

    if "contract" in stages:
        try:
            stage_results["contract"] = check_contract(config_name, fixture_root)
        except Exception as exc:  # noqa: BLE001 - the verdict carries it
            stage_results["contract"] = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
    fixture_path = stage_results.get("contract", {}).get(
        "fixture"
    ) or write_fixture(contract.family, fixture_root)
    overrides = conformance_overrides(fixture_path)
    verdict["overrides"] = overrides
    device_args = ["--device", device] if device else []

    if "train" in stages and stage_results.get("contract", {}).get("ok", True):
        stage_results["train"] = _run_cli([
            "mine_tpu_torch.train",
            "--config", os.path.join(configs_dir(), config_name + ".yaml"),
            "--extra_config", json.dumps(overrides),
            "--workspace", workspace, *device_args,
        ], timeout_s)
    if "eval" in stages and stage_results.get("train", {}).get("ok", True):
        result = _run_cli(["mine_tpu_torch.evaluate", "--checkpoint", workspace,
                           *device_args], timeout_s)
        if result["ok"]:
            try:
                metrics = json.loads(result["stdout_tail"].strip().splitlines()[-1])
                result["loss"] = metrics.get("loss")
                result["psnr_tgt"] = metrics.get("psnr_tgt")
                result["eval_examples"] = metrics.get("eval_examples")
                if not np.isfinite(metrics.get("loss", np.nan)):
                    result["ok"] = False
                    result["error"] = "non-finite eval loss"
            except (ValueError, IndexError) as exc:
                result["ok"] = False
                result["error"] = f"unparseable eval output: {exc}"
        stage_results["eval"] = result
    if "serve" in stages and stage_results.get("train", {}).get("ok", True):
        stage_results["serve"] = serve_stage(workspace, timeout_s, device)

    verdict["ok"] = bool(stage_results) and all(s.get("ok") for s in stage_results.values())
    return verdict


def run_matrix(
    workdir: str,
    config_names: tuple[str, ...] | None = None,
    stages: tuple[str, ...] = STAGES,
    timeout_s: float = 900.0,
    device: str | None = None,
) -> dict:
    """Sweep the config matrix; returns the aggregate verdict document."""
    names = config_names if config_names is not None else all_config_names()
    results = [check_loader(name, workdir, stages=stages, timeout_s=timeout_s, device=device)
               for name in names]
    return {
        "metric": "dataset_conformance",
        "configs_checked": len(results),
        "configs_ok": sum(1 for r in results if r["ok"]),
        "stages": list(stages),
        "ok": all(r["ok"] for r in results),
        "results": results,
    }
