"""The port's quality harnesses (mine_tpu_torch/tools/) against the JAX
package's (tools/), at 128x128, ResNet-18, fp32, on the CPU, from seeded
random weights carried across with models/convert.py.

  (a) oracle_alphas and disocclusion_mask equal the JAX tools' exactly, at
      128x128, for the held-out scenes and the three NOVEL_OFFSETS.
  (b) The oracle rows (S=8, soft and hard, three scenes) equal the JAX
      tool's to 1e-3 dB, dense and streaming (the chunked scan).
  (c) eval_novel_pose_psnr at S=4: per-pose PSNR within 1e-2 dB and the
      rendered rgb within atol 1e-4 of the JAX harness's, single-pass dense,
      single-pass streaming (K5's plain version) and coarse-to-fine (4 + 4
      planes) with the JAX package's fine draws (PRNGKey(1)) fed in.
  (d) The harness's first training step (B=4, S=4, mpi.fix_disparity):
      its loss dict at rtol 1e-4 of the JAX loss graph's on the same batch.
  (e) A JAX --save-final msgpack (the JAX harness's own serialization),
      converted by tools/jax_workspace_to_torch.py --msgpack and scored by
      the port's disocclusion_analysis: every key within 1e-2 dB of the JAX
      tool's line, the disoccluded pixel share equal.
  Also the end-to-end chain through the port's CLIs at one epoch, S=4, and
  the convergence harness's run() at 2 steps, its batches from batch_feed's
  spawned process against the same batches built inline.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mine_tpu.data.synthetic import _intrinsics as jax_intrinsics
from mine_tpu.data.synthetic import _render_view as jax_render_view
from mine_tpu.inference import video as jvideo
from mine_tpu.inference.trajectory import poses_from_offsets as jax_poses_from_offsets
from mine_tpu.training import step as jstep
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.tools import convergence_run as tconv
from mine_tpu_torch.tools import disocclusion_analysis as tdis
from mine_tpu_torch.tools import e2e_quality_run as te2e
from mine_tpu_torch.tools import oracle_mpi_ceiling as toracle
from mine_tpu_torch.training.optimizer import make_optimizer
from mine_tpu_torch.training.step import batch_to_device, build_model, train_step
from tests.test_torch_model import random_jax_variables
from tools import convergence_run as jconv
from tools import disocclusion_analysis as jdis
from tools import jax_workspace_to_torch
from tools import oracle_mpi_ceiling as joracle
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
S = 4
S_FINE = 4
LAYERS = 18
B_TRAIN = 4  # the harness's batch


def _jax_main(main, argv, capsys, monkeypatch) -> list[dict]:
    """A JAX tool's main() in this process: its JSON stdout lines. The
    tool's CPU forcing would run after the suite's backend bring-up, so
    JAX_PLATFORMS is blanked for the call."""
    monkeypatch.setattr("sys.argv", ["tool", *argv])
    monkeypatch.setenv("JAX_PLATFORMS", "")
    capsys.readouterr()
    main()
    monkeypatch.undo()
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def _port_main(main, argv, capsys) -> list[dict]:
    capsys.readouterr()
    assert main(argv) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def weights():
    """Seeded flax variables of the ResNet-18 MPINetwork (numpy), and the
    port model carrying them, in eval mode on the CPU."""
    jcfg = jconv.build_cfg(H, W, batch=1, num_planes=S)
    variables = random_jax_variables(jstep.build_model(jcfg), jnp.zeros((1, H, W, 3)),
                                     jnp.ones((1, S)), seed=11)
    flat = flatten_variables(variables)
    model = build_model(tconv.build_cfg(H, W, batch=1, num_planes=S))
    model.load_state_dict(jax_variables_to_torch(flat, LAYERS))
    return variables, flat, model.eval()


def _jax_rgb(cfg, variables, phase: float) -> np.ndarray:
    """The JAX harness's eval render of one scene (eval_novel_pose_psnr's
    inner loop, through the same jitted functions)."""
    k = jax_intrinsics(H, W)
    src, _ = jax_render_view(H, W, k, np.zeros(3), phase)
    kj = jnp.asarray(k)[None]
    if cfg.mpi.num_bins_fine > 0:
        rgb, sigma, disp = jvideo.predict_blended_mpi_c2f(cfg, variables, jnp.asarray(src)[None],
                                                          kj)
    else:
        disp = jnp.linspace(cfg.mpi.disparity_start, cfg.mpi.disparity_end,
                            cfg.mpi.num_bins_coarse)[None, :]
        rgb, sigma = jvideo.predict_blended_mpi(cfg, variables, jnp.asarray(src)[None], disp, kj)
    poses = jnp.asarray(jax_poses_from_offsets(jconv.NOVEL_OFFSETS))
    return np.asarray(jvideo.render_many(cfg, rgb, sigma, disp, kj, poses)[0])


def test_oracle_alphas_and_disocclusion_mask_equal_the_jax_tools():
    k = jax_intrinsics(H, W)
    assert np.array_equal(tconv.NOVEL_OFFSETS, jconv.NOVEL_OFFSETS)
    assert tconv.CROP == jconv.CROP
    assert toracle.EVAL_PHASES == tconv.HELDOUT_PHASES == joracle.EVAL_PHASES
    for offset in tconv.NOVEL_OFFSETS:
        cam = -np.asarray(offset, np.float64)
        want = jdis.disocclusion_mask(H, W, k, cam)
        assert want.any() and np.array_equal(tdis.disocclusion_mask(H, W, k, cam), want)
    for phase in toracle.EVAL_PHASES:
        _, depth = jax_render_view(H, W, k, np.zeros(3), phase)
        for s in (8, 16, 32):
            planes = np.linspace(1.0, 0.2, s).astype(np.float32)
            for variant in ("soft", "hard"):
                got = toracle.oracle_alphas(depth, planes, variant)
                want = joracle.oracle_alphas(depth, planes, variant)
                assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("compositor", ["dense", "streaming"])
def test_oracle_rows_equal_the_jax_tool(compositor, capsys, monkeypatch):
    want = _jax_main(joracle.main, ["--planes", "8"], capsys, monkeypatch)
    lines = _port_main(toracle.main, ["--planes", "8", "--device", "cpu",
                                      "--compositor", compositor], capsys)
    verdict, rows = lines[-1], lines[:-1]
    assert verdict["ok"] and verdict["rows"] == rows
    assert [(r["planes"], r["variant"]) for r in rows] == [(8, "soft"), (8, "hard")]
    assert len(want) == len(rows) == 2
    for got, ref in zip(rows, want):
        for key in ("planes", "variant", "disparity_end", "n_eval_scenes", "n_poses"):
            assert got[key] == ref[key]
        for key in ("psnr_novel", "psnr_src_pose"):
            # both tools print 3 decimals: 1e-3 is one step of the rounding
            assert round(abs(got[key] - ref[key]), 6) <= 1e-3, (key, got, ref)


@pytest.mark.parametrize("case", ["dense", "streaming", "coarse_to_fine"])
def test_eval_novel_pose_psnr_matches_the_jax_harness(case, weights):
    variables, _, model = weights
    fine = S_FINE if case == "coarse_to_fine" else 0
    jcfg = jconv.build_cfg(H, W, batch=1, num_planes=S, num_bins_fine=fine)
    tcfg = tconv.build_cfg(H, W, batch=1, num_planes=S, num_bins_fine=fine,
                           compositor="streaming" if case == "streaming" else "dense")
    # the JAX package's coarse-to-fine predict draws its fine planes from PRNGKey(1)
    fine_u = (torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(1),
                                                           (1, 1, S_FINE))))
              if fine else None)
    want = jconv.eval_novel_pose_psnr(jcfg, variables["params"], variables["batch_stats"],
                                      joracle.EVAL_PHASES)
    got = tconv.eval_novel_pose_psnr(tcfg, model, tconv.HELDOUT_PHASES, fine_u)
    assert got["n_eval_scenes"] == want["n_eval_scenes"] == 3
    assert np.allclose(got["psnr_per_pose"], want["psnr_per_pose"], rtol=0, atol=1e-2), (got, want)
    assert abs(got["psnr_novel"] - want["psnr_novel"]) <= 1e-2, (got, want)
    rgb = tconv.render_novel_poses(tcfg, model, tconv.HELDOUT_PHASES[0], fine_u)
    ref = _jax_rgb(jcfg, variables, tconv.HELDOUT_PHASES[0])
    assert rgb.shape == ref.shape == (len(tconv.NOVEL_OFFSETS), H, W, 3)
    np.testing.assert_allclose(rgb, ref, rtol=0, atol=1e-4)
    assert not model.training


def test_first_training_step_loss_dict_matches_jax(weights):
    """The harness's step 1 (its batch, its optimizer, train_step) from the
    carried weights, with fixed disparities so that no draw differs."""
    variables, flat, _ = weights
    fixed = {"mpi.fix_disparity": True}
    jcfg = jconv.build_cfg(H, W, batch=B_TRAIN, num_planes=S).replace(**fixed)
    tcfg = tconv.build_cfg(H, W, batch=B_TRAIN, num_planes=S).replace(**fixed)
    batch = tconv.synthetic_batch(1, B_TRAIN, H, W, seed=0)
    jmodel = jstep.build_model(jcfg)
    _, want, _, _ = jax.jit(lambda v, b: jstep.loss_fcn(
        jcfg, jmodel, v["params"], v["batch_stats"], b, jax.random.PRNGKey(0),
        is_val=False, train=True))(variables, {k: jnp.asarray(v) for k, v in batch.items()})

    model = build_model(tcfg)
    model.load_state_dict(jax_variables_to_torch(flat, LAYERS))
    optimizer, scheduler = make_optimizer(tcfg, model, steps_per_epoch=2200)
    got = train_step(tcfg, model, optimizer, scheduler, batch_to_device(batch, "cpu"),
                     torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    assert set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    assert all(math.isfinite(float(v)) for v in got.values())


def test_jax_save_converts_and_scores_like_the_jax_tool(weights, tmp_path, capsys,
                                                        monkeypatch):
    variables, _, _ = weights
    msgpack = tmp_path / "final_params.msgpack"
    # the JAX harness's own serialization of its --save-final
    msgpack.write_bytes(serialization.to_bytes(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    want = _jax_main(jdis.main, ["--params", str(msgpack), "--planes", str(S), "--out", ""],
                     capsys, monkeypatch)[-1]
    pt = tmp_path / "final_state.pt"
    exported = jax_workspace_to_torch.main(["--msgpack", str(msgpack), "--out", str(pt),
                                            "--layers", str(LAYERS)])
    assert exported["out"] == str(pt) and pt.exists()
    out = tmp_path / "disocclusion.json"
    (got,) = _port_main(tdis.main, ["--params", str(pt), "--planes", str(S), "--device", "cpu",
                                    "--out", str(out)], capsys)
    assert got["ok"] and json.loads(out.read_text()) == got
    assert got["disoccluded_px_frac"] == want["disoccluded_px_frac"] > 0
    for key, value in want.items():
        if key == "disoccluded_px_frac":
            continue
        if isinstance(value, float):
            assert abs(got[key] - value) <= 1e-2, (key, got, want)
        else:
            assert got[key] == value, key


def test_end_to_end_chain_through_the_cli_at_one_epoch(tmp_path, capsys, monkeypatch):
    """The train and evaluate CLIs as subprocesses, one epoch (3 steps) at
    S=4: both exit 0 and the val PSNR is finite."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (line,) = _port_main(te2e.main, ["--epochs", "1", "--planes", "4", "--device", "cpu",
                                     "--out", str(tmp_path)], capsys)
    assert line["ok"] and line["train_rc"] == line["eval_rc"] == 0 and line["steps"] == 3
    assert math.isfinite(line["val_psnr"]) and line["eval_metrics"]["eval_examples"] == 3
    assert os.path.isdir(tmp_path / "run" / "checkpoints")


def test_convergence_run_through_batch_feed_equals_inline_batches(tmp_path):
    """run() at 2 steps, S=4, B=1 on the CPU: batch_feed's spawned process
    hands over synthetic_batch's batches, so the curve equals that of the
    same run with each batch built inline; the save loads into the model."""
    argv = ["--steps", "2", "--eval-every", "1", "--batch", "1", "--planes", "4",
            "--device", "cpu"]
    fed = tconv.run(tconv.parse_args([*argv, "--out", str(tmp_path / "fed"), "--save-final",
                                      str(tmp_path / "final.pt")]))
    args = tconv.parse_args([*argv, "--out", str(tmp_path / "inline")])
    inline = tconv.run(args, (tconv.synthetic_batch(step, 1, H, W, seed=0) for step in (1, 2)))
    curves = [[json.loads(ln) for ln in (tmp_path / name / "curve.jsonl").read_text().splitlines()]
              for name in ("fed", "inline")]
    assert [r["step"] for r in curves[0]] == [1, 2]
    for row in curves:
        assert all(math.isfinite(r["loss"]) and math.isfinite(r["psnr_novel"]) for r in row)
    assert [(r["loss"], r["psnr_novel"]) for r in curves[0]] == \
        [(r["loss"], r["psnr_novel"]) for r in curves[1]]
    assert fed["ok"] and inline["ok"] and fed["final_loss"] == inline["final_loss"]
    model = tconv.load_model(tconv.build_cfg(H, W, 1, S), str(tmp_path / "final.pt"), "cpu")
    assert not model.training
