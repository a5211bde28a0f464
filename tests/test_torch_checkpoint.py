"""Checkpoints, resume, the sentinel in the loop, and the CLIs, on the CPU.

Trainer.fit at a tiny size (128x128, ResNet-18, S=4, B=2, fp32) on the
synthetic scene, with the streaming compositor, accumulation over two
micro-batches, sigma dropout, remat and the sentinel on, so that every piece
of state a step touches goes through the checkpoint: 4 steps straight and 2
steps + a new Trainer resuming + 2 steps end bit-equal (model, BatchNorm
buffers, optimizer, schedule, generators), as the JAX package's bitwise
resume. Then the integrity sidecar, the last-good pointer, retention, the
paired config, the emergency checkpoint, the sentinel's policies on a NaN
batch, and `python -m mine_tpu_torch.evaluate` on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mine_tpu_torch.config import Config, load_config
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.resilience.sentinel import SentinelAbort, TrainingSentinel
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.training.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "data.name": "synthetic", "data.img_h": 128, "data.img_w": 128,
    "data.per_gpu_batch_size": 2, "model.num_layers": 18, "model.dtype": "float32",
    "mpi.num_bins_coarse": 4, "data.visible_point_count": 16,
    "mpi.compositor": "streaming", "training.accum_steps": 2,
    "mpi.sigma_dropout_rate": 0.1, "model.remat_decoder": True,
    "resilience.sentinel_policy": "skip", "training.checkpoint_interval": 2,
    "training.log_interval": 1,
}


def _cfg(**extra) -> Config:
    return Config().replace(**{**SMALL, **extra})


def _fit(cfg, ws, max_steps, val=False):
    trainer = Trainer(cfg, str(ws), device="cpu")
    trainer.fit(build_dataset(cfg, "train", 2),
                build_dataset(cfg, "val", 2) if val else None, max_steps=max_steps)
    return trainer


def _same_state(a: Trainer, b: Trainer) -> None:
    sa, sb = a.state(), b.state()
    assert sa["global_step"] == sb["global_step"]
    assert all(torch.equal(sa["model"][k], sb["model"][k]) for k in sa["model"]), "model"
    for pa, pb in zip(sa["optimizer"]["state"].values(), sb["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa), "optimizer"
    assert sa["scheduler"] == sb["scheduler"]
    for name in ("disparity", "dropout"):
        assert torch.equal(sa["generators"][name], sb["generators"][name]), name


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    cfg = _cfg()
    straight = _fit(cfg, tmp_path / "a", 4)
    _fit(cfg, tmp_path / "b", 2)
    assert ckpt.all_steps(str(tmp_path / "b")) == [2]
    resumed = _fit(cfg, tmp_path / "b", 4)
    _same_state(straight, resumed)
    assert ckpt.all_steps(str(tmp_path / "b")) == [2, 4] == ckpt.all_steps(str(tmp_path / "a"))
    assert ckpt.last_good_step(str(tmp_path / "b")) == 4
    # and what was saved is what the trainer held
    saved = ckpt.load(str(tmp_path / "b"), 4)
    assert all(torch.equal(saved["model"][k], v) for k, v in resumed.state()["model"].items())


def test_eval_runs_at_its_interval(tmp_path):
    trainer = _fit(_cfg(**{"training.eval_interval": 2}), tmp_path, 4, val=True)
    assert [step for step, _ in trainer.evals] == [2, 4]
    result = trainer.evals[-1][1]
    assert result["eval_examples"] == 4 and np.isfinite(result["psnr_tgt"])
    lines = (tmp_path / "eval_log.jsonl").read_text().splitlines()
    assert [json.loads(ln)["global_step"] for ln in lines] == [2, 4]


def test_flipped_byte_raises_checkpoint_corrupt(tmp_path):
    ws = str(tmp_path)
    _fit(_cfg(**{"model.remat_decoder": False}), ws, 2)
    path = os.path.join(ckpt.checkpoint_path(ws), "2", ckpt.STATE_FILE)
    ckpt.verify_checkpoint_integrity(ws, 2)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    with open(path, "wb") as fh:
        fh.write(data)
    with pytest.raises(ckpt.CheckpointCorrupt, match="state.pt"):
        ckpt.load(ws, 2)
    with pytest.raises(ckpt.CheckpointCorrupt):
        Trainer(_cfg(), ws, device="cpu").fit(build_dataset(_cfg(), "train", 2), max_steps=3)


def test_last_good_pointer_and_retention(tmp_path):
    ws = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.last_good_target(ws)
    state = {"x": torch.zeros(2)}
    for step in (10, 20, 30, 40, 50):
        ckpt.save(ws, state, step, max_to_keep=3, keep_period=20)
    # the newest three, and the steps keep_period divides
    assert ckpt.all_steps(ws) == [20, 30, 40, 50]
    assert sorted(os.listdir(os.path.join(ws, "integrity"))) == [
        f"{s}.json" for s in (20, 30, 40, 50)]
    with pytest.raises(FileExistsError):
        ckpt.save(ws, state, 50)
    assert ckpt.last_good_step(ws) is None and ckpt.last_good_target(ws) == 50
    ckpt.mark_last_good(ws, 35)
    assert ckpt.last_good_step(ws) == 35 and ckpt.last_good_target(ws) == 30
    ckpt.mark_last_good(ws, 5)  # older than anything retained
    assert ckpt.last_good_target(ws) == 50


def test_resume_from_last_good_takes_the_pointer(tmp_path):
    ws = str(tmp_path)
    cfg = _cfg(**{"model.remat_decoder": False})
    _fit(cfg, ws, 4)
    ckpt.mark_last_good(ws, 2)
    trainer = Trainer(cfg.replace(**{"training.resume_from": "last_good"}), ws, device="cpu")
    trainer.fit(build_dataset(cfg, "train", 2), max_steps=2)
    assert trainer.global_step == 2  # resumed at 2, nothing left to do
    with pytest.raises(ValueError, match="resume_from"):
        Trainer(cfg.replace(**{"training.resume_from": "oldest"}), ws, device="cpu").fit(
            build_dataset(cfg, "train", 2), max_steps=1)


def test_paired_config_round_trip(tmp_path):
    from mine_tpu.config import Config as JaxConfig
    from mine_tpu.config import load_config as jax_load_config
    from mine_tpu.config import save_config as jax_save_config

    cfg = _cfg(**{"lr.decay_steps": (3, 7), "resilience.sentinel_spike_factor": 4.0})
    ckpt.save_paired_config(cfg, str(tmp_path))
    assert ckpt.load_paired_config(str(tmp_path)) == cfg
    over = ckpt.load_paired_config(str(tmp_path), {"training.seed": 3})
    assert over.training.seed == 3 and over.replace(**{"training.seed": 0}) == cfg
    # the JAX package reads the port's params.yaml, and the port reads the JAX one
    jcfg = jax_load_config(str(tmp_path / "params.yaml"))
    overrides = {k: v for k, v in SMALL.items()} | {
        "lr.decay_steps": (3, 7), "resilience.sentinel_spike_factor": 4.0}
    assert jcfg == JaxConfig().replace(**overrides)
    jax_save_config(jcfg, str(tmp_path / "jax_params.yaml"))
    assert load_config(str(tmp_path / "jax_params.yaml")) == cfg


class _Poisoned:
    """The synthetic train split with NaN pixels in the batch at `bad` (the
    global position, counted from 1) and, optionally, an error at `boom`."""

    def __init__(self, ds, bad=None, boom=None):
        self.ds, self.bad, self.boom = ds, bad, boom

    def __len__(self):
        return len(self.ds)

    def epoch(self, n):
        for i, batch in enumerate(self.ds.epoch(n), start=1 + (n - 1) * len(self.ds)):
            if i == self.boom:
                raise RuntimeError("loader died")
            if i == self.bad:
                batch = dict(batch, src_img=batch["src_img"] * np.float32("nan"))
            yield batch


def test_sentinel_skip_in_the_loop(tmp_path):
    cfg = _cfg(**{"model.remat_decoder": False})
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    trainer.fit(_Poisoned(build_dataset(cfg, "train", 2), bad=3), max_steps=4)
    assert trainer.global_step == 4
    assert trainer.sentinel.skipped_updates == 1 and trainer.sentinel.nonfinite_steps == 1
    assert trainer.sentinel.trips == {("nonfinite", "skip"): 1}
    log = [json.loads(ln) for ln in (tmp_path / "train_log.jsonl").read_text().splitlines()]
    assert [ln["update_skipped"] for ln in log] == [0.0, 0.0, 1.0, 0.0]
    assert all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters())


def test_sentinel_rollback_then_abort(tmp_path):
    """The NaN batch comes back after each rollback (the data stream resumes
    at the last-good step), so the rollbacks run out and the run aborts."""
    cfg = _cfg(**{"model.remat_decoder": False, "resilience.sentinel_policy": "rollback",
                  "resilience.max_rollbacks": 1})
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    with pytest.raises(SentinelAbort, match="max_rollbacks"):
        trainer.fit(_Poisoned(build_dataset(cfg, "train", 2), bad=3), max_steps=4)
    assert trainer.sentinel.rollbacks == 2
    assert trainer.sentinel.trips == {("nonfinite", "rollback"): 2}
    assert ckpt.last_good_step(str(tmp_path)) == 2


def test_emergency_checkpoint_keeps_the_last_step(tmp_path, monkeypatch):
    cfg = _cfg(**{"model.remat_decoder": False, "training.checkpoint_interval": 100})
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="loader died"):
        trainer.fit(_Poisoned(build_dataset(cfg, "train", 2), boom=4), max_steps=6)
    assert ckpt.all_steps(str(tmp_path)) == [3]
    assert ckpt.last_good_step(str(tmp_path)) is None  # an emergency save is not vetted
    # a failing emergency save never masks the original error
    monkeypatch.setattr(ckpt, "save", lambda *a, **k: (_ for _ in ()).throw(OSError("disk")))
    with pytest.raises(RuntimeError, match="loader died"):
        Trainer(cfg, str(tmp_path / "other"), device="cpu").fit(
            _Poisoned(build_dataset(cfg, "train", 2), boom=2), max_steps=6)


class _Log:
    def __init__(self):
        self.lines = []

    def warning(self, *args):
        self.lines.append(args[0] % args[1:])


@pytest.mark.parametrize("policy", ["skip", "rollback", "abort"])
def test_sentinel_spike_and_policies(policy):
    from mine_tpu_torch.resilience.sentinel import SentinelRollback

    cfg = Config().replace(**{"resilience.sentinel_policy": policy,
                              "resilience.sentinel_spike_factor": 3.0,
                              "resilience.sentinel_spike_min_history": 2})
    sentinel = TrainingSentinel(cfg.resilience, _Log())
    for step, loss in enumerate((1.0, 1.2, 2.0), start=1):
        sentinel.observe(step, torch.tensor(0.0))
        sentinel.check(loss, step)
    raised = {"skip": None, "rollback": SentinelRollback, "abort": SentinelAbort}[policy]
    if raised is None:
        sentinel.check(10.0, 4)
    else:
        with pytest.raises(raised, match="spike"):
            sentinel.check(10.0, 4)
    assert sentinel.trips == {("spike", policy): 1}
    # a bad flag found by vet() (no raise) trips at the next check
    sentinel.observe(5, torch.tensor(1.0))
    assert sentinel.vet(5) is False
    if raised is None:
        sentinel.flush(5)
    else:
        with pytest.raises(raised, match="nonfinite"):
            sentinel.flush(5)
    assert sentinel.nonfinite_steps == 1
    with pytest.raises(ValueError, match="sentinel_policy"):
        TrainingSentinel(Config().replace(**{"resilience.sentinel_policy": "maybe"}).resilience,
                         _Log())


def test_evaluate_cli_on_the_cpu(tmp_path):
    _fit(_cfg(**{"model.remat_decoder": False}), tmp_path, 2)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "mine_tpu_torch.evaluate", "--checkpoint", str(tmp_path),
         "--device", "cpu", "--extra_config", json.dumps({"training.seed": 1})],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["step"] == 2 and result["eval_examples"] == 4
    assert np.isfinite(result["loss"]) and result["lpips_tgt"] == 0.0


def test_profile_steps_writes_a_trace(tmp_path):
    """--profile-steps N (Trainer profile_steps) traces the first N steps of
    fit with torch.profiler into <workspace>/profile."""
    cfg = _cfg(**{"model.remat_decoder": False, "training.accum_steps": 1})
    trainer = Trainer(cfg, str(tmp_path), device="cpu", profile_steps=1)
    trainer.fit(build_dataset(cfg, "train", 2), max_steps=2)
    trace = json.loads((tmp_path / "profile" / "train_steps.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
