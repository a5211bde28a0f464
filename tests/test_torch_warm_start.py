"""A workspace of the JAX package carried into the port
(tools/jax_workspace_to_torch.py) and a warm start from a workspace
directory (mine_tpu_torch/training/loop.py Trainer._warm_start_workspace),
against the JAX package's own warm start (mine_tpu/training/loop.py: the
whole train state restored from an orbax workspace, the step count from 0).

The JAX side runs in one subprocess in float64 (jax_enable_x64 with
`jnp.float32` aliased, as tests/test_torch_train.py runs it): seeded weights
(ResNet-18, 128x128, S=2, mpi.fix_disparity, Adam at lr 1e-4) take one
make_train_step; the state is cast to float32, as an fp32 run holds it, and
saved through mine_tpu/training/checkpoint.py with its params.yaml; then the
JAX warm start restores that workspace (ckpt.restore into a float64
template: exact) and takes one more step on a second batch.

  * The script exports the workspace; the port warm-starts from the export,
    and its parameters, BatchNorm statistics and Adam moments equal the JAX
    workspace's float32 values exactly, with each group's Adam count and the
    schedule's count at 1 and the port's own step count at 0.
  * One more step of each package from there, in float64 (the port's model
    and moments upcast exactly): the loss within 1e-12 relative and each
    parameter's update within 1e-9 relative L2 of JAX's (the norm floored at
    1e-4 of the largest), the float64 tolerances of tests/test_torch_train.py.
  * The export serves: load_for_serving restores its step and the infer CLI
    renders from it.
  * A directory that holds the JAX package's orbax checkpoints is refused by
    name, naming the script: as a warm start, for serving and for resuming.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"data.name": "synthetic", "data.img_h": 128, "data.img_w": 128,
        "data.per_gpu_batch_size": 2, "model.num_layers": 18, "model.dtype": "float32",
        "model.imagenet_pretrained": False, "mpi.num_bins_coarse": 2,
        "mpi.fix_disparity": True, "lr.backbone_lr": 1e-4, "lr.decoder_lr": 1e-4,
        "data.num_workers": 0}
STEPS_PER_EPOCH = 100

_JAX_SCRIPT = """
import json, os, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
jnp.float32 = jnp.float64  # before the JAX package binds its float32 pins
from flax import traverse_util
from mine_tpu.config import Config
from mine_tpu.data import make_synthetic_batch
from mine_tpu.training import build_model, checkpoint as ckpt, init_state, make_optimizer
from mine_tpu.training import step as jstep
from mine_tpu.training.state import TrainState
from mine_tpu_torch.models.convert import flatten_variables

ws, out_path, overrides, steps_per_epoch = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
cfg = Config().replace(**json.loads(overrides))
model = build_model(cfg)
tx = make_optimizer(cfg, steps_per_epoch)
key = jax.random.PRNGKey(0)
template = jax.eval_shape(lambda k: init_state(cfg, model, tx, k, load_pretrained=False), key)
rng = np.random.default_rng(5)
flat = {}
for path, sds in traverse_util.flatten_dict({"params": template.params,
                                            "batch_stats": template.batch_stats},
                                           sep="/").items():
    if path.endswith("kernel"):
        val = rng.uniform(-1, 1, sds.shape) / np.sqrt(np.prod(sds.shape[:-1]))
    elif "BatchNorm_0" in path and path.endswith(("scale", "var")):
        val = rng.uniform(0.5, 1.5, sds.shape)
    elif "BatchNorm_0" in path:
        val = rng.normal(0.0, 0.1, sds.shape)
    else:
        val = rng.uniform(-0.05, 0.05, sds.shape)
    if "dispconv" in path and path.endswith("bias"):
        val[3] = 2.0
    flat[path] = jnp.asarray(val.astype(np.float32), jnp.float64)
variables = traverse_util.unflatten_dict(flat, sep="/")
state = TrainState.create(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), key)
batches = []
for seed in (0, 1):
    b = make_synthetic_batch(2, 128, 128, n_points=32, seed=seed)
    b.pop("src_depth")
    batches.append(b)
as64 = lambda b: {k: jnp.asarray(v, jnp.float64) for k, v in b.items()}
step = jax.jit(jstep.make_train_step(cfg, model, tx))
state1, _ = step(state, as64(batches[0]))
# saved as an fp32 run holds its state
to32 = lambda x: np.asarray(x, np.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x
state1 = jax.tree.map(to32, state1)
os.makedirs(ws)
ckpt.save_paired_config(cfg, ws)
manager = ckpt.checkpoint_manager(ws)
ckpt.save(manager, state1, 1)
ckpt.wait_until_finished(manager)
# the JAX warm start: the whole state restored into a (float64) template
warm, warm_step = ckpt.restore(ckpt.checkpoint_manager(ws), template)
assert warm_step == 1 and warm.params["decoder"]["dispconv_0"]["Conv_0"]["bias"].dtype == np.float64
state2, loss2 = step(warm, as64(batches[1]))
saved = {"params": state1.params, "batch_stats": state1.batch_stats}
adam = [s for g in state1.opt_state.inner_states.values() for s in g.inner_state
        if hasattr(s, "mu")]
moments = {}
for s in adam:
    for name in ("mu", "nu"):
        for k, v in traverse_util.flatten_dict(getattr(s, name), sep="/").items():
            if not type(v).__name__ == "MaskedNode":
                moments[f"{name}/params/{k}"] = np.asarray(v)
np.savez(out_path, loss2=np.asarray(loss2["loss"]),
         **{f"saved/{k}": v for k, v in flatten_variables(saved).items()},
         **{f"new/{k}": np.asarray(v) for k, v in
            flatten_variables({"params": state2.params}).items()},
         **moments, **{f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
"""


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "jax_workspace_to_torch", os.path.join(REPO, "tools", "jax_workspace_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX workspace, the port export of it, and what the JAX side
    computed (its saved variables and moments, its warm-started step)."""
    tmp = tmp_path_factory.mktemp("warm_start")
    ws, out = str(tmp / "jax_ws"), str(tmp / "out.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, ws, out, json.dumps(TINY),
                           str(STEPS_PER_EPOCH)], cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        jax_side = {k: z[k] for k in z.files}
    export = _exporter().main(["--workspace", ws, "--out", str(tmp / "port_ws")])
    yield {"jax_ws": ws, "port_ws": str(tmp / "port_ws"), "tmp": tmp, "export": export,
           **jax_side}
    shutil.rmtree(tmp, ignore_errors=True)  # two workspaces of ~0.2 GB each


def _warm_trainer(path: str):
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.training.loop import Trainer

    trainer = Trainer(Config().replace(**TINY, **{"training.pretrained_checkpoint_path": path}),
                      None, device="cpu")
    trainer._start(STEPS_PER_EPOCH)
    return trainer


def test_export_warm_starts_the_port_with_the_jax_state_exactly(jax_run):
    from mine_tpu_torch.models.convert import torch_grads_to_jax, torch_to_jax_variables

    assert jax_run["export"]["step"] == 1 and jax_run["export"]["adam_moments"]
    trainer = _warm_trainer(jax_run["port_ws"])
    got = torch_to_jax_variables(trainer.model.state_dict(), 18)
    want = {k[len("saved/"):]: v for k, v in jax_run.items() if k.startswith("saved/")}
    assert set(got) == set(want)
    for key, value in want.items():
        assert value.dtype == np.float32 and np.array_equal(got[key], value), key
    for moment, torch_name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for p in trainer.model.parameters():
            p.grad = trainer.optimizer.state[p][torch_name]
        flat = torch_grads_to_jax(trainer.model, 18)
        for key, value in flat.items():
            assert np.array_equal(value, jax_run[f"{moment}/{key}"]), (moment, key)
    assert {float(s["step"]) for s in trainer.optimizer.state.values()} == {1.0}
    assert trainer.scheduler.last_epoch == 1 and trainer.global_step == 0


def test_one_more_step_matches_the_jax_warm_start_in_float64(jax_run):
    from mine_tpu_torch.models.convert import torch_to_jax_variables
    from mine_tpu_torch.training import step as tstep

    trainer = _warm_trainer(jax_run["port_ws"])
    trainer.model.double()
    for state in trainer.optimizer.state.values():
        for m in ("exp_avg", "exp_avg_sq"):
            state[m] = state[m].double()
    # copies: the converter's arrays view the live parameters
    before = {k: v.copy() for k, v in torch_to_jax_variables(trainer.model.state_dict(),
                                                             18).items()}
    batch = {k[len("batch1/"):]: torch.from_numpy(v).double() for k, v in jax_run.items()
             if k.startswith("batch1/")}
    out = tstep.train_step(trainer.cfg, trainer.model, trainer.optimizer, trainer.scheduler,
                           batch)
    assert float(out["loss"]) == pytest.approx(float(jax_run["loss2"]), rel=1e-12)
    after = torch_to_jax_variables(trainer.model.state_dict(), 18)
    want = {k[len("new/"):]: v - before[k[len("new/"):]] for k, v in jax_run.items()
            if k.startswith("new/")}
    floor = 1e-4 * max(np.linalg.norm(v) for v in want.values())
    bad = {}
    for key, w in want.items():
        err = np.linalg.norm((after[key] - before[key]) - w) / max(np.linalg.norm(w), floor)
        if err > 1e-9:
            bad[key] = (err, float(np.linalg.norm(after[key] - before[key])),
                        float(np.linalg.norm(w)))
    assert not bad, f"{len(bad)} of {len(want)} updates off: {sorted(bad.items())[:5]}"


def test_export_serves_through_infer(jax_run, tmp_path):
    from PIL import Image

    from mine_tpu_torch import infer
    from mine_tpu_torch.training import checkpoint as ckpt

    cfg, state, step = ckpt.load_for_serving(jax_run["port_ws"])
    assert step == 1 and cfg.model.num_layers == 18
    saved = ckpt.load(jax_run["port_ws"], 1)["model"]
    assert set(state) == set(saved) and all(torch.equal(state[k], v) for k, v in saved.items())
    image = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (128, 128, 3), np.uint8)
                    ).save(image)
    written = infer.main(["--checkpoint", jax_run["port_ws"], "--image", str(image),
                          "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert written and all(os.path.exists(p) for p in written)


def test_a_jax_workspace_is_refused_by_name(jax_run):
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.loop import Trainer

    with pytest.raises(ckpt.OrbaxWorkspaceError, match="tools/jax_workspace_to_torch.py"):
        _warm_trainer(jax_run["jax_ws"])
    with pytest.raises(ckpt.OrbaxWorkspaceError, match="tools/jax_workspace_to_torch.py"):
        ckpt.load_for_serving(jax_run["jax_ws"])
    with pytest.raises(ckpt.OrbaxWorkspaceError, match="orbax"):
        Trainer(Config().replace(**TINY), jax_run["jax_ws"], device="cpu")._start(1)
