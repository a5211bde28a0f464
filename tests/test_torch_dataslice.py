"""The data slice as a whole, against the JAX package.

One LLFF val batch (the fixture's 3 val views, wrap-padded to B=4, so the
last slot carries eval_weight 0), built by each package's own loader from
the same on-disk fixture, through each package's eval-mode loss at 128x128,
ResNet-18, S=2, fp32, fixed disparities, with the same seeded random weights
(jax_variables_to_torch). Every entry of the loss dict agrees at the
tolerance of tests/test_torch_eval.py (rel 2e-4, abs 1e-6: fp32 networks in
two frameworks); eval_examples exactly.

Then the recipe from its own yaml through the CLIs, as a user runs them:
`python -m mine_tpu_torch.train --config mine_tpu/configs/llff.yaml --device
cpu` for 2 steps on the fixture, then `python -m mine_tpu_torch.evaluate
--device cpu`, which prints one finite JSON line over the 3 val examples.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from mine_tpu.config import Config as JConfig
from mine_tpu.data.registry import build_dataset as j_build_dataset
from mine_tpu.training import step as jstep
from mine_tpu.training.state import TrainState
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.conformance.fixtures import write_fixture
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.training import step as tstep
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
TINY = {
    "data.name": "llff", "data.img_h": 128, "data.img_w": 128,
    "data.img_pre_downsample_ratio": 1.0, "data.per_gpu_batch_size": B,
    "data.visible_point_count": 16, "model.num_layers": 18, "model.dtype": "float32",
    "mpi.num_bins_coarse": 2, "mpi.fix_disparity": True,
}


def _random_variables(jcfg, seed: int) -> dict:
    """Seeded flax variables of the tiny model, from jax.eval_shape (no init
    compile), BatchNorm statistics away from the identity."""
    model = jstep.build_model(jcfg)
    x = np.zeros((1, 128, 128, 3), np.float32)
    d = np.linspace(1.0, 0.1, 2, dtype=np.float32)[None]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, d, False))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, sds in traverse_util.flatten_dict(shapes, sep="/").items():
        if key.endswith("kernel"):
            val = rng.uniform(-1, 1, sds.shape) / np.sqrt(np.prod(sds.shape[:-1]))
        elif key.endswith(("scale", "var")):
            val = rng.uniform(0.5, 1.5, sds.shape)
        else:
            val = rng.normal(0.0, 0.05, sds.shape)
        if "dispconv" in key and key.endswith("bias"):
            val[3] = 2.0
        flat[key] = val.astype(np.float32)
    return flatten_variables(traverse_util.unflatten_dict(flat, sep="/"))


def test_llff_val_batch_eval_loss_matches_jax(tmp_path):
    path = write_fixture("llff", str(tmp_path))
    over = {**TINY, "data.training_set_path": path}
    jcfg, cfg = JConfig().replace(**over), Config().replace(**over)
    (jbatch,) = list(j_build_dataset(jcfg, "val", B).epoch(0))
    (batch,) = list(build_dataset(cfg, "val", B).epoch(0))
    assert list(batch["eval_weight"]) == [1.0, 1.0, 1.0, 0.0]
    assert all(np.array_equal(jbatch[k], batch[k]) for k in jbatch)

    variables = _random_variables(jcfg, seed=5)
    tree = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in variables.items()},
                                        sep="/")
    state = TrainState.create(tree["params"], tree["batch_stats"],
                              optax.sgd(1.0).init(tree["params"]), jax.random.PRNGKey(0))
    eval_step = jax.jit(jstep.make_eval_step(jcfg, jstep.build_model(jcfg)))
    want, _ = eval_step(state, {k: jnp.asarray(v) for k, v in jbatch.items()},
                        jax.random.PRNGKey(1))

    model = MPINetwork(num_layers=18, multires=10)
    model.load_state_dict(jax_variables_to_torch(variables, 18))
    got, _ = tstep.eval_step(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    assert float(got["eval_examples"]) == float(want["eval_examples"]) == 3.0
    assert float(want["loss_disp_pt3dsrc"]) > 0.0
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=2e-4, abs=1e-6), k


def test_train_and_evaluate_clis_on_the_llff_recipe(tmp_path):
    path = write_fixture("llff", str(tmp_path / "fixture"))
    over = {**TINY, "data.training_set_path": path, "data.per_gpu_batch_size": 2,
            "training.log_interval": 1}
    ws = str(tmp_path / "ws")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one_torch_thread, for the CLIs

    def run(*argv):
        out = subprocess.run([sys.executable, "-m", *argv], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return out

    run("mine_tpu_torch.train", "--config", os.path.join(REPO, "mine_tpu/configs/llff.yaml"),
        "--device", "cpu", "--max_steps", "2", "--workspace", ws,
        "--extra_config", json.dumps(over))
    log = [json.loads(ln) for ln in open(os.path.join(ws, "train_log.jsonl"))]
    assert [ln["global_step"] for ln in log] == [1, 2]
    assert all(np.isfinite(ln["loss"]) for ln in log)
    lines = run("mine_tpu_torch.evaluate", "--checkpoint", ws,
                "--device", "cpu").stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["step"] == 2 and result["eval_examples"] == 3
    assert all(np.isfinite(v) for v in result.values())
