"""Gradient accumulation and the sentinel's skip, the port's train_step
against the JAX package's make_train_step.

Configuration: tests/test_torch_train.py's TINY one (128x128, ResNet-18,
S=4, fixed disparities, both smoothness terms) at B=4 with
training.accum_steps 2 (two micro-batches of 2), the sgd optimizer (its
update is linear in the gradient, so the JAX gradient is read back from the
update) and resilience.sentinel_policy "skip". Both packages run in float64
from the same seeded weights and batch, with the float64 method of
tests/test_torch_train.py (the JAX side in a subprocess with x64 and
`jnp.float32` aliased to float64 before its import): the loss dict and the
gradient norm agree to rel 1e-10, every parameter's gradient to relative L2
1e-9 (the norm floored at 1e-4 of the largest, as there), every new
BatchNorm statistic to 1e-9. Then the same step on the batch with NaN
pixels: both skip the update (update_skipped 1), and the port's parameters,
optimizer state and BatchNorm buffers are bit-equal to what they were.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

from mine_tpu.config import Config as JaxConfig
from mine_tpu.data import make_synthetic_batch
from mine_tpu.training import step as jstep
from mine_tpu_torch.config import Config
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.training import step as tstep
from mine_tpu_torch.training.optimizer import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
CFG = {
    "data.name": "llff", "data.img_h": 128, "data.img_w": 128,
    "data.per_gpu_batch_size": B, "model.num_layers": 18, "model.dtype": "float32",
    "mpi.num_bins_coarse": 4, "mpi.fix_disparity": True,
    "loss.smoothness_lambda_v1": 0.5, "loss.smoothness_lambda_v2": 0.01,
    "loss.smoothness_gmin": 0.8, "training.accum_steps": 2, "training.optimizer": "sgd",
    "resilience.sentinel_policy": "skip",
}
STEPS_PER_EPOCH = 100

_JAX_STEP_SCRIPT = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
jnp.float32 = jnp.float64  # before the JAX package binds its float32 pins
from flax import traverse_util
from mine_tpu.config import Config
from mine_tpu.training import make_optimizer, step as jstep
from mine_tpu.training.state import TrainState
from mine_tpu_torch.models.convert import flatten_variables

variables_path, batch_path, out_path, overrides, steps_per_epoch = sys.argv[1:6]
cfg = Config().replace(**json.loads(overrides))
as64 = lambda z: {k: jnp.asarray(z[k], jnp.float64) for k in z.files}
variables = traverse_util.unflatten_dict(as64(np.load(variables_path)), sep="/")
batch = as64(np.load(batch_path))
model = jstep.build_model(cfg)
tx = make_optimizer(cfg, int(steps_per_epoch))
params, stats = variables["params"], variables["batch_stats"]
state = TrainState.create(params, stats, tx.init(params), jax.random.PRNGKey(0))
step = jax.jit(jstep.make_train_step(cfg, model, tx))
new, ld = step(state, batch)
old_p = flatten_variables({"params": params})
new_p = flatten_variables({"params": new.params})
out = {}
for k, p in old_p.items():  # sgd: p_new = p - lr (g + wd p)
    lr = cfg.lr.backbone_lr if k.startswith("params/backbone") else cfg.lr.decoder_lr
    out["grad/" + k] = (p - new_p[k]) / lr - cfg.lr.weight_decay * p
new_stats = flatten_variables({"batch_stats": new.batch_stats})
out.update({"stats/" + k: v for k, v in new_stats.items()})
out.update({"loss/" + k: np.asarray(v) for k, v in ld.items()})
bad_batch = dict(batch, src_img=batch["src_img"] * jnp.nan)
bad, bad_ld = step(state, bad_batch)
same = lambda a, b: all(np.array_equal(np.asarray(x), np.asarray(y))
                        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
out["bad/update_skipped"] = np.asarray(bad_ld["update_skipped"])
out["bad/loss"] = np.asarray(bad_ld["loss"])
out["bad/unchanged"] = np.asarray(same(bad.params, params) and same(bad.batch_stats, stats)
                                  and same(bad.opt_state, state.opt_state))
np.savez(out_path, **out)
"""


def _random_variables(seed: int) -> dict:
    """Seeded numpy weights in the shape of the JAX model's variables."""
    jcfg = JaxConfig().replace(**CFG)
    model = jstep.build_model(jcfg)
    x = np.zeros((1, 128, 128, 3), np.float32)
    d = np.linspace(1.0, 0.1, 4, dtype=np.float32)[None]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, d, True))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, sds in traverse_util.flatten_dict(shapes, sep="/").items():
        if key.endswith("kernel"):
            val = rng.uniform(-1, 1, sds.shape) / np.sqrt(np.prod(sds.shape[:-1]))
        elif "BatchNorm_0" in key and key.endswith(("scale", "var")):
            val = rng.uniform(0.5, 1.5, sds.shape)
        elif "BatchNorm_0" in key:
            val = rng.normal(0.0, 0.1, sds.shape)
        else:
            val = rng.uniform(-0.05, 0.05, sds.shape)
        if "dispconv" in key and key.endswith("bias"):
            val[3] = 2.0  # sigma = |x| + 1e-4 away from the kink of |x| at 0
        flat[key] = val.astype(np.float32)
    return flatten_variables(traverse_util.unflatten_dict(flat, sep="/"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    variables = _random_variables(seed=11)
    batch = make_synthetic_batch(B, 128, 128, n_points=32, seed=3)
    batch.pop("src_depth")
    tmp = tmp_path_factory.mktemp("accum")
    np.savez(tmp / "variables.npz", **variables)
    np.savez(tmp / "batch.npz", **batch)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-c", _JAX_STEP_SCRIPT, str(tmp / "variables.npz"),
         str(tmp / "batch.npz"), str(tmp / "out.npz"), json.dumps(CFG), str(STEPS_PER_EPOCH)],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        jax_out = {k: z[k] for k in z.files}
    return variables, batch, jax_out


def _port(variables):
    cfg = Config().replace(**CFG)
    model = MPINetwork(num_layers=18, multires=10)
    model.load_state_dict(jax_variables_to_torch(variables, 18))
    model = model.double()
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    return cfg, model, opt, sched


def _batch64(batch):
    return {k: torch.from_numpy(np.array(v)).double() for k, v in batch.items()}


def test_accumulated_step_matches_jax_in_float64(setup):
    from mine_tpu_torch.models.convert import torch_grads_to_jax, torch_to_jax_variables

    variables, batch, want = setup
    cfg, model, opt, sched = _port(variables)
    out = tstep.train_step(cfg, model, opt, sched, _batch64(batch))
    losses = {k[len("loss/"):]: float(v) for k, v in want.items() if k.startswith("loss/")}
    assert set(out) == set(losses)
    for k, v in losses.items():
        assert float(out[k]) == pytest.approx(v, rel=1e-10, abs=1e-13), k
    assert float(out["update_skipped"]) == 0.0
    grads = torch_grads_to_jax(model, 18)
    jgrads = {k[len("grad/"):]: v for k, v in want.items() if k.startswith("grad/")}
    assert set(grads) == set(jgrads)
    floor = 1e-4 * max(np.linalg.norm(g) for g in jgrads.values())
    bad = {k: np.linalg.norm(grads[k] - w) / max(np.linalg.norm(w), floor)
           for k, w in jgrads.items()}
    bad = {k: e for k, e in bad.items() if e > 1e-9}
    assert not bad, f"{len(bad)} of {len(jgrads)} gradients off: {sorted(bad.items())[:5]}"
    stats = {k: v for k, v in torch_to_jax_variables(model.state_dict(), 18).items()
             if k.startswith("batch_stats/")}
    for k, w in ((k[len("stats/"):], v) for k, v in want.items() if k.startswith("stats/")):
        err = np.linalg.norm(stats[k] - w) / np.linalg.norm(w)
        assert err <= 1e-9, f"{k}: relative L2 error {err}"


def test_sentinel_skips_a_nan_batch_as_jax(setup):
    variables, batch, want = setup
    assert float(want["bad/update_skipped"]) == 1.0 and bool(want["bad/unchanged"])
    assert not np.isfinite(float(want["bad/loss"]))
    cfg, model, opt, sched = _port(variables)
    tstep.train_step(cfg, model, opt, sched, _batch64(batch))  # optimizer state exists
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = [{k: v.clone() for k, v in s.items()} for s in opt.state.values()]
    lr_before = [g["lr"] for g in opt.param_groups]
    bad = _batch64(batch)
    bad["src_img"] = bad["src_img"] * float("nan")
    out = tstep.train_step(cfg, model, opt, sched, bad)
    assert float(out["update_skipped"]) == 1.0 and not np.isfinite(float(out["loss"]))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before), "parameters or buffers moved"
    assert [g["lr"] for g in opt.param_groups] == lr_before
    assert sched.last_epoch == 1  # the schedule did not advance either
    for s_before, s_after in zip(opt_before, opt.state.values()):
        assert all(torch.equal(v, s_after[k]) for k, v in s_before.items())


def test_sentinel_off_reports_no_skip_and_applies_the_update(setup):
    variables, batch, _ = setup
    cfg, model, opt, sched = _port(variables)
    cfg = cfg.replace(**{"resilience.sentinel_policy": "off", "training.accum_steps": 1})
    p0 = next(model.parameters()).detach().clone()
    out = tstep.train_step(cfg, model, opt, sched, _batch64(batch))
    assert float(out["update_skipped"]) == 0.0 and "grad_norm" in out
    assert not torch.equal(p0, next(model.parameters()))


def test_accum_steps_must_divide_the_batch(setup):
    from mine_tpu_torch.training.loop import Trainer

    variables, batch, _ = setup
    cfg, model, opt, sched = _port(variables)
    with pytest.raises(ValueError, match="must divide"):
        tstep.train_step(cfg.replace(**{"training.accum_steps": 3}), model, opt, sched,
                         _batch64(batch))
    with pytest.raises(ValueError, match="must divide data.per_gpu_batch_size"):
        Trainer(cfg.replace(**{"training.accum_steps": 3}), device="cpu")
