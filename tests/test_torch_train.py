"""The port's training path against the JAX package's: train-mode BatchNorm,
the loss graph per scale and summed, the gradients of every parameter, the
new BatchNorm statistics, one sgd step, and Adam with the MultiStep
schedule; then the CLI.

Configuration: the TINY one of tests/test_training.py (128x128, ResNet-18,
S=4, fp32, with both smoothness terms on), `mpi.fix_disparity: true` so that
both packages place the same planes, B=2 synthetic batches. Both networks
get the same seeded numpy weights, with non-trivial BatchNorm parameters.
The JAX side is jitted once per module (a value_and_grad of loss_fcn and one
sgd make_train_step) and shared by the tests.

Tolerances. The loss: rel 2e-4 (ROADMAP). BatchNorm statistics: rel 1e-4.
Gradients, per parameter, twice. In float64, both packages from the same
weights, batch and planes: ||g_port64 - g_jax64|| <= 1e-9 ||g_jax64||. The
JAX side runs in a subprocess with jax_enable_x64 and `jnp.float32` aliased
to float64 before the JAX package is imported: that package pins float32 in
its code (the MPI cast at models/decoder.py:168, the homography, the dtype
defaults), and the alias makes every one of those pins keep float64; the
package itself is unchanged. In float32: ||g_port - g_jax|| <= 1e-3 ||g_jax||
+ 2 e64, where e64 = ||g_port - g_port64|| is the port's own fp32 rounding. At
this size (B=2, 128x128) the train-mode BatchNorms see few values per
channel (2 at the decoder extension's 1x1 maps, 32 at the encoder's last
stage), and fp32 rounding alone moves the backbone's gradients from the
float64 ones by a median of ~1e-3 and up to 4e-3 relative, in both
packages; the float64 comparison holds the math without that slack. The reference norm is floored at 1e-4 of the
largest parameter gradient norm: the decoder convolutions that feed a
BatchNorm have biases whose true gradient is zero (the batch mean removes
them), and both packages hold only rounding noise there. The weights keep
sigma = |x| + 1e-4 away from the kink of |x| at 0 (the sigma heads' bias is
2), where a rounding-level change of x flips the sign of its gradient.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from mine_tpu.config import Config as JaxConfig
from mine_tpu.data import make_synthetic_batch
from mine_tpu.models.norm import SyncBatchNorm
from mine_tpu.training import make_optimizer as jax_make_optimizer
from mine_tpu.training import step as jstep
from mine_tpu.training.state import TrainState
from mine_tpu_torch.config import Config
from mine_tpu_torch.models.convert import (
    flatten_variables,
    jax_grads_to_torch,
    jax_variables_to_torch,
    torch_grads_to_jax,
    torch_to_jax_variables,
)
from mine_tpu_torch.models.decoder import tuple_to_str
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.models.norm import BatchNorm2d
from mine_tpu_torch.training import step as tstep
from mine_tpu_torch.training.optimizer import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "data.name": "llff", "data.img_h": 128, "data.img_w": 128,
    "data.per_gpu_batch_size": 2, "model.num_layers": 18, "model.dtype": "float32",
    "mpi.num_bins_coarse": 4, "mpi.fix_disparity": True,
    "loss.smoothness_lambda_v1": 0.5, "loss.smoothness_lambda_v2": 0.01,
    "loss.smoothness_gmin": 0.8,
}
B = 2
STEPS_PER_EPOCH = 100


def _random_variables(model, x, disparity, seed: int) -> dict:
    """Seeded numpy weights in the shape of `model`'s flax variables (shapes
    from eval_shape: no init compile)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, disparity, True))
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
    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.fixture(scope="module")
def setup():
    """Everything the JAX side computes, once: loss, loss dict, gradients,
    new BatchNorm statistics and the MPIs of the train-mode forward, and the
    new parameters of one sgd make_train_step."""
    jcfg = JaxConfig().replace(**TINY)
    model = jstep.build_model(jcfg)
    batch_np = make_synthetic_batch(B, 128, 128, n_points=32, seed=0)
    batch_np.pop("src_depth")
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    disparity = jstep.make_disparity_list(jcfg, jax.random.PRNGKey(0), B)
    variables = _random_variables(model, batch["src_img"][:1], disparity[:1], seed=5)
    params, stats = variables["params"], variables["batch_stats"]
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        total, loss_dict, _, new_stats = jstep.loss_fcn(
            jcfg, model, p, stats, batch, key, is_val=False, train=True)
        return total, (loss_dict, new_stats)

    (total, (loss_dict, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    mpis, _ = jax.jit(lambda v: model.apply(v, batch["src_img"], disparity, True,
                                            mutable=["batch_stats"]))(variables)

    sgd_cfg = jcfg.replace(**{"training.optimizer": "sgd"})
    tx = jax_make_optimizer(sgd_cfg, STEPS_PER_EPOCH)
    state = TrainState.create(params, stats, tx.init(params), key)
    new_state, sgd_dict = jax.jit(jstep.make_train_step(sgd_cfg, model, tx))(state, batch)

    as_np = lambda tree: {k: np.asarray(v) for k, v in flatten_variables(tree).items()}  # noqa: E731
    return {
        "variables": as_np(variables),
        "batch": batch_np,
        "total": float(total),
        "loss_dict": {k: float(v) for k, v in loss_dict.items()},
        "grads": as_np({"params": grads}),
        "new_stats": as_np({"batch_stats": new_stats}),
        "mpis": {s: np.asarray(m) for s, m in mpis.items()},
        "sgd_params": as_np({"params": new_state.params}),
        "sgd_loss": float(sgd_dict["loss"]),
        "sgd_grad_norm": float(sgd_dict["grad_norm"]),
    }


def _port_model(variables) -> MPINetwork:
    model = MPINetwork(num_layers=18, multires=10)
    model.load_state_dict(jax_variables_to_torch(variables, 18))
    return model.train()


def _torch_batch(batch_np):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()}


# the JAX loss and gradients in float64 (see the module docstring)
_JAX64_SCRIPT = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
jnp.float32 = jnp.float64  # before the JAX package binds its float32 pins
from flax import traverse_util
from mine_tpu.config import Config
from mine_tpu.training import step as jstep
from mine_tpu_torch.models.convert import flatten_variables

variables_path, batch_path, out_path, overrides = sys.argv[1:5]
cfg = Config().replace(**json.loads(overrides))
as64 = lambda z: {k: jnp.asarray(z[k], jnp.float64) for k in z.files}
variables = traverse_util.unflatten_dict(as64(np.load(variables_path)), sep="/")
batch = as64(np.load(batch_path))
model, key = jstep.build_model(cfg), jax.random.PRNGKey(0)

def loss_fn(p):
    return jstep.loss_fcn(cfg, model, p, variables["batch_stats"], batch, key,
                          is_val=False, train=True)[0]

total, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
disparity = jstep.make_disparity_list(cfg, key, batch["src_img"].shape[0])
grads = flatten_variables({"params": grads})
assert total.dtype == disparity.dtype == np.float64
assert all(g.dtype == np.float64 for g in grads.values())
np.savez(out_path, total=np.asarray(total), disparity=np.asarray(disparity), **grads)
"""


@pytest.fixture(scope="module")
def jax64(setup, tmp_path_factory):
    """JAX's loss, plane disparities and gradients in float64, from the same
    weights and batch as `setup`."""
    import json

    tmp = tmp_path_factory.mktemp("jax64")
    np.savez(tmp / "variables.npz", **setup["variables"])
    np.savez(tmp / "batch.npz", **setup["batch"])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-c", _JAX64_SCRIPT, str(tmp / "variables.npz"),
         str(tmp / "batch.npz"), str(tmp / "out.npz"), json.dumps(TINY)],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_run(setup, jax64):
    """One train-mode forward + backward of the port from the same weights:
    (total, loss_dict, flat JAX-layout gradients, flat new statistics, and
    the total and gradients of the same run in float64, on JAX's float64
    planes)."""
    cfg = Config().replace(**TINY)
    model = _port_model(setup["variables"])
    total, loss_dict, _ = tstep.loss_fcn(cfg, model, _torch_batch(setup["batch"]))
    total.backward()
    state = torch_to_jax_variables(model.state_dict(), 18)
    stats = {k: v for k, v in state.items() if k.startswith("batch_stats/")}
    model64 = _port_model(setup["variables"]).double()
    batch64 = {k: v.double() for k, v in _torch_batch(setup["batch"]).items()}
    total64 = tstep.loss_fcn(cfg, model64, batch64,
                             disparity=torch.from_numpy(jax64["disparity"]))[0]
    total64.backward()
    return float(total), {k: float(v) for k, v in loss_dict.items()}, \
        torch_grads_to_jax(model, 18), stats, torch_grads_to_jax(model64, 18), \
        float(total64)


def test_train_mode_batchnorm_matches_flax(rng):
    """Output and new running statistics at n = 18 values per channel, where
    the unbiased running variance would be n/(n-1) = 6 % off."""
    x = rng.normal(1.0, 2.0, size=(2, 3, 3, 5)).astype(np.float32)
    v = {"params": {"BatchNorm_0": {
            "scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
            "bias": rng.normal(0, 0.1, 5).astype(np.float32)}},
         "batch_stats": {"BatchNorm_0": {
            "mean": rng.normal(0, 0.1, 5).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}}}
    want, upd = SyncBatchNorm().apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x), True,
                                      mutable=["batch_stats"])
    bn = BatchNorm2d(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["BatchNorm_0"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["BatchNorm_0"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["BatchNorm_0"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["BatchNorm_0"]["var"]))
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    new = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), rtol=1e-4)
    unbiased = torch.nn.BatchNorm2d(5).train()
    unbiased.load_state_dict(bn.state_dict() | {
        "running_var": torch.from_numpy(v["batch_stats"]["BatchNorm_0"]["var"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["BatchNorm_0"]["mean"])})
    unbiased(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(unbiased.running_var.numpy(), np.asarray(new["var"]), rtol=1e-3)


@pytest.mark.parametrize("scale", [0, 1, 2, 3])
def test_loss_fcn_per_scale_matches_jax(setup, scale):
    """Each scale's loss graph on the same MPIs (the JAX forward's), value
    and MPI gradient, with the scale factor carried from scale 0 as
    loss_fcn carries it."""
    jcfg = JaxConfig().replace(**TINY)
    cfg = Config().replace(**TINY)
    batch_j = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    batch_t = _torch_batch(setup["batch"])
    disp_j = jstep.make_disparity_list(jcfg, jax.random.PRNGKey(0), B)
    disp_t = tstep.make_disparity_list(cfg, B)
    sf_j = sf_t = None
    if scale > 0:
        _, _, sf_j = jstep.loss_fcn_per_scale(jcfg, 0, batch_j, jnp.asarray(setup["mpis"][0]),
                                              disp_j, None, is_val=False, lpips_params=None)
        _, _, sf_t = tstep.loss_fcn_per_scale(cfg, 0, batch_t,
                                              torch.from_numpy(setup["mpis"][0]), disp_t, None)

    def jax_loss(mpi):
        ld, _, _ = jstep.loss_fcn_per_scale(jcfg, scale, batch_j, mpi, disp_j, sf_j,
                                            is_val=False, lpips_params=None)
        return ld["loss"], ld

    (want, want_dict), want_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(setup["mpis"][scale]))
    mpi = torch.from_numpy(setup["mpis"][scale].copy()).requires_grad_()
    got_dict, _, _ = tstep.loss_fcn_per_scale(cfg, scale, batch_t, mpi, disp_t, sf_t)
    got_dict["loss"].backward()
    for k, v in got_dict.items():
        np.testing.assert_allclose(float(v), float(want_dict[k]), rtol=2e-4, atol=1e-6,
                                   err_msg=f"scale {scale} {k}")
    wg = np.asarray(want_grad)
    err = np.linalg.norm(mpi.grad.numpy() - wg) / np.linalg.norm(wg)
    assert err <= 1e-4, f"scale {scale} d loss / d mpi relative L2 error {err}"


def test_loss_fcn_total_and_dict_match_jax(setup, port_run):
    total, loss_dict = port_run[:2]
    assert total == pytest.approx(setup["total"], rel=2e-4)
    assert set(loss_dict) == set(setup["loss_dict"])  # lpips_tgt included, 0 in training
    for k, v in loss_dict.items():
        assert v == pytest.approx(setup["loss_dict"][k], rel=2e-4, abs=1e-6), k


def test_per_parameter_gradients_match_jax_in_float64(jax64, port_run):
    """Both packages in float64: the loss to rel 1e-12, and every
    parameter's gradient to relative L2 1e-9 of the JAX one (its norm
    floored as in the float32 test). float64 rounding through this network
    leaves ~1e-12."""
    grads64, total64 = port_run[4], port_run[5]
    assert total64 == pytest.approx(float(jax64["total"]), rel=1e-12)
    want = {k: v for k, v in jax64.items() if k.startswith("params/")}
    assert set(grads64) == set(want)
    floor = 1e-4 * max(np.linalg.norm(g) for g in want.values())
    bad = {}
    for k, w in want.items():
        err = np.linalg.norm(grads64[k] - w) / max(np.linalg.norm(w), floor)
        if err > 1e-9:
            bad[k] = err
    assert not bad, f"{len(bad)} of {len(want)} gradients off: {sorted(bad.items())[:5]}"


def test_per_parameter_gradients_match_jax(setup, port_run):
    grads, grads64 = port_run[2], port_run[4]
    want = setup["grads"]
    assert set(grads) == set(want)
    floor = 1e-4 * max(np.linalg.norm(g) for g in want.values())
    bad = {}
    for k, w in want.items():
        own_rounding = np.linalg.norm(grads[k] - grads64[k].astype(np.float32))
        err = np.linalg.norm(grads[k] - w)
        if err > 1e-3 * max(np.linalg.norm(w), floor) + 2.0 * own_rounding:
            bad[k] = (err / np.linalg.norm(w), own_rounding / np.linalg.norm(w))
    assert not bad, f"{len(bad)} of {len(want)} gradients off: {sorted(bad.items())[:5]}"


def test_converter_carries_variables_and_gradients_both_ways(setup):
    """JAX variables -> state dict -> JAX variables is the identity; a JAX
    gradient tree lands on the port's parameter names (kernels HWIO ->
    OIHW) and comes back through the parameters' .grad unchanged. Strict:
    a missing or extra gradient raises."""
    variables = setup["variables"]
    model = _port_model(variables)
    back = torch_to_jax_variables(model.state_dict(), 18)
    assert set(back) == set(variables)
    assert all(np.array_equal(back[k], variables[k]) for k in variables)
    grads = jax_grads_to_torch(setup["grads"], 18)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    kernel = setup["grads"]["params/backbone/Conv_0/kernel"]
    assert grads["backbone.encoder.conv1.weight"][5, 2, 1, 4] == kernel[1, 4, 2, 5]
    for name, p in model.named_parameters():
        p.grad = grads[name]
    again = torch_grads_to_jax(model, 18)
    assert all(np.array_equal(again[k], setup["grads"][k]) for k in setup["grads"])
    partial = dict(setup["grads"])
    partial.pop("params/decoder/dispconv_0/Conv_0/bias")
    with pytest.raises(KeyError, match="missing"):
        jax_grads_to_torch(partial, 18)
    with pytest.raises(ValueError, match="no place"):
        jax_grads_to_torch({**setup["grads"], "params/extra/kernel": kernel}, 18)
    model.decoder.convs[tuple_to_str(("dispconv", 0))].conv.bias.grad = None
    with pytest.raises(ValueError, match="no gradient"):
        torch_grads_to_jax(model, 18)


def test_new_batchnorm_statistics_match_jax(setup, port_run):
    """Each statistic's relative L2 error <= 1e-4."""
    stats = port_run[3]
    want = setup["new_stats"]
    assert set(stats) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(stats[k] - w) / np.linalg.norm(w)
        assert err <= 1e-4, f"{k}: relative L2 error {err}"


def test_one_sgd_step_matches_make_train_step(setup, port_run):
    """The new parameters of one sgd update (L2 + LR, no moments) from the
    same weights and batch. The update p_new - p = -lr (g + wd p) is held as
    the gradients are: relative L2 1e-3 plus twice the port's own fp32
    rounding of lr g, plus one fp32 spacing of p_new per element (an update
    of 1e-5 to a parameter near 1 is resolved to ~1e-2 in fp32); the loss
    and grad_norm at 2e-4 and 1e-3."""
    cfg = Config().replace(**TINY, **{"training.optimizer": "sgd"})
    model = _port_model(setup["variables"])
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    out = tstep.train_step(cfg, model, opt, sched, _torch_batch(setup["batch"]))
    assert float(out["loss"]) == pytest.approx(setup["sgd_loss"], rel=2e-4)
    assert float(out["grad_norm"]) == pytest.approx(setup["sgd_grad_norm"], rel=1e-3)
    new = torch_to_jax_variables(model.state_dict(), 18)
    old, grads, grads64 = setup["variables"], port_run[2], port_run[4]
    lr = cfg.lr.backbone_lr
    assert cfg.lr.decoder_lr == lr
    floor = 1e-4 * max(np.linalg.norm(setup["sgd_params"][k] - old[k])
                       for k in setup["sgd_params"])
    for k, want in setup["sgd_params"].items():
        d_want, d_got = want - old[k], new[k] - old[k]
        own_rounding = lr * np.linalg.norm(grads[k] - grads64[k].astype(np.float32))
        ulp = np.linalg.norm(np.spacing(want))  # both store p_new in fp32
        err = np.linalg.norm(d_got - d_want)
        assert err <= 1e-3 * max(np.linalg.norm(d_want), floor) + 2.0 * own_rounding + ulp, \
            f"{k}: update relative L2 error {err / np.linalg.norm(d_want)}"


class _TwoGroups(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.backbone = torch.nn.Linear(3, 4)
        self.decoder = torch.nn.Linear(4, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_and_schedule_match_optax_across_epoch_boundaries(rng, optimizer):
    """Identical gradients into both optimizers for 7 updates at 2 updates an
    epoch with decays after epochs 1 and 2 (updates 2 and 4), distinct LRs
    per group: the parameters agree after every update."""
    cfg = Config().replace(**{"training.optimizer": optimizer, "lr.decay_steps": (1, 2),
                              "lr.decay_gamma": 0.5, "lr.backbone_lr": 0.01,
                              "lr.decoder_lr": 0.03, "lr.weight_decay": 0.01})
    jcfg = JaxConfig().replace(**{"training.optimizer": optimizer, "lr.decay_steps": (1, 2),
                                  "lr.decay_gamma": 0.5, "lr.backbone_lr": 0.01,
                                  "lr.decoder_lr": 0.03, "lr.weight_decay": 0.01})
    model = _TwoGroups(rng)
    opt, sched = make_optimizer(cfg, model, steps_per_epoch=2)
    names = [n for n, _ in model.named_parameters()]
    to_tree = lambda d: {  # noqa: E731
        grp: {n.split(".", 1)[1]: jnp.asarray(d[n]) for n in names if n.startswith(grp)}
        for grp in ("backbone", "decoder")}
    params = to_tree({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    tx = jax_make_optimizer(jcfg, steps_per_epoch=2)
    opt_state = tx.init(params)
    import optax

    for step in range(7):
        g = {n: rng.normal(size=p.shape).astype(np.float32) * 10 ** (step % 3 - 1)
             for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step()
        sched.step()
        updates, opt_state = tx.update(to_tree(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            grp, leaf = n.split(".", 1)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[grp][leaf]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"update {step} {n}")


def test_train_cli_runs_two_steps_on_the_cpu(tmp_path):
    """python -m mine_tpu_torch.train --device cpu on synthetic data: two
    updates, both logged with a finite loss and gradient norm."""
    import json

    overrides = {"data.name": "synthetic", "data.img_h": 128, "data.img_w": 128,
                 "data.per_gpu_batch_size": 1, "model.num_layers": 18,
                 "model.dtype": "float32", "mpi.num_bins_coarse": 2,
                 "data.visible_point_count": 16, "training.log_interval": 1}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one_torch_thread, for the CLI
    out = subprocess.run(
        [sys.executable, "-m", "mine_tpu_torch.train", "--device", "cpu",
         "--workspace", str(tmp_path / "ws"), "--max_steps", "2",
         "--extra_config", json.dumps(overrides)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in (tmp_path / "ws" / "train_log.jsonl").read_text().splitlines()]
    assert [ln["global_step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"]) for ln in lines)


def test_unhonoured_options_raise_naming_the_roadmap_item():
    """What the port does not honour yet raises, naming its ROADMAP queue 1
    item: nothing is left. A warm start from a workspace directory is
    honoured since the JAX-workspace slice (tests/test_torch_warm_start.py):
    a path that holds no checkpoint raises by name when fit() reads it, as
    the JAX package's warm start does. Accumulation, sigma
    dropout, remat, the sentinel and an .npz warm start are honoured now
    (tests/test_torch_accum.py, test_torch_remat.py,
    test_torch_checkpoint.py), the data and plane mesh axes since the
    parallel slice (tests/test_torch_parallel.py), and ZeRO-1, the rule rows
    and coarse-to-fine since the sharded-state slice
    (tests/test_torch_sharded_state.py, test_torch_c2f.py): one process
    refuses a plane or fsdp axis of 2 as the JAX mesh does, with the device
    count."""
    from mine_tpu_torch.training.loop import Trainer

    from mine_tpu_torch.data.synthetic import SyntheticDataset

    cfg = Config().replace(**TINY, **{"training.pretrained_checkpoint_path":
                                      "/nowhere/orbax_run"})
    with pytest.raises(FileNotFoundError, match="'/nowhere/orbax_run' contains no checkpoint"):
        Trainer(cfg, device="cpu").fit(SyntheticDataset(128, 128, 2, steps_per_epoch=1),
                                       max_steps=1)
    for axis in ("plane_parallel", "fsdp_parallel"):
        with pytest.raises(ValueError, match=f"{axis}=2 must divide 1 devices"):
            Trainer(Config().replace(**TINY, **{f"mesh.{axis}": 2}), device="cpu")
    for key, value in (("training.accum_steps", 2), ("mpi.sigma_dropout_rate", 0.1),
                       ("model.remat_decoder", True), ("resilience.sentinel_policy", "skip"),
                       ("parallel.zero1", True), ("mpi.num_bins_fine", 4),
                       ("parallel.rules", ("^params/decoder/ = replicated",))):
        Trainer(Config().replace(**TINY, **{key: value}), device="cpu")
    # the real dataset loaders are ported (tests/test_torch_data.py): only a
    # name no loader registers raises now, listing the registered ones
    from mine_tpu_torch.data.registry import UnknownDatasetError, build_dataset

    with pytest.raises(UnknownDatasetError, match="llff"):
        build_dataset(Config().replace(**{"data.name": "imagenet"}), "train", 1)
