"""Eval, LPIPS and the .npz warm start, against the JAX package.

The eval step: the port's eval_step against JAX's make_eval_step on one B=2
batch whose second slot is a pad (eval_weight [1, 0]), with LPIPS on at
scale 0 from one seeded random weight file that both packages load
(tools/convert_lpips.py's layout). TINY configuration of
tests/test_torch_train.py (128x128, ResNet-18, S=4, fixed disparities),
eval-mode BatchNorm with non-trivial running statistics. Every entry of the
dict agrees at the loss tolerance of tests/test_torch_train.py (rel 2e-4,
abs 1e-6: fp32 networks in two frameworks), eval_examples exactly; the pad
slot contributes nothing.

LPIPS alone: the port's lpips against mine_tpu.losses.lpips on seeded
images, per image and batch-mean, rtol 1e-4 (thirteen fp32 convolutions);
the metric is 0 with no weights and a set but missing path raises.

The warm start: a Trainer with training.pretrained_checkpoint_path at a
flat .npz of JAX variables loads them exactly (the converter's inverse),
strictly over training.pretrained_subtrees, and its eval matches JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from mine_tpu.config import Config as JaxConfig
from mine_tpu.data import make_synthetic_batch
from mine_tpu.losses import load_lpips_params as jax_load_lpips
from mine_tpu.losses.lpips import lpips as jax_lpips
from mine_tpu.training import step as jstep
from mine_tpu.training.state import TrainState
from mine_tpu_torch.config import Config
from mine_tpu_torch.losses.lpips import _TAP_CHANNELS, _VGG16_CFG, load_lpips_params, lpips
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.training import step as tstep

B = 2
TINY = {
    "data.name": "llff", "data.img_h": 128, "data.img_w": 128,
    "data.per_gpu_batch_size": B, "model.num_layers": 18, "model.dtype": "float32",
    "mpi.num_bins_coarse": 4, "mpi.fix_disparity": True,
    "loss.smoothness_lambda_v1": 0.5, "loss.smoothness_lambda_v2": 0.01,
    "loss.smoothness_gmin": 0.8,
}


def write_lpips_npz(path, seed: int = 0) -> None:
    """Seeded random LPIPS-VGG weights in the converted layout: conv kernels
    HWIO, non-negative lin weights (C,)."""
    rng = np.random.default_rng(seed)
    arrays, c_in, i = {}, 3, 0
    for c in _VGG16_CFG:
        if c == "M":
            continue
        bound = 1.0 / np.sqrt(9 * c_in)
        arrays[f"conv{i}_w"] = rng.uniform(-bound, bound, (3, 3, c_in, c)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
        c_in, i = c, i + 1
    for j, c in enumerate(_TAP_CHANNELS):
        arrays[f"lin{j}_w"] = rng.uniform(0.0, 2.0 / c, c).astype(np.float32)
    np.savez(path, **arrays)


def _random_variables(seed: int) -> dict:
    jcfg = JaxConfig().replace(**TINY)
    model = jstep.build_model(jcfg)
    x = np.zeros((1, 128, 128, 3), np.float32)
    d = np.linspace(1.0, 0.1, 4, dtype=np.float32)[None]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, d, False))
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
            val[3] = 2.0
        flat[key] = val.astype(np.float32)
    return flatten_variables(traverse_util.unflatten_dict(flat, sep="/"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    lpips_path = str(tmp / "lpips.npz")
    write_lpips_npz(lpips_path)
    variables = _random_variables(seed=21)
    batch = make_synthetic_batch(B, 128, 128, n_points=32, seed=4)
    batch.pop("src_depth")
    batch["eval_weight"] = np.array([1.0, 0.0], np.float32)
    jcfg = JaxConfig().replace(**TINY)
    model = jstep.build_model(jcfg)
    tree = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in variables.items()},
                                        sep="/")
    state = TrainState.create(tree["params"], tree["batch_stats"],
                              optax.sgd(1.0).init(tree["params"]), jax.random.PRNGKey(0))
    eval_step = jax.jit(jstep.make_eval_step(jcfg, model, jax_load_lpips(lpips_path)))
    want, _ = eval_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(1))
    return {"variables": variables, "batch": batch, "lpips_path": lpips_path, "tmp": tmp,
            "want": {k: float(v) for k, v in want.items()}}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_eval_matches(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    assert float(got["eval_examples"]) == want["eval_examples"] == 1.0
    assert want["lpips_tgt"] > 0.0
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(v, rel=2e-4, abs=1e-6), k


def test_eval_step_matches_jax_with_a_pad_slot(setup):
    model = MPINetwork(num_layers=18, multires=10)
    model.load_state_dict(jax_variables_to_torch(setup["variables"], 18))
    cfg = Config().replace(**TINY)
    params = load_lpips_params(setup["lpips_path"])
    got, viz = tstep.eval_step(cfg, model, _torch_batch(setup["batch"]), lpips_params=params)
    _assert_eval_matches(got, setup["want"])
    assert not model.training and viz["tgt_imgs_syn"].shape == (B, 128, 128, 3)
    # the pad slot carries no weight: the genuine example alone gives the same
    alone = {k: v[:1] for k, v in _torch_batch(setup["batch"]).items()}
    alone.pop("eval_weight")
    one, _ = tstep.eval_step(cfg, model, alone, lpips_params=params)
    for k in got:
        assert float(got[k]) == pytest.approx(float(one[k]), rel=1e-5, abs=1e-7), k


def test_per_example_losses_average_to_the_batch_losses(setup):
    """per_example entries are (B,) vectors whose mean is the scalar entry."""
    model = MPINetwork(num_layers=18, multires=10)
    model.load_state_dict(jax_variables_to_torch(setup["variables"], 18))
    model.eval()
    cfg = Config().replace(**TINY)
    batch = _torch_batch(setup["batch"])
    batch.pop("eval_weight")
    with torch.no_grad():
        _, per, _ = tstep.loss_fcn(cfg, model, batch, per_example=True)
        _, mean, _ = tstep.loss_fcn(cfg, model, batch)
    assert set(per) == set(mean)
    for k in per:
        assert per[k].shape == (B,), k
        assert float(per[k].mean()) == pytest.approx(float(mean[k]), rel=1e-5, abs=1e-7), k


def test_lpips_matches_jax(setup):
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(3, 48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    jp = jax_load_lpips(setup["lpips_path"])
    tp = load_lpips_params(setup["lpips_path"])
    for size_average in (False, True):
        want = np.asarray(jax_lpips(jp, jnp.asarray(a), jnp.asarray(b), size_average))
        got = lpips(tp, torch.from_numpy(a), torch.from_numpy(b), size_average).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert float(lpips(tp, torch.from_numpy(a), torch.from_numpy(a))) == 0.0
    assert load_lpips_params("") is None
    with pytest.raises(FileNotFoundError, match="LPIPS"):
        load_lpips_params(str(setup["tmp"] / "missing.npz"))


def test_npz_warm_start_matches_the_jax_forward(setup):
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.training.loop import Trainer

    path = setup["tmp"] / "mine.npz"
    np.savez(path, **setup["variables"])
    cfg = Config().replace(**{**TINY, "data.name": "synthetic",
                              "training.pretrained_checkpoint_path": str(path),
                              "training.lpips_weights_path": setup["lpips_path"]})
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(build_dataset(cfg, "train", B), max_steps=0)
    want = jax_variables_to_torch(setup["variables"], 18)
    got = trainer.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want), "warm start did not load exactly"
    assert trainer.global_step == 0 and not trainer.optimizer.state  # the optimizer starts fresh
    out, _ = tstep.eval_step(cfg, trainer.model, _torch_batch(setup["batch"]),
                             lpips_params=trainer.lpips_params)
    _assert_eval_matches(out, setup["want"])


def test_npz_warm_start_is_strict(setup):
    from mine_tpu_torch.models.convert import load_npz_subtrees

    path = setup["tmp"] / "partial.npz"
    partial = dict(setup["variables"])
    partial.pop("params/decoder/dispconv_0/Conv_0/bias")
    np.savez(path, **partial)
    with pytest.raises(KeyError, match="missing"):
        load_npz_subtrees(str(path), 18)
    backbone = {k: v for k, v in setup["variables"].items() if k.split("/")[1] == "backbone"}
    np.savez(path, **backbone)
    assert all(k.startswith("backbone.") for k in load_npz_subtrees(str(path), 18, ("backbone",)))
    with pytest.raises(ValueError, match="covers subtrees"):
        load_npz_subtrees(str(path), 18, ("backbone", "decoder"))
    np.savez(path, **setup["variables"], **{"params/head/kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="unexpected key"):
        load_npz_subtrees(str(path), 18)
