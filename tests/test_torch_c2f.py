"""Coarse-to-fine plane placement in the port against the JAX package, at
128x128, ResNet-18, S = 2 coarse + 2 fine planes, B=2, fp32, fixed coarse
disparities; the fine draws are the JAX package's jax.random.uniform
numbers, fed to the port.

  * sample_pdf and merge_fine_disparity: atol 1e-6, degenerate intervals
    (zero-weight bins) included.
  * forward_coarse_to_fine in train and eval mode: the MPIs at 4 scales
    (rtol = atol = 1e-4), the merged disparities (atol 1e-6) and, in train
    mode, the BatchNorm running statistics after both passes (relative L2
    1e-4 each, as tests/test_torch_train.py holds them).
  * One coarse-to-fine training step's gradients in float64, per parameter
    to relative L2 1e-9, as tests/test_torch_train.py holds the one-pass
    step (the JAX side in a float64 subprocess).
  * Under plane=2 on two gloo ranks: the eval forward with the dense
    compositor against the JAX dense forward, at the tolerances of
    tests/test_parallel.py::test_plane_sharded_coarse_to_fine_matches_dense
    (merged disparities rtol = atol = 1e-5, MPIs rtol 1e-4, atol 2e-4); one
    float64 train step with the streaming compositor against the port's own
    one-process step (loss dict and gradient norm rtol 1e-9): JAX's
    plane-sharded streaming path is red on this jax (ROADMAP queue 3), so
    streaming is held to the port alone.
  * VideoGenerator and a RenderEngine coarse-to-fine bucket against
    predict_blended_mpi_c2f_fn (MPI atol 1e-4, disparities atol 1e-6), and
    the engine's frames against the generator's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mine_tpu.config import Config as JaxConfig
from mine_tpu.data import make_synthetic_batch
from mine_tpu.inference import video as jvideo
from mine_tpu.models.mpi import merge_fine_disparity as jax_merge
from mine_tpu.ops import inverse_3x3 as jax_inverse_3x3
from mine_tpu.ops.sampling import sample_pdf as jax_sample_pdf
from mine_tpu.training import step as jstep
from mine_tpu_torch.config import Config
from mine_tpu_torch.models.convert import (
    flatten_variables,
    jax_variables_to_torch,
    torch_grads_to_jax,
    torch_to_jax_variables,
)
from mine_tpu_torch.models.mpi import merge_fine_disparity
from mine_tpu_torch.ops.geometry import inverse_3x3
from mine_tpu_torch.ops.sampling import sample_pdf
from mine_tpu_torch.training import step as tstep
from tests.test_torch_model import random_jax_variables
from test_torch_parallel import spawn_ranks
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 128
S, S_FINE, B = 2, 2, 2
TINY = {"data.name": "llff", "data.img_h": H, "data.img_w": W, "model.num_layers": 18,
        "model.dtype": "float32", "mpi.num_bins_coarse": S, "mpi.num_bins_fine": S_FINE,
        "mpi.fix_disparity": True, "loss.smoothness_lambda_v1": 0.5,
        "loss.smoothness_lambda_v2": 0.01, "loss.smoothness_gmin": 0.8}
# the loss key; its second split is the fine key (mine_tpu/training/step.py loss_fcn)
KEY = jax.random.PRNGKey(0)


def _fine_u(key, rows: int, dtype=jnp.float32) -> np.ndarray:
    """The uniforms JAX's sample_pdf draws from `key` for (rows, 1, S_FINE)."""
    return np.array(jax.random.uniform(key, (rows, 1, S_FINE), dtype=dtype))


@pytest.fixture(scope="module")
def setup():
    """The JAX side, in one jit: forward_coarse_to_fine in train and eval
    mode and predict_blended_mpi_c2f_fn, from seeded weights; and the
    float64 step's subprocess, started first."""
    jcfg = JaxConfig().replace(**TINY)
    model = jstep.build_model(jcfg)
    batch = make_synthetic_batch(B, H, W, n_points=32, seed=0)
    batch.pop("src_depth")
    variables = random_jax_variables(model, jnp.zeros((1, H, W, 3)), jnp.ones((1, S)), seed=3)
    tmp = tempfile.TemporaryDirectory()
    proc = _start_jax64(flatten_variables(jax.tree.map(np.asarray, variables)), batch, tmp.name)
    image = np.random.default_rng(5).integers(0, 256, (H, W, 3), dtype=np.uint8)
    img = jvideo.prepare_image(image, H, W)
    k = jnp.asarray(jvideo.fov_intrinsics(H, W))[None]
    key_fine = jax.random.split(KEY, 3)[1]

    @jax.jit
    def everything(v, src, k_src):
        out = {}
        for train in (True, False):
            mpis, disp, stats = jstep.forward_coarse_to_fine(
                jcfg, model, v["params"], v["batch_stats"], src, jax_inverse_3x3(k_src),
                key_disparity=KEY, key_fine=key_fine, train=train)
            out[train] = (mpis, disp, stats)
        return out, jvideo.predict_blended_mpi_c2f_fn(jcfg, v, img, k)

    fwd, predicted = everything(variables, jnp.asarray(batch["src_img"]),
                                jnp.asarray(batch["k_src"]))
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    yield {
        "variables": flatten_variables(as_np(variables)), "batch": batch, "image": image,
        "fwd": {train: (as_np(m), np.asarray(d), flatten_variables({"batch_stats": as_np(st)}))
                for train, (m, d, st) in fwd.items()},
        "predicted": as_np(predicted),
        "u": _fine_u(key_fine, B), "u_predict": _fine_u(jax.random.PRNGKey(1), 1),
        "jax64": (proc, tmp.name),
    }
    if proc.poll() is None:
        proc.kill()
    proc.communicate()
    tmp.cleanup()


def _port_model(flat, dtype=torch.float32, train=True):
    cfg = Config().replace(**TINY)
    model = tstep.build_model(cfg)
    model.load_state_dict(jax_variables_to_torch(flat, 18))
    return model.to(dtype).train(train)


def _batch(batch_np, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in batch_np.items()}


def test_sample_pdf_and_merge_match_jax():
    """Random PDFs and degenerate ones (zero-weight bins, a one-hot PDF):
    the same samples from the same uniforms, and the same sorted merge."""
    rng = np.random.default_rng(0)
    values = np.sort(rng.uniform(0.01, 1.0, (3, 2, 8)), axis=-1)[..., ::-1].astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (3, 2, 8)).astype(np.float32)
    weights[0, 0, 2:5] = 0.0  # flat CDF stretches: degenerate intervals
    weights[1, 1] = 0.0
    weights[1, 1, 3] = 1.0  # a one-hot PDF
    weights[2, 0] = 0.0  # all zero: every interval degenerate
    for n_samples, seed in ((5, 1), (16, 2)):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_sample_pdf(key, jnp.asarray(values), jnp.asarray(weights),
                                         n_samples))
        u = np.array(jax.random.uniform(key, (3, 2, n_samples)))
        got = sample_pdf(torch.from_numpy(values.copy()), torch.from_numpy(weights), n_samples,
                         u=torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the degenerate rows really took the midpoint branch
    assert np.isfinite(got).all()
    disp = np.ascontiguousarray(values[:, 0])
    w = weights[:, 0]
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_merge(key, jnp.asarray(disp), jnp.asarray(w), 6))
    got = merge_fine_disparity(torch.from_numpy(disp), torch.from_numpy(w).requires_grad_(), 6,
                               u=torch.from_numpy(_u(key, 3, 6))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(np.diff(got, axis=1) <= 0)


def _u(key, rows, n):
    return np.array(jax.random.uniform(key, (rows, 1, n)))


@pytest.mark.parametrize("train", [True, False])
def test_forward_coarse_to_fine_matches_jax(setup, train):
    """MPIs at every scale, the merged list, and (train mode) the BatchNorm
    statistics after the coarse and the fine pass."""
    want_mpis, want_disp, want_stats = setup["fwd"][train]
    cfg = Config().replace(**TINY)
    model = _port_model(setup["variables"], train=train)
    batch = _batch(setup["batch"])
    disparity = tstep.make_disparity_list(cfg, B)
    with torch.no_grad():
        mpis, disp = tstep.forward_coarse_to_fine(
            cfg, model, batch["src_img"], inverse_3x3(batch["k_src"]), disparity,
            fine_u=torch.from_numpy(setup["u"]))
    np.testing.assert_allclose(disp.numpy(), want_disp, rtol=0, atol=1e-6)
    assert disp.shape == (B, S + S_FINE)
    assert sorted(mpis) == sorted(int(s) for s in want_mpis) == [0, 1, 2, 3]
    for scale, mpi in mpis.items():
        np.testing.assert_allclose(mpi.numpy(), want_mpis[scale], rtol=1e-4, atol=1e-4,
                                   err_msg=f"scale {scale}")
    stats = {k: v for k, v in torch_to_jax_variables(model.state_dict(), 18).items()
             if k.startswith("batch_stats/")}
    assert set(stats) == set(want_stats)
    moved = 0
    for key, want in want_stats.items():
        err = np.linalg.norm(stats[key] - want) / np.linalg.norm(want)
        assert err <= 1e-4, f"{key}: relative L2 error {err}"
        moved += not np.array_equal(want, setup["variables"][key])
    assert (moved > 0) == train


# -- plane=2 -----------------------------------------------------------------------------


def _train_step(flat, batch_np, u, plan=None, compositor="dense", mesh=None):
    """One float64 Adam step of the coarse-to-fine config: the loss dict."""
    from mine_tpu_torch.parallel.data_parallel import model_groups
    from mine_tpu_torch.training.optimizer import make_optimizer

    cfg = Config().replace(**TINY, **{"mpi.compositor": compositor,
                                      "mpi.stream_chunk_planes": 1,
                                      "mesh.plane_parallel": 1 if plan is None else 2})
    model = tstep.build_model(cfg, **({} if mesh is None else model_groups(mesh)))
    model.load_state_dict(jax_variables_to_torch(flat, 18))
    model = model.double().train()
    optimizer, scheduler = make_optimizer(cfg, model, 10)
    out = tstep.train_step(cfg, model, optimizer, scheduler, _batch(batch_np, torch.float64),
                           plan=plan, fine_u=torch.from_numpy(u).double())
    return {k: float(v) for k, v in out.items()}


def plane_worker(world: int, rank: int, port: int, in_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from mine_tpu_torch.parallel.data_parallel import make_plan
    from mine_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    inp = torch.load(in_path, weights_only=False)
    mesh = make_mesh(1, 2)
    result = {}
    cfg = Config().replace(**TINY, **{"mesh.plane_parallel": 2})
    model = _port_model(inp["variables"], train=False)
    batch = _batch(inp["batch"])
    with torch.no_grad():
        mpis, disp = tstep.forward_coarse_to_fine(
            cfg, model, batch["src_img"], inverse_3x3(batch["k_src"]),
            tstep.make_disparity_list(cfg, B), fine_u=torch.from_numpy(inp["u"]),
            plan=make_plan(cfg, mesh))
    result["eval"] = (mpis[0], disp)
    scfg = cfg.replace(**{"mpi.compositor": "streaming", "mpi.stream_chunk_planes": 1})
    result["streaming"] = _train_step(inp["variables"], inp["batch"], inp["u"],
                                      make_plan(scfg, mesh), "streaming", mesh)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def plane_ranks(setup):
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.pt")
        torch.save({k: setup[k] for k in ("variables", "batch", "u")}, in_path)
        spawn_ranks(plane_worker, 2, in_path, tmp)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]


def test_plane_sharded_coarse_to_fine_matches_jax_dense(setup, plane_ranks):
    """The two ranks' plane blocks of the eval forward, joined, against the
    JAX dense forward; every rank merged the same list."""
    want_mpis, want_disp, _ = setup["fwd"][False]
    got_disp = torch.cat([r["eval"][1] for r in plane_ranks], dim=1).numpy()
    got_mpi = torch.cat([r["eval"][0] for r in plane_ranks], dim=1).numpy()
    assert got_disp.shape == (B, S + S_FINE)
    np.testing.assert_allclose(got_disp, want_disp, rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(got_disp, axis=1) < 0)
    np.testing.assert_allclose(got_mpi, want_mpis[0], rtol=1e-4, atol=2e-4)


def test_plane_sharded_streaming_coarse_to_fine_step_matches_one_process(setup, plane_ranks):
    """One float64 step at plane=2 with the streaming compositor against
    the same step in one process: the loss dict and the gradient norm, on
    both ranks."""
    want = _train_step(setup["variables"], setup["batch"], setup["u"], compositor="streaming")
    for rank in plane_ranks:
        got = rank["streaming"]
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-9, abs=1e-12), key


# -- serving ---------------------------------------------------------------------------------


def test_video_generator_and_engine_bucket_match_predict_blended_mpi_c2f(setup, monkeypatch):
    """VideoGenerator with the JAX fine draws fed equals
    predict_blended_mpi_c2f_fn; a RenderEngine coarse-to-fine bucket (its
    predict given the same draws) caches the same MPI and merged planes
    under the coarse key and renders the generator's frames."""
    from mine_tpu_torch.inference import video
    from mine_tpu_torch.serving import engine as engine_mod
    from mine_tpu_torch.serving.engine import RenderEngine

    want_rgb, want_sigma, want_disp = setup["predicted"]
    cfg = Config().replace(**TINY)
    state = jax_variables_to_torch(setup["variables"], 18)
    u = torch.from_numpy(setup["u_predict"])
    gen = video.VideoGenerator(cfg, state, setup["image"], device="cpu", fine_u=u)
    np.testing.assert_allclose(gen.disparity.numpy(), want_disp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gen.mpi_rgb.numpy(), want_rgb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gen.mpi_sigma.numpy(), want_sigma, rtol=1e-4, atol=1e-4)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1, 0, 3] = 0.05
    rgb, disp = gen.render_poses(poses)

    real = engine_mod.predict_blended_mpi_c2f
    monkeypatch.setattr(engine_mod, "predict_blended_mpi_c2f",
                        lambda *a, **kw: real(*a, fine_u=u, **kw))
    engine = RenderEngine(cfg, state, device="cpu")
    entry = engine.predict(setup["image"])
    assert entry.bucket == (H, W, S) and engine.bucket().num_planes == S + S_FINE
    np.testing.assert_allclose(entry.disparity.numpy(), gen.disparity.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(entry.mpi_rgb.numpy(), gen.mpi_rgb.numpy(), rtol=0, atol=1e-6)
    got_rgb, got_disp = engine.render(entry, poses)
    np.testing.assert_allclose(got_rgb, rgb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_disp, disp, rtol=1e-4, atol=1e-6)


# the JAX loss and gradients of a coarse-to-fine step in float64
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
b = batch["src_img"].shape[0]
disparity = jstep.make_disparity_list(cfg, key, b)
u = jax.random.uniform(jax.random.split(key, 3)[1], (b, 1, cfg.mpi.num_bins_fine),
                       dtype=jnp.float64)
grads = flatten_variables({"params": grads})
assert total.dtype == disparity.dtype == u.dtype == np.float64
np.savez(out_path, total=np.asarray(total), disparity=np.asarray(disparity), u=np.asarray(u),
         **grads)
"""


def _start_jax64(variables: dict, batch: dict, tmp: str) -> subprocess.Popen:
    """The float64 JAX step in a subprocess, started early: it compiles for
    most of a minute while the other tests run (the last test waits)."""
    np.savez(os.path.join(tmp, "variables.npz"), **variables)
    np.savez(os.path.join(tmp, "batch.npz"), **batch)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    return subprocess.Popen(
        [sys.executable, "-c", _JAX64_SCRIPT, os.path.join(tmp, "variables.npz"),
         os.path.join(tmp, "batch.npz"), os.path.join(tmp, "out.npz"), json.dumps(TINY)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_one_coarse_to_fine_step_gradients_match_jax_in_float64(setup):
    """Both packages in float64 from the same weights, batch, coarse planes
    and fine draws: the loss to rel 1e-10 and every parameter's gradient to
    relative L2 1e-9 (the norm floored at 1e-4 of the largest)."""
    proc, tmp = setup["jax64"]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(os.path.join(tmp, "out.npz")) as z:
        jax64 = {k: z[k] for k in z.files}
    cfg = Config().replace(**TINY)
    model = _port_model(setup["variables"], torch.float64)
    total, _, _ = tstep.loss_fcn(cfg, model, _batch(setup["batch"], torch.float64),
                                 disparity=torch.from_numpy(jax64["disparity"]),
                                 fine_u=torch.from_numpy(jax64["u"]))
    total.backward()
    assert float(total.detach()) == pytest.approx(float(jax64["total"]), rel=1e-10)
    grads = torch_grads_to_jax(model, 18)
    want = {k: v for k, v in jax64.items() if k.startswith("params/")}
    assert set(grads) == set(want)
    floor = 1e-4 * max(np.linalg.norm(g) for g in want.values())
    bad = {k: err for k, w in want.items()
           if (err := np.linalg.norm(grads[k] - w) / max(np.linalg.norm(w), floor)) > 1e-9}
    assert not bad, f"{len(bad)} of {len(want)} gradients off: {sorted(bad.items())[:5]}"
