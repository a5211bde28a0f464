"""The port's parallel path (mine_tpu_torch/parallel/) against the JAX
package's and against one process, on the CPU over gloo.

Two spawns for the whole file, from one module-scoped fixture each: two
ranks (a plane group for the compositing ops and the plane=2 steps, a data
group for the data=2 step, the synced BatchNorm and the eval step) and four
ranks (data=2 x plane=2). Every rank-side check runs inside its spawn; the
ranks write what they computed and the tests compare it here:

  * each sharded_* function against the JAX sharded function under
    shard_map on a 2-device plane mesh (rtol 2e-5, atol 1e-5, the JAX
    tests' tolerances); the streaming render against JAX's unsharded
    streaming render (its sharded streaming path is red on this jax);
  * the gradients of a loss through each plane-sharded render against the
    port's unsharded gradients, elementwise (rtol = atol = 1e-5): an
    all-reduce that summed the replicated cotangents would be off by
    exactly the plane count, 2;
  * the synced BatchNorm against flax BatchNorm(axis_name=...) at 18 values
    a channel: outputs, running statistics and gradients;
  * 3 Adam steps at data=2, plane=2 (dense and streaming) and data=2 x
    plane=2 against the same steps in one process, in float64 (rtol 1e-4,
    atol 1e-5 on the loss dicts, the gradients and the parameters and
    buffers after each step; the eval step after them in fp32): at B=2,
    128x128 the train-mode BatchNorms see two values a channel, and two fp32
    implementations of the same step land 2.6e-4 apart in gradient norm at
    data=2, up to 17 % apart on small backbone gradient elements at
    plane=2, which Adam's first update, lr * sign(g), turns into +-lr
    (ROADMAP queue 3, the fp32 limit at test sizes). The ranks compare
    their snapshots with the one-process ones themselves (the files are
    memory-mapped), so that only the mismatches travel;
  * the rounding witness: data=2's first-step gradient in fp32 and in the
    bf16 recipe lies no farther from the float64 gradient than twice one
    process's of the same precision, so a gap between the two is rounding
    of that precision, not a fault of the path;
  * make_mesh's and host_batch_slice's errors against the JAX messages, and
    the config's parallel group.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# lr 1e-4, a tenth of the recipe's: at this size (two values a channel in
# the decoder extension's BatchNorms) the recipe's 1e-3 makes 3 Adam steps
# chaotic even in float64: two runs 7e-11 apart in the first step's
# gradients lie 1.7 apart in the third's (grad norm 4e4). At 1e-4 every
# weight still moves 1e-4 a step, ten times the state tolerance.
TINY = {"data.img_h": 128, "data.img_w": 128, "model.num_layers": 18, "model.dtype": "float32",
        "mpi.num_bins_coarse": 4, "data.name": "synthetic", "data.visible_point_count": 32,
        "data.num_workers": 0, "lr.backbone_lr": 1e-4, "lr.decoder_lr": 1e-4}
DROPOUT = {"mpi.sigma_dropout_rate": 0.1}
STREAMING = {"mpi.compositor": "streaming", "mpi.stream_chunk_planes": 1}
# the one-process references: name -> (config overrides, dtype, with an eval step)
REFERENCES = {"dense": (DROPOUT, True), "streaming": (STREAMING, False)}
# the steps of each spawn: (name, its reference, data x plane)
STEPS = {
    2: [("data2_dense", "dense", (2, 1)),
        ("plane2_dense", "dense", (1, 2)),
        ("plane2_streaming", "streaming", (1, 2))],
    4: [("data2_plane2_dense", "dense", (2, 2))],
}
GLOBAL_B = 2
# Adam steps of every sharded run held against one process
N_STEPS = 3
TOL = dict(rtol=2e-5, atol=1e-5)


# -- inputs shared by the ranks and the references --------------------------------------


def op_inputs(b=2, s=8, h=8, w=10) -> dict[str, np.ndarray]:
    """Seeded inputs of the compositing ops: an MPI, plane disparities, a
    pose and intrinsics that keep every plane in front of both cameras."""
    rng = np.random.default_rng(7)
    k = np.array([[12.0, 0, 5.0], [0, 12.0, 4.0], [0, 0, 1.0]], np.float32)
    g = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    g[:, :3, 3] = [[0.05, -0.02, 0.01], [-0.03, 0.04, 0.02]][:b]
    z = np.linspace(1.0, 4.0, s, dtype=np.float32)[None, :, None, None, None]
    xy = rng.uniform(size=(b, s, h, w, 2)).astype(np.float32) * 0.05
    return {
        "rgb": rng.uniform(size=(b, s, h, w, 3)).astype(np.float32),
        "sigma": rng.uniform(0.1, 2.0, size=(b, s, h, w, 1)).astype(np.float32),
        "alpha": rng.uniform(0.0, 1.0, size=(b, s, h, w, 1)).astype(np.float32),
        "xyz": np.concatenate([xy, np.broadcast_to(z, (b, s, h, w, 1))], -1).astype(np.float32),
        "disparity": np.tile(np.linspace(1.0, 0.1, s, dtype=np.float32), (b, 1)),
        "k": np.tile(k, (b, 1, 1)),
        "g": g,
        "target": rng.uniform(size=(b, h, w, 3)).astype(np.float32),
    }


def bn_input() -> tuple[np.ndarray, np.ndarray]:
    """(x, cotangent) of the BatchNorm check: (2, 3, 3, 3), 18 values a
    channel, one row a rank."""
    rng = np.random.default_rng(11)
    return (rng.normal(0.5, 2.0, (GLOBAL_B, 3, 3, 3)).astype(np.float32),
            rng.normal(size=(GLOBAL_B, 3, 3, 3)).astype(np.float32))


def _tensors(inp: dict, dtype=torch.float32) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=dtype) for k, v in inp.items()}


def _loss(rgb, depth, target):
    return torch.sum((rgb - target) ** 2) + 0.1 * torch.sum(depth ** 2)


GRAD_PATHS = ("src", "volume", "tgt_dense", "tgt_streaming")


def render_for_grads(path: str, t: dict, axis=None):
    """The loss of one render and the inputs it is differentiated in;
    `axis` None renders unsharded with the port's own ops, else this rank's
    plane block through the sharded op."""
    from mine_tpu_torch.ops import mpi_render as mr
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.parallel import plane_sharding as ps

    k_inv = inverse_3x3(t["k"])
    if path == "volume":
        wrt = [t["rgb"], t["sigma"], t["xyz"]]
        rgb, depth, *_ = (mr.plane_volume_rendering(*wrt) if axis is None
                          else ps.sharded_plane_volume_rendering(*wrt, axis))
    elif path == "src":
        wrt = [t["rgb"], t["sigma"], t["disparity"]]
        rgb, depth, *_ = (mr.render_src(*wrt, k_inv) if axis is None
                          else ps.sharded_render_src(*wrt, k_inv, axis))
    else:
        wrt = [t["rgb"], t["sigma"], t["disparity"]]
        args = (*wrt, t["g"], k_inv, t["k"])
        if path == "tgt_dense":
            rgb, depth, _ = (mr.render_tgt_rgb_depth(*args) if axis is None
                             else ps.sharded_render_tgt_rgb_depth(*args, axis))
        else:
            rgb, depth, _ = (mr.render_tgt_rgb_depth_streaming(*args, chunk_planes=2)
                             if axis is None
                             else ps.sharded_render_tgt_streaming(*args, axis, chunk_planes=2))
    return _loss(rgb, depth, t["target"]), wrt


# -- the rank side -------------------------------------------------------------------------


def _plane_block(x: np.ndarray, index: int, size: int) -> np.ndarray:
    s = x.shape[1] // size
    return x[:, index * s:(index + 1) * s]


def _sharded_ops(axis) -> dict:
    """Every sharded compositing op on this rank's plane block."""
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.parallel import plane_sharding as ps

    full = op_inputs()
    blk = {k: (_plane_block(v, axis.index, axis.size)
               if k in ("rgb", "sigma", "alpha", "xyz", "disparity") else v)
           for k, v in full.items()}
    t = _tensors(blk)
    k_inv = inverse_3x3(t["k"])
    out = {}
    out["alpha_composition"] = ps.sharded_alpha_composition(t["alpha"], t["rgb"], axis)
    for inf in (False, True):
        out[f"volume_{inf}"] = ps.sharded_plane_volume_rendering(t["rgb"], t["sigma"], t["xyz"],
                                                                 axis, inf)
    out["weighted_sum_mpi"] = ps.sharded_weighted_sum_mpi(t["rgb"], t["xyz"], t["alpha"], axis)
    out["render_alpha"] = ps.sharded_render(t["rgb"], t["alpha"], t["xyz"], axis, use_alpha=True)
    out["render_src"] = ps.sharded_render_src(t["rgb"], t["sigma"], t["disparity"], k_inv, axis)
    out["weighted_sum_src"] = ps.sharded_weighted_sum_src(t["rgb"], t["disparity"], t["alpha"],
                                                          axis)
    tgt = (t["rgb"], t["sigma"], t["disparity"], t["g"], k_inv, t["k"])
    out["render_tgt_dense"] = ps.sharded_render_tgt_rgb_depth(*tgt, axis)
    out["render_tgt_streaming"] = ps.sharded_render_tgt_streaming(*tgt, axis, chunk_planes=2)
    alpha_tgt = (t["rgb"], t["alpha"], *tgt[2:])
    out["render_tgt_streaming_alpha"] = ps.sharded_render_tgt_streaming(
        *alpha_tgt, axis, use_alpha=True, chunk_planes=2)
    # the plane compositor's three fields, as the loss graph calls them
    comp = ps.plane_compositor(axis, streaming=True, chunk_planes=2)
    out["compositor_tgt"] = comp.render_tgt_rgb_depth(*tgt, use_alpha=False,
                                                      is_bg_depth_inf=False)
    out = {k: [x.detach() for x in v] for k, v in out.items()}
    grads = {}
    for path in GRAD_PATHS:
        tt = {k: v.clone().requires_grad_(k in ("rgb", "sigma", "xyz", "disparity"))
              for k, v in _tensors(blk).items()}
        loss, wrt = render_for_grads(path, tt, axis)
        grads[path] = [g.detach() for g in torch.autograd.grad(loss, wrt)]
    return {"ops": out, "grads": grads}


def _synced_bn(group, rank: int) -> dict:
    from mine_tpu_torch.models.norm import BatchNorm2d

    x, cot = bn_input()
    bn = BatchNorm2d(3, group).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.0, 1.5]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    xt = torch.tensor(x[rank:rank + 1]).requires_grad_()
    y = bn(xt)
    gx, gw, gb = torch.autograd.grad(y, [xt, bn.weight, bn.bias], torch.tensor(cot[rank:rank + 1]))
    # the parameter gradients sum over the ranks, as the step sums them
    for g in (gw, gb):
        torch.distributed.all_reduce(g, group=group)
    return {"y": y.detach(), "gx": gx, "gw": gw, "gb": gb,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def train_steps(ref: str, shape: tuple[int, int] | None, on_step, n_steps: int = N_STEPS,
                dtype=torch.float64, model_dtype: str = "float32") -> dict:
    """n_steps Adam steps of REFERENCES[ref] from seeded weights on the
    synthetic batches (a new batch each step), in float64 unless `dtype`
    says otherwise: on this rank of a data x plane mesh, or with `shape`
    None in one process on the global batch of 2. After step i (from 0)
    `on_step(i, model)` sees the gradients (in .grad) and the parameters
    and buffers after the update. Returns each step's loss dict, this rank's
    rows and, for a reference with an eval, an fp32 eval step's loss dict on
    the last batch with its second example padded out."""
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.data.synthetic import SyntheticDataset
    from mine_tpu_torch.models.mpi import init_weights
    from mine_tpu_torch.parallel.data_parallel import make_plan, model_groups
    from mine_tpu_torch.parallel.mesh import host_batch_slice, make_mesh
    from mine_tpu_torch.training.optimizer import make_optimizer
    from mine_tpu_torch.training.step import build_model, eval_step, train_step

    over, with_eval = REFERENCES[ref]
    n_data = 1 if shape is None else shape[0]
    cfg = Config().replace(**{**TINY, **over, "model.dtype": model_dtype,
                              "data.per_gpu_batch_size": GLOBAL_B // n_data})
    plan, groups, rows = None, {}, None
    if shape is not None:
        mesh = make_mesh(*shape)
        plan, groups = make_plan(cfg, mesh), model_groups(mesh)
        rows = host_batch_slice(mesh, GLOBAL_B)
    model = build_model(cfg, **groups)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dtype).train()
    optimizer, scheduler = make_optimizer(cfg, model, 10)
    ds = SyntheticDataset(128, 128, GLOBAL_B, steps_per_epoch=n_steps, n_points=32,
                          host_slice=rows)
    gen, dgen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    result = {"loss": [], "eval": {}, "rows": rows}
    for i, batch in enumerate(ds.epoch(1)):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        out = train_step(cfg, model, optimizer, scheduler,
                         {k: v.to(dtype) for k, v in batch.items()}, gen, dgen, plan=plan)
        result["loss"].append({k: float(v) for k, v in out.items()})
        on_step(i, model)
    if with_eval:
        weight = torch.tensor([1.0, 0.0])
        if rows is not None:
            weight = weight[rows[0]:rows[0] + rows[1]]
        ev, _ = eval_step(cfg, model.float(), dict(batch, eval_weight=weight),
                          torch.Generator().manual_seed(2), plan=plan)
        result["eval"] = {k: float(v) for k, v in ev.items()}
    return result


def snapshot(model) -> dict[str, dict[str, torch.Tensor]]:
    """The gradients, and the parameters and buffers, as they stand."""
    return {"grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def step_mismatches(model, want: dict, label: str) -> list[str]:
    """Where the model's gradients, parameters and buffers leave `want` (a
    snapshot) by more than rtol 1e-4, atol 1e-5: one message a tensor."""
    got, bad = snapshot(model), []
    for group in ("grads", "state"):
        for key, w in want[group].items():
            try:
                torch.testing.assert_close(got[group][key], w, rtol=1e-4, atol=1e-5)
            except AssertionError as exc:
                bad.append(f"{label} {group} {key}: {exc}")
    return bad


def compare_steps(ref: str, shape: tuple[int, int], ref_path: str, label: str) -> dict:
    """This rank's float64 steps of REFERENCES[ref] on `shape`, each held,
    here on the rank, against the one-process snapshots saved at ref_path
    (memory-mapped: every rank reads the same pages)."""
    want = torch.load(ref_path, mmap=True, weights_only=True)
    bad: list[str] = []
    result = train_steps(ref, shape, lambda i, model: bad.extend(
        step_mismatches(model, want[i], f"{label} step {i + 1}")))
    return dict(result, mismatches=bad)


def witness_grads(shape: tuple[int, int] | None) -> dict[str, torch.Tensor]:
    """The first step's gradients of the dense reference in fp32 and in the
    bf16 recipe (bf16 autocast network, fp32 parameters), flat, float64."""
    out = {}
    for name, model_dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        def keep(i, model, name=name):
            out[name] = torch.cat([p.grad.detach().double().reshape(-1)
                                   for p in model.parameters()])
        train_steps("dense", shape, keep, n_steps=1, dtype=torch.float32,
                    model_dtype=model_dtype)
    return out


def worker(world: int, rank: int, port: int, out_dir: str, ref_paths: dict[str, str]) -> None:
    import torch.distributed as dist

    from mine_tpu_torch.parallel.mesh import make_mesh
    from mine_tpu_torch.parallel.plane_sharding import PlaneAxis

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    result = {}
    if world == 2:
        result.update(_sharded_ops(PlaneAxis.of(make_mesh(1, 2).group("plane"))))
        result["bn"] = _synced_bn(make_mesh(2, 1).group("data"), rank)
    result["steps"] = {name: compare_steps(ref, shape, ref_paths[ref], f"{name} rank {rank}")
                       for name, ref, shape in STEPS[world]}
    if world == 2:
        # all-reduced gradients: every rank holds the mesh's
        result["witness"] = witness_grads((2, 1))
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test side -------------------------------------------------------------------------

# ranks fork from one server that has imported torch and the port once
PRELOAD = ["torch", "torch.distributed", "torch._dynamo", "mine_tpu_torch.training.loop",
           "mine_tpu_torch.parallel.data_parallel"]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(fn, args, log_path):
    """A rank's entry: its output to a log file, any error to the log."""
    import traceback

    with open(log_path, "w") as log:
        sys.stdout = sys.stderr = log
        try:
            fn(*args)
        except BaseException:
            traceback.print_exc()
            log.flush()
            os._exit(1)


def spawn_ranks(fn, world: int, *args, timeout_s: float = 300.0,
                expect_exit: int | None = 0) -> list[str]:
    """fn(world, rank, port, *args) on `world` gloo ranks forked from a
    forkserver; their logs. Each rank must exit with `expect_exit` (None:
    any code)."""
    import multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    port = _free_port()
    with tempfile.TemporaryDirectory() as log_dir:
        logs = [os.path.join(log_dir, f"rank{r}.log") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(fn, (world, r, port, *args), logs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout_s)
        texts = [open(path).read() if os.path.exists(path) else "" for path in logs]
        for p in procs:
            if p.is_alive():
                p.kill()
        for rank, (p, text) in enumerate(zip(procs, texts)):
            if expect_exit is not None:
                assert p.exitcode == expect_exit, \
                    f"rank {rank} of {world} exited {p.exitcode}:\n{text[-3000:]}"
        return texts


def spawn(world: int, ref_paths: dict[str, str]) -> list[dict]:
    """Run `worker` on `world` gloo ranks; their results, by rank."""
    with tempfile.TemporaryDirectory() as out_dir:
        spawn_ranks(worker, world, out_dir, ref_paths)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


@pytest.fixture(scope="module")
def references():
    """The one-process steps every sharded step is held against: each
    reference's loss dicts and eval here, its snapshots after each step in
    a file the ranks read ("path"; ~0.8 GB each, removed after the module),
    and the dense reference's first-step gradients, flat ("first_grads")."""
    with tempfile.TemporaryDirectory() as out_dir:
        refs = {}
        for name in REFERENCES:
            snaps = []

            def keep(i, model, snaps=snaps):
                snaps.append(snapshot(model))
            refs[name] = train_steps(name, None, keep)
            refs[name]["path"] = os.path.join(out_dir, f"{name}.pt")
            torch.save(snaps, refs[name]["path"])
            if name == "dense":
                refs[name]["first_grads"] = torch.cat(
                    [g.reshape(-1) for g in snaps[0]["grads"].values()])
            del snaps
        yield refs


@pytest.fixture(scope="module")
def one_process_witness():
    """witness_grads in one process."""
    return witness_grads(None)


@pytest.fixture(scope="module")
def two_ranks(references):
    return spawn(2, {name: r["path"] for name, r in references.items()})


@pytest.fixture(scope="module")
def four_ranks(references):
    return spawn(4, {name: r["path"] for name, r in references.items()})


def _jax_plane_ops() -> dict:
    """The JAX package's sharded ops under shard_map on 2 plane devices, and
    its unsharded streaming render, on op_inputs(), in one jit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from mine_tpu.ops import inverse_3x3, render_tgt_rgb_depth_streaming
    from mine_tpu.parallel import plane_sharding as jps
    from mine_tpu.utils.jax_compat import shard_map

    t = {k: jnp.asarray(v) for k, v in op_inputs().items()}
    k_inv = inverse_3x3(t["k"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("plane",))
    sp, rp = P(None, "plane"), P()
    specs = {"alpha_composition": (rp, sp), "weighted_sum_mpi": (rp, rp),
             "render_alpha": (rp, rp, sp, sp), "render_src": (rp, rp, sp, sp),
             "weighted_sum_src": (rp, rp), "render_tgt_dense": (rp, rp, rp),
             "volume_False": (rp, rp, sp, sp), "volume_True": (rp, rp, sp, sp)}

    def sharded(rgb, sigma, alpha, xyz, disparity):
        out = {
            "alpha_composition": jps.sharded_alpha_composition(alpha, rgb, "plane"),
            "weighted_sum_mpi": jps.sharded_weighted_sum_mpi(rgb, xyz, alpha, "plane"),
            "render_alpha": jps.sharded_render(rgb, alpha, xyz, "plane", use_alpha=True),
            "render_src": jps.sharded_render_src(rgb, sigma, disparity, k_inv, "plane"),
            "weighted_sum_src": jps.sharded_weighted_sum_src(rgb, disparity, alpha, "plane"),
            "render_tgt_dense": jps.sharded_render_tgt_rgb_depth(
                rgb, sigma, disparity, t["g"], k_inv, t["k"], "plane"),
        }
        for inf in (False, True):
            out[f"volume_{inf}"] = jps.sharded_plane_volume_rendering(rgb, sigma, xyz, "plane",
                                                                      inf)
        return out

    def everything(rgb, sigma, alpha, xyz, disparity):
        out = shard_map(sharded, mesh=mesh, in_specs=(sp,) * 5, out_specs=specs)(
            rgb, sigma, alpha, xyz, disparity)
        tgt = (disparity, t["g"], k_inv, t["k"])
        out["render_tgt_streaming"] = render_tgt_rgb_depth_streaming(rgb, sigma, *tgt,
                                                                     chunk_planes=2)
        out["render_tgt_streaming_alpha"] = render_tgt_rgb_depth_streaming(
            rgb, alpha, *tgt, use_alpha=True, chunk_planes=2)
        return out

    out = jax.jit(everything)(t["rgb"], t["sigma"], t["alpha"], t["xyz"], t["disparity"])
    out["compositor_tgt"] = out["render_tgt_streaming"]
    return {k: [np.asarray(x) for x in v] for k, v in out.items()}


# outputs each rank holds whole (the composites) and per plane block (weights)
_LOCAL_OUTPUTS = {"alpha_composition": (1,), "render_alpha": (2, 3), "render_src": (2, 3),
                  "volume_False": (2, 3), "volume_True": (2, 3)}


def test_sharded_ops_match_jax_sharded_ops(two_ranks):
    """Every sharded_* function against the JAX package's, on the same
    inputs split over 2 plane ranks; the composites agree on both ranks,
    the per-plane outputs concatenate to the JAX sharded arrays."""
    want = _jax_plane_ops()
    for name, jax_out in want.items():
        local = _LOCAL_OUTPUTS.get(name, ())
        for i, w in enumerate(jax_out):
            tol = dict(TOL)
            if name == "volume_True" and i == 1:
                # bg-inf depth adds (1 - weights_sum) * 1000 (the JAX test's 5e-4)
                tol["atol"] = 5e-4
            if i in local:
                got = np.concatenate([r["ops"][name][i].numpy() for r in two_ranks], axis=1)
                np.testing.assert_allclose(got, w, err_msg=f"{name}[{i}]", **tol)
            else:
                for rank, r in enumerate(two_ranks):
                    np.testing.assert_allclose(r["ops"][name][i].numpy(), w,
                                               err_msg=f"{name}[{i}] rank {rank}", **tol)


@pytest.mark.parametrize("path", GRAD_PATHS)
def test_plane_sharded_grads_match_dense_elementwise(two_ranks, path):
    """Gradients through each plane-sharded render equal the unsharded
    render's, elementwise (rtol = atol = 1e-5); a replicated all-reduce whose
    backward summed the ranks' identical cotangents would double them."""
    t = {k: v.requires_grad_(k in ("rgb", "sigma", "xyz", "disparity"))
         for k, v in _tensors(op_inputs()).items()}
    loss, wrt = render_for_grads(path, t)
    want = [g.numpy() for g in torch.autograd.grad(loss, wrt)]
    for i, w in enumerate(want):
        got = np.concatenate([r["grads"][path][i].numpy() for r in two_ranks], axis=1)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5, err_msg=f"{path} d{i}")
        assert np.abs(w).max() > 1e-3  # the comparison is not of zeros


def test_synced_batchnorm_matches_flax_axis_name(two_ranks):
    """BatchNorm2d over a 2-rank group against flax BatchNorm(axis_name=)
    under shard_map: 18 values a channel, one row a rank; outputs, the
    running statistics (biased variance) and the gradients."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from mine_tpu.utils.jax_compat import shard_map

    x, cot = bn_input()
    xn, cn = np.transpose(x, (0, 2, 3, 1)), np.transpose(cot, (0, 2, 3, 1))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, axis_name="data")
    params = {"scale": jnp.asarray([0.5, 1.0, 1.5]), "bias": jnp.asarray([0.1, -0.2, 0.3])}
    stats = {"mean": jnp.zeros(3), "var": jnp.ones(3)}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def fwd_bwd(xx, cc):
        def f(x_):
            return bn.apply({"params": params, "batch_stats": stats}, x_, mutable=["batch_stats"])

        y, vjp_fn, upd = jax.vjp(f, xx, has_aux=True)
        return y, vjp_fn(cc)[0], upd["batch_stats"]

    y, gx, new_stats = jax.jit(shard_map(
        fwd_bwd, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P())))(jnp.asarray(xn), jnp.asarray(cn))
    # the affine parameters' gradients, from flax's normalised values
    x_hat = (np.asarray(y) - np.asarray(params["bias"])) / np.asarray(params["scale"])
    gp = {"scale": np.sum(cn * x_hat, axis=(0, 1, 2)), "bias": np.sum(cn, axis=(0, 1, 2))}
    to_nchw = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))  # noqa: E731
    got_y = np.concatenate([r["bn"]["y"].numpy() for r in two_ranks])
    got_gx = np.concatenate([r["bn"]["gx"].numpy() for r in two_ranks])
    np.testing.assert_allclose(got_y, to_nchw(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_gx, to_nchw(gx), rtol=1e-5, atol=1e-5)
    for r in two_ranks:
        np.testing.assert_allclose(r["bn"]["gw"].numpy(), np.asarray(gp["scale"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["bn"]["gb"].numpy(), np.asarray(gp["bias"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["bn"]["running_mean"].numpy(),
                                   np.asarray(new_stats["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["bn"]["running_var"].numpy(),
                                   np.asarray(new_stats["var"]), rtol=1e-5, atol=1e-6)


def _assert_steps_match(got: dict, want: dict, label: str) -> None:
    """Every step's loss dict and the eval's at rtol 1e-4, atol 1e-5, and no
    mismatch the rank found in its gradients, parameters and buffers."""
    assert len(got["loss"]) == len(want["loss"]) == N_STEPS
    for i, (g, w) in enumerate(zip(got["loss"], want["loss"])):
        for key, value in w.items():
            assert g[key] == pytest.approx(value, rel=1e-4, abs=1e-5), \
                f"{label} step {i + 1} {key}"
    assert got["eval"].keys() == want["eval"].keys()
    for key, value in want["eval"].items():
        assert got["eval"][key] == pytest.approx(value, rel=1e-4, abs=1e-5), \
            f"{label} eval {key}"
    assert not got["mismatches"], "\n".join(got["mismatches"][:5])


@pytest.mark.parametrize("name,ref", [(name, ref) for name, ref, _ in STEPS[2]])
def test_two_rank_step_matches_one_process(two_ranks, references, name, ref):
    """data=2, plane=2 dense and plane=2 streaming, with sigma dropout on
    the dense ones: every rank's loss dict, gradients, parameters and
    BatchNorm buffers after each of 3 Adam steps equal the one-process
    steps on the global batch of 2; data=2's eval step after them, with
    one example padded out, too."""
    for rank, r in enumerate(two_ranks):
        _assert_steps_match(r["steps"][name], references[ref], f"{name} rank {rank}")
    if name.startswith("data2"):
        assert [r["steps"][name]["rows"] for r in two_ranks] == [(0, 1), (1, 1)]


def test_data_by_plane_step_matches_one_process(four_ranks, references):
    """data=2 x plane=2 on four ranks: the encoder's BatchNorm syncs over the
    data group, the decoder's over all four; each of 3 steps equals one
    process's."""
    for rank, r in enumerate(four_ranks):
        _assert_steps_match(r["steps"]["data2_plane2_dense"], references["dense"],
                            f"data2_plane2 rank {rank}")
    assert [r["steps"]["data2_plane2_dense"]["rows"] for r in four_ranks] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_data_parallel_gradient_gap_is_rounding(two_ranks, references, one_process_witness,
                                                precision):
    """Where data=2's first-step gradient leaves the one-process gradient in
    fp32 and in the bf16 recipe, it is rounding of the same scale as the
    one-process run's own: the data=2 gradient lies no farther from the
    float64 gradient (the exact step, which data=2 equals to 1e-4 above)
    than twice the one-process gradient of the same precision does. In fp32
    that is sharp: both lie within 1 % of the exact gradient (data=2
    closer), where a sum dropped or doubled would be 100 % off. In bf16 at
    this size (two values a channel in the decoder extension's BatchNorms)
    both lie more than their own length away (1.3 and 1.8 here), and two
    bf16 runs part by as much: a gradient-norm gap of tens of percent
    between bf16 runs is that rounding."""
    exact = references["dense"]["first_grads"]
    one = one_process_witness[precision]
    two = two_ranks[0]["witness"][precision]

    def rel(g):
        return float(torch.linalg.vector_norm(g - exact) / torch.linalg.vector_norm(exact))

    assert rel(two) <= 2.0 * rel(one), (precision, rel(two), rel(one))
    # the comparison is not of equal vectors: rounding shows in both
    assert rel(one) > 1e-6 and rel(two) > 1e-6


def _k5_scene(s: int):
    """A seeded MPI of s planes, its disparities and a pose (the plain K5's
    inputs at a small size)."""
    from mine_tpu_torch.ops.geometry import inverse_3x3

    gen = torch.Generator().manual_seed(3)
    n, h, w = 2, 12, 20
    rgb = torch.rand((n, s, h, w, 3), generator=gen)
    sigma = torch.rand((n, s, h, w, 1), generator=gen) * 3
    k = torch.tensor([[14.0, 0, w / 2], [0, 14.0, h / 2], [0, 0, 1]]).expand(n, 3, 3)
    g = torch.eye(4).repeat(n, 1, 1)
    g[:, :3, 3] = torch.tensor([[0.08, -0.03, 0.05], [-0.05, 0.02, -0.1]])
    disparity = torch.linspace(1.0, 0.1, s)[None].repeat(n, 1)
    return rgb, sigma, disparity, (g, inverse_3x3(k), k)


def test_k5_plain_without_a_halo_is_the_background_form_bit_for_bit():
    """Without a halo the plain K5 computes what it computed before the halo
    existed: the same coordinates and the background's distance on the last
    plane, op for op (torch.equal)."""
    from mine_tpu_torch.ops import mpi_render as mr
    from mine_tpu_torch.ops.geometry import apply_3x3, homogeneous_pixel_grid
    from mine_tpu_torch.ops.kernels import warp as kw

    rgb, sigma, disparity, pose = _k5_scene(6)
    mats = mr.streaming_matrices(disparity, *pose)
    h_src_tgt, xyz_m, xyz_t = mats
    n, s, h, w = rgb.shape[0], rgb.shape[1], rgb.shape[2], rgb.shape[3]
    # the form before the halo (composite_operands as it was)
    grid = homogeneous_pixel_grid(h, w, rgb.device)
    homo = apply_3x3(h_src_tgt.reshape(n * s, 3, 3), grid[..., 0], grid[..., 1])
    hz = homo[..., 2]
    hz = torch.where(hz.abs() < 1.0e-8, torch.where(hz < 0, -1.0e-8, 1.0e-8), hz)
    x, y = homo[..., 0] / hz, homo[..., 1] / hz
    xyz = apply_3x3(xyz_m.reshape(n * s, 3, 3), x.clamp(0.0, w - 1.0), y.clamp(0.0, h - 1.0))
    xyz = (xyz + xyz_t.repeat_interleave(s, dim=0)[:, None, None]).reshape(n, s, h, w, 3)
    d = xyz[:, 1:] - xyz[:, :-1]
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    dist = torch.cat([dist, torch.full_like(xyz[:, -1:, ..., 2], kw.BG_DIST)], dim=1)
    payload = torch.cat([rgb, sigma], dim=-1).permute(0, 1, 4, 2, 3)
    before = kw.warp_composite_plain(payload, x.reshape(n, s, h, w), y.reshape(n, s, h, w),
                                     dist, xyz[..., 2])
    assert torch.equal(kw.warp_composite(rgb, sigma, *mats), before)


def test_k5_plain_halo_composes_two_plane_blocks_into_the_whole():
    """The front block of an MPI composited with the back block's first
    plane as its halo, then the back block with the background, combine
    with the over operator (sums a + T_a b, transmittance T_a T_b) into the
    whole MPI's composite (rtol = atol = 1e-5)."""
    from mine_tpu_torch.ops import mpi_render as mr
    from mine_tpu_torch.ops.kernels import warp as kw

    rgb, sigma, disparity, pose = _k5_scene(8)
    whole = kw.warp_composite(rgb, sigma, *mr.streaming_matrices(disparity, *pose))
    front = kw.warp_composite(rgb[:, :4], sigma[:, :4], *mr.streaming_matrices(
        disparity[:, :4], *pose, halo_depth=1.0 / disparity[:, 4]))
    back = kw.warp_composite(rgb[:, 4:], sigma[:, 4:], *mr.streaming_matrices(
        disparity[:, 4:], *pose))
    t_front = front[:, 6:7]
    combined = torch.cat([front[:, :5] + t_front * back[:, :5], front[:, 5:6] + back[:, 5:6],
                          t_front * back[:, 6:7]], dim=1)
    torch.testing.assert_close(combined, whole, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(front, kw.warp_composite(rgb[:, :4], sigma[:, :4],
                                                       *mr.streaming_matrices(disparity[:, :4],
                                                                              *pose)))


def test_mesh_errors_are_the_jax_messages(monkeypatch):
    """make_mesh's checks and messages over 8 ranks (the count faked: the
    checks run before any group is made) against the JAX make_mesh on the
    8 virtual devices; host_batch_slice's split and its error."""
    from mine_tpu.parallel import mesh as jmesh
    from mine_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "process_count", lambda: 8)
    for kwargs in ({"data_parallel": 3, "plane_parallel": 3}, {"data_parallel": 8,
                                                               "fsdp_parallel": 2},
                   {"plane_parallel": 0}, {"plane_parallel": 3}, {"data_parallel": 2}):
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(**kwargs)
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(**kwargs)
        assert str(got.value) == str(want.value), kwargs
    monkeypatch.undo()
    one = tmesh.make_mesh()
    assert one.shape == {"data": 1, "fsdp": 1, "plane": 1} and one.device_mesh is None
    assert tmesh.mesh_shape_str(one) == "1x1x1" and tmesh.data_replica_count(one) == 1
    assert tmesh.host_batch_slice(one, 6) == (0, 6)
    mesh = tmesh.Mesh({"data": 4, "fsdp": 1, "plane": 2}, rank=5)
    assert (mesh.coordinate("data"), mesh.coordinate("plane")) == (2, 1)
    assert tmesh.host_batch_slice(mesh, 8) == (4, 2)
    with pytest.raises(ValueError, match="global batch 6 does not split evenly over 4 "
                                         r"processes \(this host owns 1 rows\)"):
        tmesh.host_batch_slice(mesh, 6)
    with pytest.raises(ValueError, match="this host owns 2"):
        tmesh.shard_batch(mesh, {"x": np.zeros((3, 2))}, "cpu", global_rows=8)
    got = tmesh.shard_batch(mesh, {"x": np.arange(8.0)[:, None]}, "cpu", global_rows=8)
    assert got["x"][:, 0].tolist() == [4.0, 5.0]


def test_parallel_config_group_is_loaded_and_refused_by_name():
    """The parallel group, which the port dropped on load before this slice,
    reaches the config with the JAX loader's values; zero1, non-empty rules
    and an fsdp axis are refused by name, the data and plane axes are not."""
    from mine_tpu.config import load_config as jax_load_config
    from mine_tpu_torch.config import load_config, unsupported_training_options

    default = os.path.join(REPO, "mine_tpu", "configs", "default.yaml")
    over = {"parallel.zero1": True, "parallel.rules": ["^params/decoder/ = replicated"],
            "parallel.zero1_min_size": 64}
    cfg, jcfg = load_config(default, overrides=over), jax_load_config(default, overrides=over)
    assert (cfg.parallel.zero1, cfg.parallel.rules, cfg.parallel.zero1_min_size) == \
        (jcfg.parallel.zero1, tuple(jcfg.parallel.rules), jcfg.parallel.zero1_min_size)
    problems = unsupported_training_options(cfg)
    assert len(problems) == 2 and "parallel.zero1" in problems[0] \
        and "parallel.rules" in problems[1]
    fsdp = unsupported_training_options(load_config(default, overrides={"mesh.fsdp_parallel": 2}))
    assert len(fsdp) == 1 and "mesh.fsdp_parallel" in fsdp[0] and "queue 1 item 6" in fsdp[0]
    assert unsupported_training_options(load_config(default, overrides={
        "mesh.data_parallel": 2, "mesh.plane_parallel": 4})) == []
    with pytest.raises(KeyError, match="unknown config key"):
        load_config(default, overrides={"parallel.no_such_key": 1})
