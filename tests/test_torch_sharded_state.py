"""Sharded training state in the port (parallel/rules.py layouts through
parallel/data_parallel.py, training/step.py and training/loop.py) on gloo
CPU ranks, at ResNet-18, 128x128, S=2, one example a rank, fp32.

  * Layouts change no number: 3 Adam steps under ZeRO-1 over data=2, under
    fsdp=2, and under fsdp=2 x data=2 with ZeRO-1 (and 1 step of ZeRO-1
    with training.accum_steps=2) are held against the replicated layout on
    the same batch split, in the same spawn: the loss dict bitwise, each
    parameter's update within 1e-6 of the replicated update's largest
    element (the worst leaf), the gathered Adam moments exact. These are the
    levels of tests/test_parallel.py::test_sharded_layouts_match_replicated_mesh;
    the port meets them bitwise throughout (the slices Adam steps on are
    elementwise the whole tensor's, and the gathered parameters are copies),
    which the test asserts too.
  * Each rank's resident parameter and moment bytes equal the table's
    placement_bytes and lie below the replicated figure.
  * Checkpoints are layout-free (the counterpart of
    tests/test_resilience.py::test_zero1_checkpoint_roundtrip_layout_independent):
    a one-process checkpoint restores into fsdp=2 with ZeRO-1 and gathers
    back bit-equal, with its moments truly sharded; a checkpoint that run
    saves one step later restores in one process bit-equal, and that process
    trains on from it.
"""

from __future__ import annotations

import copy
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_parallel import spawn_ranks

TINY = {"data.img_h": 128, "data.img_w": 128, "model.num_layers": 18, "model.dtype": "float32",
        "mpi.num_bins_coarse": 2, "data.name": "synthetic", "data.visible_point_count": 32,
        "data.num_workers": 0, "data.per_gpu_batch_size": 1, "lr.backbone_lr": 1e-4,
        "lr.decoder_lr": 1e-4, "parallel.zero1_min_size": 1024}
N_STEPS = 3
# name -> (data, fsdp, zero1, accum_steps, steps); each against the
# replicated run of its batch split
LAYOUTS = {
    2: {"zero1_data2": (2, 1, True, 1, N_STEPS), "fsdp2": (1, 2, False, 1, N_STEPS),
        "zero1_data2_accum2": (2, 1, True, 2, 1)},
    4: {"fsdp2_data2_zero1": (2, 2, True, 1, N_STEPS)},
}


def _cfg(data: int, fsdp: int, zero1: bool, accum: int = 1):
    from mine_tpu_torch.config import Config

    return Config().replace(**{**TINY, "mesh.data_parallel": data, "mesh.fsdp_parallel": fsdp,
                               "parallel.zero1": zero1, "training.accum_steps": accum,
                               "data.per_gpu_batch_size": accum})


def _run(cfg, steps: int) -> dict:
    """`steps` Adam steps on this rank of cfg's mesh: the loss dicts, the
    gathered parameters at the start and after each step, the gathered optimizer state and
    the resident and table bytes."""
    from mine_tpu_torch.data.synthetic import SyntheticDataset
    from mine_tpu_torch.models.mpi import init_weights
    from mine_tpu_torch.parallel import data_parallel as dp
    from mine_tpu_torch.parallel.mesh import data_replica_count, host_batch_slice, make_mesh
    from mine_tpu_torch.training.optimizer import make_optimizer
    from mine_tpu_torch.training.step import build_model, train_step

    mesh = make_mesh(cfg.mesh.data_parallel, cfg.mesh.plane_parallel, cfg.mesh.fsdp_parallel)
    model = build_model(cfg, **dp.model_groups(mesh))
    init_weights(model, torch.Generator().manual_seed(0))
    model.train()
    plan = dp.with_layout(dp.make_plan(cfg, mesh), cfg, model)
    optimizer, scheduler = make_optimizer(cfg, model, 10)
    dp.distribute_state(model, optimizer, mesh, plan.layout)
    rows = cfg.data.per_gpu_batch_size * data_replica_count(mesh)
    ds = SyntheticDataset(128, 128, rows, steps_per_epoch=steps, n_points=32,
                          host_slice=host_batch_slice(mesh, rows))
    gen, dgen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    out = {"loss": [], "params": [], "sharded": plan.layout is not None}

    def snapshot():
        out["params"].append({k: v.clone() for k, v in
                              dp.gathered_state(model, None, plan.layout, mesh)[0].items()})

    snapshot()  # the start: every step's update is compared
    for batch in ds.epoch(1):
        ld = train_step(cfg, model, optimizer, scheduler,
                        {k: torch.as_tensor(v) for k, v in batch.items()}, gen, dgen, plan=plan)
        out["loss"].append({k: v.clone() for k, v in ld.items()})
        snapshot()
    out["optimizer"] = copy.deepcopy(dp.gathered_state(model, optimizer, plan.layout, mesh)[1])
    if plan.layout is not None:
        out.update(dp.state_bytes(model, optimizer, plan.layout, mesh))
        names = {id(p): n for n, p in model.named_parameters()}
        out["moment_shapes"] = sorted({tuple(s["exp_avg"].shape) != plan.layout.shapes[names[id(p)]]
                                       for p, s in optimizer.state.items()})
    return out


def _checkpoint_roundtrip(ws: str) -> dict:
    """On fsdp=2 with ZeRO-1: restore the one-process checkpoint at step 1
    of `ws` through Trainer.fit, gather it back, then train one more step
    (rank 0 writes step 2)."""
    from mine_tpu_torch.data.synthetic import SyntheticDataset
    from mine_tpu_torch.parallel.mesh import host_batch_slice
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.loop import Trainer

    cfg = _cfg(1, 2, True).replace(**{"training.checkpoint_interval": 100,
                                      "training.eval_interval": 100})
    trainer = Trainer(cfg, ws, device="cpu")
    ds = SyntheticDataset(128, 128, 2, steps_per_epoch=4, n_points=32,
                          host_slice=host_batch_slice(trainer.mesh, 2))
    trainer.fit(ds, max_steps=1)
    saved = ckpt.load(ws, 1)
    got = trainer.state()
    mismatch = [k for k, v in saved["model"].items() if not torch.equal(got["model"][k], v)]
    for idx, entry in saved["optimizer"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            if not torch.equal(got["optimizer"]["state"][idx][m], entry[m]):
                mismatch.append(f"optimizer {idx} {m}")
    sharded_moments = sum(tuple(trainer.optimizer.state[p]["exp_avg"].shape)
                          != trainer.layout.shapes[n]
                          for n, p in trainer.model.named_parameters())
    trainer.fit(ds, max_steps=2)
    return {"mismatch": mismatch, "sharded_moments": sharded_moments}


def _compare(got: dict, want: dict) -> dict:
    """A sharded run against the replicated one: the loss dicts' keys that
    differ (bitwise), each step's worst update gap over its leaves (the
    largest |update difference| over the replicated update's largest
    element), the leaves whose parameters or gathered moments are not
    bit-equal, and the sharded run's bytes."""
    out = {"sharded": got["sharded"] and not want["sharded"],
           "loss_mismatch": [(i, k) for i, (lg, lw) in enumerate(zip(got["loss"], want["loss"]))
                             for k in lw if not torch.equal(lg[k], lw[k])],
           "worst_update": [], "param_mismatch": [], "moment_mismatch": []}
    for i in range(1, len(want["params"])):
        worst = 0.0
        for key, w in want["params"][i].items():
            if not w.is_floating_point():
                continue
            dw = w - want["params"][i - 1][key]
            dg = got["params"][i][key] - got["params"][i - 1][key]
            scale = float(dw.abs().max())
            if scale > 0:
                worst = max(worst, float((dg - dw).abs().max()) / scale)
            if not torch.equal(got["params"][i][key], w):
                out["param_mismatch"].append((i, key))
        out["worst_update"].append(worst)
    for idx, entry in want["optimizer"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            if not torch.equal(got["optimizer"]["state"][idx][m], entry[m]):
                out["moment_mismatch"].append((idx, m))
    out.update({k: got[k] for k in ("resident", "table", "replicated", "moment_shapes")})
    return out


def worker(world: int, rank: int, port: int, out_dir: str, ws: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    result, replicated = {}, {}
    for name, (data, fsdp, zero1, accum, steps) in LAYOUTS[world].items():
        got = _run(_cfg(data, fsdp, zero1, accum), steps)
        # the replicated layout on the same batch split (one run serves
        # every layout of that split)
        split = (data * fsdp, accum, steps)
        if split not in replicated:
            replicated[split] = _run(_cfg(data * fsdp, 1, False, accum), steps)
        # compared here, on the rank: only the verdicts travel
        result[name] = _compare(got, replicated[split])
    if world == 2:
        result["checkpoint"] = _checkpoint_roundtrip(ws)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _one_process_step(ws: str, max_steps: int) -> "object":
    """A one-process Trainer on `ws` (replicated) trained to max_steps."""
    from mine_tpu_torch.data.synthetic import SyntheticDataset
    from mine_tpu_torch.training.loop import Trainer

    cfg = _cfg(1, 1, False).replace(**{"data.per_gpu_batch_size": 2,
                                       "training.checkpoint_interval": 100,
                                       "training.eval_interval": 100})
    trainer = Trainer(cfg, ws, device="cpu")
    trainer.fit(SyntheticDataset(128, 128, 2, steps_per_epoch=4, n_points=32),
                max_steps=max_steps)
    return trainer


@pytest.fixture(scope="module")
def spawned():
    """Both spawns' results by world size and rank, and the checkpoint
    workspace the two-rank spawn trained on."""
    with tempfile.TemporaryDirectory() as tmp:
        ws = os.path.join(tmp, "ws")
        _one_process_step(ws, 1)  # the one-process checkpoint at step 1
        out_dirs = {world: os.path.join(tmp, f"out{world}") for world in (2, 4)}
        # the two spawns are independent: run them side by side
        with ThreadPoolExecutor(2) as pool:
            runs = [pool.submit(spawn_ranks, worker, world, out_dir, ws)
                    for world, out_dir in out_dirs.items() if not os.makedirs(out_dir)]
            for run in runs:
                run.result()
        out = {world: [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                       for r in range(world)] for world, out_dir in out_dirs.items()}
        from mine_tpu_torch.training import checkpoint as ckpt

        resumed = _one_process_step(ws, 3)  # restores the sharded run's step 2
        yield out, ckpt.load(ws, 2), resumed


CASES = [(world, name) for world, layouts in LAYOUTS.items() for name in layouts]


@pytest.mark.parametrize("world,name", CASES)
def test_sharded_layout_matches_replicated(spawned, world, name):
    """Loss bitwise; each parameter's update within 1e-6 of the largest
    replicated update of its leaf (it is bitwise, checked as well); the
    gathered moments exact; every rank agrees."""
    out, _, _ = spawned
    for rank, result in enumerate(out[world]):
        got = result[name]
        assert got["sharded"], rank
        assert got["loss_mismatch"] == [], (rank, got["loss_mismatch"])
        assert max(got["worst_update"]) <= 1e-6, (rank, got["worst_update"])
        assert got["param_mismatch"] == [], (rank, got["param_mismatch"][:5])
        assert got["moment_mismatch"] == [], (rank, got["moment_mismatch"][:5])


@pytest.mark.parametrize("world,name", CASES)
def test_resident_bytes_equal_the_table(spawned, world, name):
    """Each rank holds exactly placement_bytes of parameters and moments,
    below the replicated figure; some moments are shards."""
    out, _, _ = spawned
    for result in out[world]:
        got = result[name]
        assert got["resident"] == got["table"] < got["replicated"], \
            (got["resident"], got["table"], got["replicated"])
        assert True in got["moment_shapes"]


def test_checkpoints_are_layout_free(spawned):
    """A one-process checkpoint restored under fsdp=2 with ZeRO-1 gathers
    back bit-equal with its moments sharded; that run's step-2 checkpoint
    restores in one process bit-equal and trains on."""
    out, step2, resumed = spawned
    for result in out[2]:
        assert result["checkpoint"]["mismatch"] == []
        assert result["checkpoint"]["sharded_moments"] > 0
    assert resumed.evals == [] and resumed.global_step == 3
    # the one-process restore of step 2 (before its third step), gathered
    from mine_tpu_torch.training import checkpoint as ckpt

    assert sorted(ckpt.all_steps(resumed.workspace))[-2:] == [2, 3]
    restored = _restore_only(resumed.workspace, 2)
    for key, value in step2["model"].items():
        assert torch.equal(restored["model"][key], value), key
    for idx, entry in step2["optimizer"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(restored["optimizer"]["state"][idx][m], entry[m])
            assert tuple(entry[m].shape) == tuple(restored["model"][_name(resumed, idx)].shape)


def _name(trainer, idx: int) -> str:
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return [names[id(p)] for g in trainer.optimizer.param_groups for p in g["params"]][idx]


def _restore_only(ws: str, step: int) -> dict:
    """A one-process Trainer's state right after restoring `step`."""
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.loop import Trainer
    from mine_tpu_torch.training.optimizer import make_optimizer

    cfg = _cfg(1, 1, False)
    trainer = Trainer(cfg, None, device="cpu")
    trainer.optimizer, trainer.scheduler = make_optimizer(cfg, trainer.model, 4)
    trainer.load_state(ckpt.load(ws, step))
    return trainer.state()
