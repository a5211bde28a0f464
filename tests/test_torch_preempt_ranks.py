"""Preemption and the emergency checkpoint on several ranks
(mine_tpu_torch/training/loop.py, resilience/preempt.py,
training/checkpoint.py), on gloo CPU ranks at ResNet-18, 128x128, S=3, one
example a rank, trained in float64 through Trainer.fit.

  * Preemption: under fsdp=2, ZeRO-1 over data=2 and replicated data=2 the
    chaos seam SIGTERMs rank 1 alone after step 2 (under data=2 a SIGUSR2
    after step 1 as well). The guard only records a signal; at the step
    boundary the ranks all-reduce their requests, so both save step 1
    together and go on, then both save step 2 together and end with the
    SIGTERM's own exit (killed by signal 15), rank 0 although it was never
    signalled. The log ends at step 2; the saved step 2 equals
    the state one process reaches after the same two steps, and one process
    resuming from it for a third step equals the uninterrupted run's third
    step. Both at the float64 tolerances of tests/test_torch_parallel.py
    (rtol 1e-4, atol 1e-5, lr 1e-4: a rank sees one example of the two).
  * Emergency: under fsdp=2 with a checkpoint every step, rank 1 raises
    after step 2 (preempt_exit) before step 2's checkpoint; rank 0's gather
    for that checkpoint then fails. Neither starts a collective: each
    writes the shards it holds to checkpoints/2-r<rank>of2 with its
    integrity sidecar, and step 2 counts once both verify. Reassembled, it
    equals bit for bit the fsdp=2 preemption run's gathered step 2 (the same
    computation); one process resumes from it (another layout) for a step
    that equals the uninterrupted run's. With rank 1's file missing, or
    rank 0's corrupt, step 2 does not count and the latest step is 1.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_parallel import spawn_ranks

TINY = {"data.img_h": 128, "data.img_w": 128, "model.num_layers": 18, "model.dtype": "float32",
        "mpi.num_bins_coarse": 3, "data.name": "synthetic", "data.visible_point_count": 32,
        "data.num_workers": 0, "lr.backbone_lr": 1e-4, "lr.decoder_lr": 1e-4,
        "training.checkpoint_interval": 100, "training.eval_interval": 100,
        "parallel.zero1_min_size": 1024, "training.log_interval": 1}
LAYOUTS = {"fsdp2": {"mesh.data_parallel": 1, "mesh.fsdp_parallel": 2},
           "zero1_data2": {"mesh.data_parallel": 2, "parallel.zero1": True},
           "data2": {"mesh.data_parallel": 2}}
PREEMPT = "sigusr2@step=1,sigterm@step=2"
EMERGENCY = "preempt_exit@step=2"
N_STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-5)


def _float64(trainer) -> None:
    """Train `trainer` in float64: its model doubled, every batch copied
    to the device as float64 (the loop's batch_to_device)."""
    from mine_tpu_torch.training import loop

    trainer.model.double()
    loop.batch_to_device = lambda batch, device: {
        k: torch.as_tensor(np.asarray(v)).to(device, torch.float64) for k, v in batch.items()}


def _dataset(trainer):
    from mine_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(128, 128, 2, steps_per_epoch=4, n_points=32,
                            host_slice=trainer.host_slice)


def _config(over: dict, ranks: int):
    from mine_tpu_torch.config import Config

    return Config().replace(**{**TINY, **over, "data.per_gpu_batch_size": 2 // ranks})


def worker(world: int, rank: int, port: int, ws: str, over: dict, faults: str) -> None:
    """One rank's Trainer.fit of N_STEPS steps, `faults` installed on rank 1."""
    import torch.distributed as dist

    from mine_tpu_torch.resilience import chaos
    from mine_tpu_torch.training.loop import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    if rank == 1:
        chaos.install(faults)
    trainer = Trainer(_config(over, world), ws, device="cpu")
    _float64(trainer)
    trainer.fit(_dataset(trainer), max_steps=N_STEPS)
    dist.destroy_process_group()


def _state(trainer) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _reference() -> list[dict[str, torch.Tensor]]:
    """One process, the global batch of 2, N_STEPS steps: the model's state
    after each."""
    from mine_tpu_torch.training.loop import Trainer

    trainer = Trainer(_config({}, 1), None, device="cpu")
    _float64(trainer)
    snaps, step = [], trainer.step

    def recorded(batch):
        out = step(batch)
        snaps.append(_state(trainer))
        return out

    trainer.step = recorded
    trainer.fit(_dataset(trainer), max_steps=N_STEPS)
    return snaps


def _resume(ws: str) -> dict[str, torch.Tensor]:
    """One process resuming `ws` for the rest of N_STEPS: its final state."""
    from mine_tpu_torch.training.loop import Trainer

    trainer = Trainer(_config({}, 1), ws, device="cpu")
    _float64(trainer)
    trainer.fit(_dataset(trainer), max_steps=N_STEPS)
    assert trainer.global_step == N_STEPS
    return _state(trainer)


def _mismatches(got: dict, want: dict) -> list[str]:
    bad = []
    for key, w in want.items():
        try:
            torch.testing.assert_close(got[key].to(w.dtype), w, **TOL)
        except AssertionError as exc:
            bad.append(f"{key}: {str(exc)[:200]}")
    return bad


def _train_log_steps(ws: str) -> list[int]:
    with open(os.path.join(ws, "train_log.jsonl")) as fh:
        return [json.loads(ln)["global_step"] for ln in fh]


def _preempted(ws: str, reference: list) -> dict:
    """What a preempted run left: its steps, last-good pointer and log, and
    how its step 2 and a one-process resume's step 3 lie from the
    reference's."""
    from mine_tpu_torch.training import checkpoint as ckpt

    out = {"steps": ckpt.all_steps(ws), "last_good": ckpt.last_good_step(ws),
           "logged": _train_log_steps(ws),
           "step2": _mismatches(ckpt.load(ws, 2)["model"], reference[1])}
    out["resumed"] = _mismatches(_resume(ws), reference[2])
    return out


def _emergency(ws: str, gathered_ws: str, reference: list) -> dict:
    """The emergency run's per-rank files, checked before its one-process
    resume: which verify, which steps count, the reassembled step 2 against
    the fsdp=2 preemption run's gathered step 2 (keys that differ at all),
    and with rank 1's file moved away or rank 0's corrupted, which steps
    count and what load(step 2) raises."""
    from mine_tpu_torch.training import checkpoint as ckpt

    root = os.path.join(ws, "checkpoints")
    names = [ckpt.shard_dir_name(2, rank, 2) for rank in range(2)]
    out = {"files": [os.path.exists(os.path.join(root, n, ckpt.SHARD_FILE)) for n in names],
           "committed_dir": os.path.exists(os.path.join(root, "2")),
           "steps": ckpt.all_steps(ws), "latest": ckpt.latest_step(ws)}
    for name in names:
        ckpt.verify_checkpoint_integrity(ws, name, require_sidecar=True)
    shard = torch.load(os.path.join(root, names[1], ckpt.SHARD_FILE), weights_only=True)
    full, gathered = ckpt.load(ws, 2), ckpt.load(gathered_ws, 2)
    sharded = [n for n, (dim, axes) in shard["layout"]["params"].items() if axes]
    out["sharded_params"] = len(sharded)
    out["shard_smaller"] = all(shard["model"][n].shape != full["model"][n].shape
                               for n in sharded)
    diff = [k for k, v in gathered["model"].items() if not torch.equal(full["model"][k], v)]
    diff += [(i, m) for i, entry in gathered["optimizer"]["state"].items()
             for m in ("exp_avg", "exp_avg_sq", "step")
             if not torch.equal(full["optimizer"]["state"][i][m], entry[m])]
    diff += [k for k in ("global_step", "scheduler") if full[k] != gathered[k]]
    diff += [g for g in ("disparity", "dropout")
             if not torch.equal(full["generators"][g], gathered["generators"][g])]
    out["vs_gathered"] = diff
    del shard, full, gathered
    # rank 1's file missing, then rank 0's corrupt: step 2 no longer counts
    moved = os.path.join(ws, "rank1_away")
    os.replace(os.path.join(root, names[1]), moved)
    out["missing"] = _incomplete(ws)
    os.replace(moved, os.path.join(root, names[1]))
    path = os.path.join(root, names[0], ckpt.SHARD_FILE)
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0xFF]))
    out["corrupt"] = _incomplete(ws)
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        fh.write(byte)
    out["resumed"] = _mismatches(_resume(ws), reference[2])
    return out


def _incomplete(ws: str) -> dict:
    from mine_tpu_torch.training import checkpoint as ckpt

    try:
        ckpt.load(ws, 2)
        raised = None
    except ckpt.CheckpointCorrupt as exc:
        raised = str(exc)
    return {"steps": ckpt.all_steps(ws), "latest": ckpt.latest_step(ws), "raised": raised}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process reference, and beside it the three preemption spawns
    and the emergency spawn, two at a time, each followed by its checks and
    its one-process resume; the workspaces go after them (a float64
    checkpoint of this model is 0.4 GB)."""
    from mine_tpu_torch.training import loop

    tmp = tmp_path_factory.mktemp("preempt_ranks")
    ws = {name: str(tmp / name) for name in [*LAYOUTS, "emergency"]}
    to_device = loop.batch_to_device

    def preempted(name: str) -> dict:
        faults = PREEMPT if name == "data2" else "sigterm@step=2"
        spawn_ranks(worker, 2, ws[name], LAYOUTS[name], faults, expect_exit=-15)
        return _preempted(ws[name], reference.result())

    def emergency() -> dict:
        spawn_ranks(worker, 2, ws["emergency"],
                    {**LAYOUTS["fsdp2"], "training.checkpoint_interval": 1}, EMERGENCY,
                    expect_exit=1)
        fsdp2.result()  # its gathered step 2 is the reassembly's witness
        return _emergency(ws["emergency"], ws["fsdp2"], reference.result())

    try:
        with ThreadPoolExecutor(1) as ref_pool, ThreadPoolExecutor(2) as pool:
            reference = ref_pool.submit(_reference)
            fsdp2 = pool.submit(preempted, "fsdp2")
            runs = {"fsdp2": fsdp2, "emergency": pool.submit(emergency)}
            runs.update({name: pool.submit(preempted, name) for name in LAYOUTS
                         if name != "fsdp2"})
            return {name: run.result() for name, run in runs.items()}
    finally:
        loop.batch_to_device = to_device
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_signalled_rank_saves_collectively_and_all_exit(runs, layout):
    """SIGTERM to rank 1 saved step 2 and ended both ranks with signal 15
    (the spawn's expect_exit; rank 0 was never signalled); under data=2 a
    SIGUSR2 to rank 1 first saved step 1 and both ranks went on. The saved
    step 2 is the one-process state after 2 steps, its last-good pointer
    set, and the log ends at step 2."""
    got = runs[layout]
    assert got["steps"] == ([1, 2] if layout == "data2" else [2])
    assert got["last_good"] == 2 and got["logged"] == [1, 2]
    assert got["step2"] == [], got["step2"][:5]


@pytest.mark.parametrize("layout", list(LAYOUTS) + ["emergency"])
def test_resume_matches_the_uninterrupted_run(runs, layout):
    """One process resuming the run's last saved step 2 for step 3 lands
    where the uninterrupted one-process run's third Adam step does."""
    assert runs[layout]["resumed"] == [], runs[layout]["resumed"][:5]


def test_emergency_writes_each_ranks_shards(runs):
    """No collective after the failure: each rank wrote its own verified
    file of step 2 (no committed step directory), sharded parameters as
    shards, and together they reassemble the fsdp=2 preemption run's
    gathered step 2 bit for bit: parameters, statistics, Adam moments and
    counts, the schedule, the generators."""
    got = runs["emergency"]
    assert got["files"] == [True, True] and not got["committed_dir"]
    assert got["steps"] == [1, 2] and got["latest"] == 2
    assert got["sharded_params"] > 0 and got["shard_smaller"]
    assert got["vs_gathered"] == []


@pytest.mark.parametrize("fault", ["missing", "corrupt"])
def test_incomplete_shards_do_not_count(runs, fault):
    """Step 2 counts only with every rank's file present and verifying;
    else the latest complete step is step 1, and loading step 2 raises
    CheckpointCorrupt naming the shards."""
    got = runs["emergency"][fault]
    assert got["steps"] == [1] and got["latest"] == 1
    assert got["raised"] is not None and "rank shards" in got["raised"]


def test_collective_guard_records_then_resolves_on_agreement():
    """In collective mode a signal is only recorded (no save, no chain);
    SIGTERM outranks SIGUSR2 in the ranks' MAX; resolve() saves once and
    takes the agreed signal's disposition: SIGUSR2 with no handler below
    goes on."""
    import signal

    from mine_tpu_torch.resilience.preempt import SEVERITY, PreemptionGuard

    events = []
    guard = PreemptionGuard(lambda reason: events.append(reason), signals=(signal.SIGUSR2,),
                            collective=True).install()
    try:
        assert guard.pending() == 0
        os.kill(os.getpid(), signal.SIGUSR2)
        assert events == [] and guard.pending() == SEVERITY[signal.SIGUSR2] == 1
        assert SEVERITY[signal.SIGTERM] > SEVERITY[signal.SIGUSR2]
        guard.resolve(guard.pending())
        assert events == ["signal_sigusr2"] and guard.pending() == 0
        guard.resolve(SEVERITY[signal.SIGUSR2])  # a peer's request: this rank saves too
        assert events == ["signal_sigusr2"] * 2
    finally:
        guard.uninstall()


def test_an_unresolved_sigterm_is_redelivered(tmp_path):
    """A SIGTERM recorded in collective mode and never resolved (the run
    raised first) still ends the process once the guard is uninstalled."""
    import subprocess
    import sys

    script = (
        "import os, signal\n"
        "from mine_tpu_torch.resilience.preempt import PreemptionGuard\n"
        "saves = []\n"
        "guard = PreemptionGuard(saves.append, collective=True).install()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "assert guard.pending() == 2 and saves == []\n"
        "guard.uninstall()\n"
        "print('recorded', flush=True)\n"
        "guard.redeliver()\n"
        "print('survived', flush=True)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == -15 and proc.stdout == "recorded\n", (proc.returncode,
                                                                    proc.stdout, proc.stderr)
