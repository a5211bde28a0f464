"""Multi-host harness: drive a real multi-process training job as N
processes on one machine (counterpart of tools/multihost_harness.py):
the same bring-up, mesh, collectives, per-host loaders, heartbeats and
checkpoints a job of N hosts runs, each "host" one rank of the port's
Trainer.

Each host is one process, forked from a server that has imported torch,
torch._dynamo and the trainer once (multiprocessing's forkserver: a host
starts without paying those imports, ~8 s of CPU, again), with:

  RANK, WORLD_SIZE, LOCAL_RANK,     torchrun's variables (parallel/mesh.py
  MASTER_ADDR=127.0.0.1,            init_distributed); the rank joins the
  MASTER_PORT=P                     process group through bring_up's retries
  TORCHELASTIC_USE_AGENT_STORE=True the rendezvous store is the harness's
  MINE_TPU_FAULTS=<per-host spec>   optional chaos (resilience/chaos.py):
                                    `host_kill@step=K` only in the victim's
                                    environment, etc.

The harness hosts the rendezvous store itself, as torchrun's agent does:
its port is bound once, so that no other process can take it between its
choice and a rank's bind (on a busy machine the gloo connections' own
ephemeral ports can), and no rank's death takes it down. The collectives
run over gloo. On the card every rank runs on it (cuda:0 of
one card: NCCL puts one rank on a device, gloo carries CUDA tensors through
the host), with TF32 off; under --device cpu the ranks run on the CPU. What
each process runs is the product path: Trainer (its retrying bring-up
first), a SyntheticDataset sliced to the rank's rows (Trainer.host_slice:
each host builds only its rows of the global batch), fit(). Its stdout and
stderr land in `<workdir>/host_<i>.log`, the warp kernels' launch counts
after each of its steps in `<workdir>/host_<i>.launches.json`, and, when it
resumes, its restored state held against the checkpoint bit for bit in
`<workdir>/host_<i>.restore.json`.

`launch()` is the library API the chaos drill's multihost and training
halves build on; the CLI wraps it:

    python -m mine_tpu_torch.tools.multihost_harness --n-hosts 4 --steps 6 \\
        --workspace /tmp/mh/ws --per-host-batch 3 \\
        --fault 1:host_kill@step=3 --override resilience.multihost_watchdog_s=20 \\
        [--device cpu]

A launch's result (HostResult a host): the return code (negative: died by
that signal; resilience/multihost.py EXIT_HOST_STALL, 83: the watchdog's
named abort), whether the deadline killed it, its log. Heartbeats, abort
markers and the straggler table come from resilience/multihost.py: the
harness reads the files an operator would read. The CLI ends in one JSON
verdict line (utils/verdict.py), ok and exit code 0 when every host exited 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import multiprocessing
import sys
import time
from pathlib import Path

from mine_tpu_torch.resilience import multihost as mh
from mine_tpu_torch.utils.verdict import emit

# the checkout's root
REPO = Path(__file__).resolve().parent.parent.parent
# what every host imports first, imported once by the fork server
PRELOAD = ["torch", "torch._dynamo", "mine_tpu_torch.data.synthetic",
           "mine_tpu_torch.training.loop", "mine_tpu_torch.tools.multihost_harness"]


@dataclasses.dataclass
class HostResult:
    process_id: int
    returncode: int | None  # None: still alive at the deadline (killed)
    timed_out: bool
    log: str

    @property
    def died_by_signal(self) -> int | None:
        return -self.returncode if (self.returncode is not None
                                    and self.returncode < 0) else None

    @property
    def watchdog_aborted(self) -> bool:
        return self.returncode == mh.EXIT_HOST_STALL


@dataclasses.dataclass
class LaunchResult:
    workspace: str
    workdir: str
    hosts: list[HostResult]
    wall_s: float

    @property
    def returncodes(self) -> list[int | None]:
        return [h.returncode for h in self.hosts]

    def heartbeats(self) -> dict[int, dict]:
        directory = os.path.join(self.workspace, "heartbeats")
        out: dict[int, dict] = {}
        for i in range(len(self.hosts)):
            beat = mh.read_beat(mh.beat_path(directory, i))
            if beat is not None:
                out[i] = beat
        return out

    def abort_markers(self) -> dict[int, dict]:
        return mh.abort_markers(os.path.join(self.workspace, "heartbeats"))

    def straggler_table(self) -> dict:
        """Straggler attribution off the heartbeat files (its reference time
        is the newest beat: it reads the same live and after the fact)."""
        return mh.straggler_table(os.path.join(self.workspace, "heartbeats"))

    def flight_dump_dirs(self) -> dict[int, list[str]]:
        """{process_id: flight dump dirs}: the dumps in each process's own
        subdirectory (obs/flight.py `p<rank>-<pid>/`)."""
        root = os.path.join(self.workspace, "flight")
        out: dict[int, list[str]] = {}
        if not os.path.isdir(root):
            return out
        for sub in os.listdir(root):
            idx = sub[1:].split("-", 1)[0]
            if not sub.startswith("p") or not idx.isdigit():
                continue
            dumps = [os.path.join(root, sub, d) for d in os.listdir(os.path.join(root, sub))
                     if d.startswith("flight_")]
            out.setdefault(int(idx), []).extend(dumps)
        return out

    def launches(self) -> dict[int, dict[str, int]]:
        """{process_id: the warp kernels' launch counts after its last
        completed step} (ops/kernels/warp.py; all 0 on the CPU)."""
        out = {}
        for i in range(len(self.hosts)):
            try:
                with open(launches_path(self.workdir, i)) as fh:
                    out[i] = json.load(fh)
            except (OSError, ValueError):
                pass
        return out

    def total_launches(self) -> dict[str, int]:
        total: dict[str, int] = {}
        for counts in self.launches().values():
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
        return total


def launches_path(workdir: str, process_id: int) -> str:
    return os.path.join(workdir, f"host_{process_id}.launches.json")


def restore_path(workdir: str, process_id: int) -> str:
    return os.path.join(workdir, f"host_{process_id}.restore.json")


def _tensors(tree, prefix: str = ""):
    """(path, tensor) of every tensor in nested dicts and lists."""
    import torch

    if torch.is_tensor(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")


def restore_check(restored: dict, saved: dict) -> dict:
    """The state a rank holds after a restore against the checkpoint it
    restored: every model and optimizer tensor bit for bit."""
    import torch

    got = dict(_tensors({k: restored[k] for k in ("model", "optimizer")}))
    want = dict(_tensors({k: saved[k] for k in ("model", "optimizer")}))
    mismatched = sorted(set(got) ^ set(want))
    mismatched += [k for k in sorted(set(got) & set(want))
                   if not torch.equal(got[k].detach().cpu(), want[k].detach().cpu())]
    return {"step": int(saved["global_step"]), "leaves": len(want),
            "mismatched_leaves": len(mismatched), "first_mismatches": mismatched[:5]}


def host_devices(device: str | None, n_hosts: int) -> list[str]:
    """Each host's device: "cpu" for every host under cpu; else the cards in
    turn (cuda:0 for every host on a machine with one card)."""
    if device is not None and device.startswith("cpu"):
        return ["cpu"] * n_hosts
    if device is not None and ":" in device:
        return [device] * n_hosts
    import torch

    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the hosts "
                           "on the CPU")
    return [f"cuda:{i % count}" for i in range(n_hosts)]


def run_host(overrides: dict, workspace: str, steps: int, device: str, threads: int,
             counts_path: str) -> int:
    """One host: bring-up, Trainer, the rank's rows of a SyntheticDataset,
    fit(). The launch counts are written after every step, the restore
    check after every restore."""
    import torch
    import torch.distributed as dist

    from mine_tpu_torch.config import Config
    from mine_tpu_torch.data.synthetic import SyntheticDataset
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.training.loop import Trainer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    torch.set_num_threads(max(threads, 1))
    if torch.device(device).type == "cuda":
        # fp32 arithmetic on the card, as the gates of the drill assume
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = Config().replace(**overrides)
    grouped = mh.bring_up(attempts=cfg.resilience.multihost_bringup_attempts,
                          backoff_s=cfg.resilience.multihost_bringup_backoff_s,
                          backend="gloo", device=device)
    trainer = Trainer(cfg, workspace, device=device)
    rank = trainer.rank
    ds = SyntheticDataset(cfg.data.img_h, cfg.data.img_w, trainer.global_batch,
                          steps_per_epoch=steps, n_points=32, host_slice=trainer.host_slice)
    step = trainer.step

    def counted_step(batch):
        out = step(batch)
        tmp = f"{counts_path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(dict(kw.launches), fh)
        os.replace(tmp, counts_path)
        return out

    load_state = trainer.load_state

    def checked_load_state(state):
        # every rank restores together, so the gather under a sharded
        # layout (a collective) is safe here
        load_state(state)
        with open(restore_path(os.path.dirname(counts_path), rank), "w") as fh:
            json.dump(restore_check(trainer.state(), state), fh)

    trainer.step = counted_step
    trainer.load_state = checked_load_state
    trainer.fit(ds)
    print("HARNESS_DONE", flush=True)
    if grouped:
        dist.destroy_process_group()
    return 0


def _host_process(env: dict, log_path: str, args: tuple) -> None:
    """A forked host: its environment and its log (stdout and stderr, the C
    level's too) in place, then run_host."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    sys.stdout.reconfigure(line_buffering=True)
    os.environ.clear()
    os.environ.update(env)
    sys.exit(run_host(*args))


def launch(
    workspace: str,
    n_hosts: int,
    steps: int,
    overrides: dict | None = None,
    faults: dict[int, str] | None = None,
    timeout_s: float = 600.0,
    workdir: str | None = None,
    device: str | None = None,
) -> LaunchResult:
    """Run one N-host training job to its end (or the deadline).

    `faults` maps a host index to the MINE_TPU_FAULTS spec of that host
    alone (how `host_kill@step=3` lands on one victim). Hosts still alive at
    the deadline are SIGKILLed and report returncode None and timed_out: a
    survivor that hangs instead of aborting shows as exactly that. `device`
    is "cpu", or the card (the default)."""
    workdir = workdir or os.path.dirname(workspace) or "."
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(workspace, exist_ok=True)
    devices = host_devices(device, n_hosts)
    # one intra-op thread a host: on the CPU the plain versions' scatters add
    # in a thread-dependent order with more (two runs then part in the last
    # bits); on the card the hosts do little on the CPU beside their peers
    threads = 1
    from datetime import timedelta

    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, None, True, timedelta(seconds=max(timeout_s, 1.0)),
                     wait_for_workers=False)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    procs: list[multiprocessing.Process] = []
    logs: list[str] = []
    for i in range(n_hosts):
        env = dict(os.environ, PYTHONPATH=str(REPO), RANK=str(i), LOCAL_RANK=str(i),
                   WORLD_SIZE=str(n_hosts), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                   TORCHELASTIC_USE_AGENT_STORE="True", TORCHELASTIC_RESTART_COUNT="0",
                   MINE_TPU_FAULTS=(faults or {}).get(i, ""))
        for stale in (launches_path(workdir, i), restore_path(workdir, i)):
            try:
                os.remove(stale)
            except OSError:
                pass
        logs.append(os.path.join(workdir, f"host_{i}.log"))
        args = (dict(overrides or {}), workspace, steps, devices[i], threads,
                launches_path(workdir, i))
        procs.append(ctx.Process(target=_host_process, args=(env, logs[i], args)))
        procs[i].start()
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    results: list[HostResult | None] = [None] * n_hosts
    pending = set(range(n_hosts))
    while pending and time.monotonic() < deadline:
        for i in sorted(pending):
            rc = procs[i].exitcode
            if rc is not None:
                results[i] = HostResult(i, rc, False, "")
                pending.discard(i)
        if pending:
            time.sleep(0.2)
    for i in sorted(pending):  # past the deadline: the hang is the verdict
        procs[i].kill()
        procs[i].join()
        results[i] = HostResult(i, None, True, "")
    wall = time.monotonic() - t0
    del store  # every host has exited
    for i, r in enumerate(results):
        try:
            with open(logs[i]) as fh:
                r.log = fh.read()
        except OSError:
            pass
    return LaunchResult(workspace, workdir, list(results), wall)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n-hosts", type=int, default=2)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--workspace", required=True)
    parser.add_argument("--per-host-batch", type=int, default=1,
                        help="data.per_gpu_batch_size (one device a host)")
    parser.add_argument("--fault", action="append", default=[], metavar="HOST:SPEC",
                        help="per-host MINE_TPU_FAULTS, e.g. '1:host_kill@step=3' (repeatable)")
    parser.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                        help="config overrides (YAML-parsed values), repeatable")
    parser.add_argument("--timeout-s", type=float, default=600.0)
    parser.add_argument("--device", default=None,
                        help="the hosts' device: the card (default) or cpu")
    args = parser.parse_args(argv)

    import yaml

    overrides = {
        "data.name": "synthetic",
        "data.img_h": 128, "data.img_w": 128,
        "data.per_gpu_batch_size": args.per_host_batch,
        "data.num_workers": 0,
        "model.num_layers": 18, "model.dtype": "float32",
        "model.imagenet_pretrained": False,
        "mpi.num_bins_coarse": 2,
        "training.epochs": 1, "training.log_interval": 1,
        "training.checkpoint_interval": 2,
        "obs.enabled": True,
        "resilience.multihost_watchdog_s": 20.0,
    }
    for row in args.override:
        key, _, value = row.partition("=")
        overrides[key.strip()] = yaml.safe_load(value)
    faults = {}
    for row in args.fault:
        host, _, spec = row.partition(":")
        faults[int(host)] = spec
    result = launch(args.workspace, args.n_hosts, args.steps, overrides, faults=faults,
                    timeout_s=args.timeout_s, device=args.device)
    return emit({
        "metric": "multihost_harness",
        "ok": all(h.returncode == 0 for h in result.hosts),
        "n_hosts": args.n_hosts,
        "device": host_devices(args.device, 1)[0],
        "returncodes": result.returncodes,
        "timed_out": [h.timed_out for h in result.hosts],
        "wall_s": round(result.wall_s, 1),
        "heartbeats": {str(i): {k: b.get(k) for k in ("step", "data_bytes", "done")}
                       for i, b in result.heartbeats().items()},
        "abort_markers": {str(i): m.get("reason") for i, m in result.abort_markers().items()},
        "stragglers": result.straggler_table(),
        "flight_dumps": {str(i): len(d) for i, d in result.flight_dump_dirs().items()},
        "launches": result.total_launches(),
    })


if __name__ == "__main__":
    sys.exit(main())
