"""Training CLI: `python -m mine_tpu_torch.train --extra_config
'{"data.name": "synthetic"}'`.

Config layers are the JAX package's flat dot-key YAML files (e.g.
mine_tpu/configs/llff.yaml) over the defaults, then the --extra_config JSON.
The run is on the CUDA device unless --device cpu is given. It trains on the
train split and evaluates on the val split every training.eval_interval
steps; the merged config lands in <workspace>/params.yaml, the loss dict of
every logged step in <workspace>/train_log.jsonl, each eval in
<workspace>/eval_log.jsonl, the metric stream in <workspace>/metrics.jsonl,
the log in <workspace>/train.log and checkpoints under
<workspace>/checkpoints/. Run it again on the same workspace and it resumes
(training.resume_from: latest, or last_good for the sentinel-vetted step).
SIGTERM or SIGUSR2 saves the last completed step first
(resilience.preempt_save); with obs.enabled the run also writes host spans,
MFU and a flight recorder's dumps (<workspace>/flight); MINE_TPU_FAULTS
injects the chaos seams' faults (resilience/chaos.py).

Over several processes, one a device, launch it with torchrun:

    torchrun --nproc-per-node N -m mine_tpu_torch.train \
        --config mine_tpu/configs/default.yaml [--dist-backend nccl|gloo]

Each rank joins the process group (resilience/multihost.py bring_up,
resilience.multihost_bringup_attempts and _backoff_s), trains on the mesh
mesh.data_parallel x mesh.plane_parallel (parallel/), on cuda:{LOCAL_RANK}
unless --device names its device (two ranks sharing one card pass --device
cuda:0 with --dist-backend gloo: NCCL puts one rank on a device). Only rank 0
writes the workspace; resilience.multihost_watchdog_s arms the cross-host
watchdog over <workspace>/heartbeats.
"""

from __future__ import annotations

import argparse
import logging

import torch.distributed as dist

from mine_tpu_torch.config import load_config
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.resilience.multihost import bring_up
from mine_tpu_torch.training.loop import Trainer


def add_dist_args(parser: argparse.ArgumentParser) -> None:
    """The CLIs' process-group flags."""
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend under torchrun (default: nccl on "
                             "CUDA, gloo on the CPU); giving it also makes a one-rank "
                             "torchrun job join a process group")


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", action="append", default=[],
                        help="YAML config layer(s), later override earlier; the "
                             "defaults are always implied first")
    parser.add_argument("--extra_config", default=None,
                        help="JSON dict of final dot-key overrides")
    parser.add_argument("--workspace", default="workspace/run")
    parser.add_argument("--device", default=None,
                        help="cuda (default; cuda:{LOCAL_RANK} under torchrun), cuda:N or cpu")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after this many updates in all (default: all epochs)")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="trace this many steps with torch.profiler into "
                             "<workspace>/profile/train_steps.trace.json")
    add_dist_args(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    cfg = load_config(*args.config, overrides=args.extra_config)
    grouped = bring_up(attempts=cfg.resilience.multihost_bringup_attempts,
                       backoff_s=cfg.resilience.multihost_bringup_backoff_s,
                       backend=args.dist_backend, device=args.device)
    try:
        trainer = Trainer(cfg, args.workspace, device=args.device,
                          profile_steps=args.profile_steps)
        # each rank's loader builds only its rows of the global batch
        train_ds = build_dataset(cfg, "train", trainer.global_batch,
                                 host_slice=trainer.host_slice)
        val_ds = build_dataset(cfg, "val", trainer.global_batch, host_slice=trainer.host_slice)
        return trainer.fit(train_ds, val_ds, max_steps=args.max_steps)
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
