"""Evaluation CLI: the metric pass of a workspace's newest checkpoint over
the val split (counterpart of mine_tpu/evaluate.py).

    python -m mine_tpu_torch.evaluate --checkpoint workspace/run \
        [--extra_config '{"training.lpips_weights_path": "lpips_vgg.npz"}'] [--device cpu]

The config is the params.yaml the training run archived, with
--extra_config on top. Prints one JSON line: the step, every metric of the
loss suite (PSNR, SSIM, LPIPS among them) averaged over the genuine val
examples, and their count; the means as val/ scalars and the last batch's
image grids (val/tgt_syn, val/src_syn, val/tgt_disparity) go to
<checkpoint>/eval (metrics.jsonl, and TensorBoard events where tensorboardX
imports). Runs on the CUDA device unless --device cpu. A
workspace trained coarse-to-fine (mpi.num_bins_fine > 0) is evaluated
through the coarse-to-fine forward (training/step.py loss_fcn), its fine
draws from the eval generator after the disparities. A run trained under a
sharded layout restores as any other: checkpoints are gathered on save.
Under torchrun (train.py's flags) each rank evaluates its rows of every val
batch on the mesh the config names, the means are the whole mesh's, and
rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch.distributed as dist

from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.losses.lpips import load_lpips_params
from mine_tpu_torch.parallel.data_parallel import make_plan, model_groups
from mine_tpu_torch.parallel.mesh import (
    data_replica_count,
    host_batch_slice,
    make_mesh,
    process_index,
    rank_device,
)
from mine_tpu_torch.resilience.multihost import bring_up
from mine_tpu_torch.train import add_dist_args
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.training.loop import run_evaluation
from mine_tpu_torch.training.step import build_model
from mine_tpu_torch.utils.device import resolve_device
from mine_tpu_torch.utils.logging import MetricWriter


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True,
                        help="training workspace (params.yaml + checkpoints/)")
    parser.add_argument("--extra_config", default=None,
                        help="JSON dict of overrides on top of the archived params.yaml")
    parser.add_argument("--device", default=None,
                        help="cuda (default; cuda:{LOCAL_RANK} under torchrun), cuda:N or cpu")
    add_dist_args(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    cfg = ckpt.load_paired_config(args.checkpoint, overrides=args.extra_config)
    grouped = bring_up(attempts=cfg.resilience.multihost_bringup_attempts,
                       backoff_s=cfg.resilience.multihost_bringup_backoff_s,
                       backend=args.dist_backend, device=args.device)
    try:
        if not grouped:
            # one process evaluates alone, whatever mesh the run trained on
            cfg = cfg.replace(**{"mesh.data_parallel": -1, "mesh.plane_parallel": 1,
                                 "mesh.fsdp_parallel": 1})
        mesh = make_mesh(cfg.mesh.data_parallel, cfg.mesh.plane_parallel, cfg.mesh.fsdp_parallel)
        plan = make_plan(cfg, mesh) if grouped else None
        device = resolve_device(args.device if args.device or not grouped else rank_device())
        step = ckpt.latest_step(args.checkpoint)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt.checkpoint_path(args.checkpoint)}")
        model = build_model(cfg, **model_groups(mesh))
        model.load_state_dict(ckpt.load(args.checkpoint, step)["model"])
        model.to(device)
        global_batch = cfg.data.per_gpu_batch_size * data_replica_count(mesh)
        val_ds = build_dataset(cfg, "val", global_batch, host_slice=(
            host_batch_slice(mesh, global_batch) if data_replica_count(mesh) > 1 else None))
        lpips_params = load_lpips_params(cfg.training.lpips_weights_path, device)
        # rank 0 writes the val/ scalars and image grids under <checkpoint>/eval
        writer = MetricWriter(os.path.join(args.checkpoint, "eval")) if process_index() == 0 \
            else None
        try:
            result = run_evaluation(cfg, model, val_ds, device, lpips_params, step, plan=plan,
                                    writer=writer)
        finally:
            if writer is not None:
                writer.close()
        if process_index() == 0:
            print(json.dumps({"step": step, **{k: round(v, 6) for k, v in result.items()}}),
                  flush=True)
        return result
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
