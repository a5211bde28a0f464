"""Evaluation CLI: the metric pass of a workspace's newest checkpoint over
the val split (counterpart of mine_tpu/evaluate.py).

    python -m mine_tpu_torch.evaluate --checkpoint workspace/run \
        [--extra_config '{"training.lpips_weights_path": "lpips_vgg.npz"}'] [--device cpu]

The config is the params.yaml the training run archived, with
--extra_config on top. Prints one JSON line: the step, every metric of the
loss suite (PSNR, SSIM, LPIPS among them) averaged over the genuine val
examples, and their count. Runs on the CUDA device unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import logging

from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.losses.lpips import load_lpips_params
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.training.loop import run_evaluation
from mine_tpu_torch.training.step import build_model
from mine_tpu_torch.utils.device import resolve_device


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True,
                        help="training workspace (params.yaml + checkpoints/)")
    parser.add_argument("--extra_config", default=None,
                        help="JSON dict of overrides on top of the archived params.yaml")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    cfg = ckpt.load_paired_config(args.checkpoint, overrides=args.extra_config)
    device = resolve_device(args.device)
    step = ckpt.latest_step(args.checkpoint)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt.checkpoint_path(args.checkpoint)}")
    model = build_model(cfg)
    model.load_state_dict(ckpt.load(args.checkpoint, step)["model"])
    model.to(device)
    val_ds = build_dataset(cfg, "val", cfg.data.per_gpu_batch_size)
    lpips_params = load_lpips_params(cfg.training.lpips_weights_path, device)
    result = run_evaluation(cfg, model, val_ds, device, lpips_params, step)
    print(json.dumps({"step": step, **{k: round(v, 6) for k, v in result.items()}}), flush=True)
    return result


if __name__ == "__main__":
    main()
