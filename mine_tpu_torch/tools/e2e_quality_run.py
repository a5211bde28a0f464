"""End-to-end trained-to-quality run through the port's product CLIs and
nothing else (counterpart of tools/e2e_quality_run.py).

convergence_run drives train_step directly; this harness runs the whole
user-facing path on the analytic scene:

  1. write an on-disk LLFF/COLMAP scene (images/ + images_val/ + sparse/0
     binary model) with analytic ground truth (data/synthetic.py
     write_colmap_scene);
  2. `python -m mine_tpu_torch.train` on it: the dataset factory, the LLFF
     loader, the prefetch pipeline, the Trainer loop, checkpointing;
  3. `python -m mine_tpu_torch.evaluate` on the workspace: the standalone
     eval CLI scoring held-out val views (novel poses never trained on).

So the quality number comes out of the commands a user runs, and a fault
anywhere in the chain (COLMAP IO, intrinsics scaling, pose algebra, loader
batching, checkpoint round trip, eval metrics) shows as a bad PSNR.

    python -m mine_tpu_torch.tools.e2e_quality_run --epochs 300 [--device cpu]

Both CLIs run on the CUDA device unless --device cpu is given. Ends in one
JSON verdict line (utils/verdict.py): {"train_rc", "eval_rc", "val_psnr",
"steps", "train_s", ...}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from mine_tpu_torch.utils.verdict import emit, emit_failure

# the checkout's root: the CLIs run from there as `python -m`
REPO = Path(__file__).resolve().parent.parent.parent
METRIC = "e2e_cli_quality_llff_pipeline"


def overrides(data_root: str, size: int, epochs: int, planes: int = 8) -> dict:
    """The train CLI's --extra_config."""
    return {
        "data.name": "llff",
        "data.training_set_path": data_root,
        "data.img_h": size, "data.img_w": size,
        "data.img_pre_downsample_ratio": 1.0,
        "data.per_gpu_batch_size": 4,
        # the synthetic sparse model tracks 80 points per view
        "data.visible_point_count": 32,
        "model.num_layers": 18,
        "model.dtype": "float32",
        "mpi.num_bins_coarse": planes,
        # bracket the scene's [1, 4] depth range (convergence_run.build_cfg)
        "mpi.disparity_start": 1.0,
        "mpi.disparity_end": 0.2,
        "loss.smoothness_gmin": 0.8,
        "loss.smoothness_grad_ratio": 0.2,
        "training.epochs": epochs,
        # quality comes from the standalone eval CLI afterwards
        "training.eval_interval": 10_000_000,
        # MultiStep decay is epoch-indexed; the default (5, 10) was tuned for
        # 15-epoch recipes and would decay the rate 100x almost at once here
        "lr.decay_steps": [epochs * 3 // 5, epochs * 9 // 10],
    }


def run(args) -> dict:
    from mine_tpu_torch.data.synthetic import write_colmap_scene

    out = Path(args.out).resolve()  # the CLIs run from the checkout's root
    data_root = out / "data"
    ws = out / "run"
    data_root.mkdir(parents=True, exist_ok=True)
    write_colmap_scene(str(data_root), "analytic_scene", n_views=args.n_views,
                       hw=(args.size, args.size), n_val_views=args.n_val_views)
    device = ["--device", args.device] if args.device else []

    t0 = time.time()
    train = subprocess.run(
        [sys.executable, "-m", "mine_tpu_torch.train", "--workspace", str(ws),
         "--extra_config", json.dumps(overrides(str(data_root), args.size, args.epochs,
                                              args.planes)),
         *device],
        cwd=REPO, capture_output=True, text=True,
    )
    train_s = round(time.time() - t0, 1)
    steps = args.epochs * (args.n_views // 4)
    if train.returncode != 0:
        return {"metric": METRIC, "ok": False, "train_rc": train.returncode,
                "train_s": train_s, "steps": steps, "error": train.stderr[-1500:]}

    t0 = time.time()
    ev = subprocess.run(
        [sys.executable, "-m", "mine_tpu_torch.evaluate", "--checkpoint", str(ws), *device],
        cwd=REPO, capture_output=True, text=True,
    )
    eval_s = round(time.time() - t0, 1)
    metrics: dict = {}
    for line in reversed(ev.stdout.strip().splitlines()):
        try:
            metrics = json.loads(line)
            break
        except json.JSONDecodeError:
            continue
    val_psnr = metrics.get("psnr_tgt")
    return {
        "metric": METRIC,
        "ok": ev.returncode == 0 and val_psnr is not None and math.isfinite(val_psnr),
        "train_rc": 0,
        "train_s": train_s,
        "steps": steps,
        "eval_rc": ev.returncode,
        "eval_s": eval_s,
        "val_psnr": val_psnr,
        "eval_metrics": metrics,
        **({"eval_error": ev.stderr[-1500:]} if ev.returncode else {}),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=200,
                    help="3 steps an epoch at 12 views / batch 4")
    ap.add_argument("--n-views", type=int, default=12)
    ap.add_argument("--n-val-views", type=int, default=3)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--planes", type=int, default=8, help="mpi.num_bins_coarse")
    ap.add_argument("--device", default=None,
                    help="passed to both CLIs: cuda (their default) or cpu")
    ap.add_argument("--out", default="workspace/artifacts/torch/e2e_quality")
    args = ap.parse_args(argv)
    try:
        return emit(run(args))
    except Exception as exc:  # noqa: BLE001 - the verdict line reports it
        return emit_failure(METRIC, exc)


if __name__ == "__main__":
    sys.exit(main())
