"""Convergence run: train the synthetic scene family to quality and measure
novel-view PSNR against analytic ground truth (counterpart of
tools/convergence_run.py).

The full train step (4-scale loss, BatchNorm statistics, LR schedule,
calibration) runs for hundreds to thousands of steps on procedurally
generated scenes (data/synthetic.py: every batch a fresh texture phase);
then the model does the real task on HELD-OUT scenes: predict an MPI from
one source image and render NOVEL camera poses (none equal to the fixed
training baseline), scored in PSNR against the analytic renderer, which
evaluates any pose exactly.

    python -m mine_tpu_torch.tools.convergence_run --steps 2200 \
        --eval-every 100 --eval-phases 3 --out workspace/artifacts/torch/convergence

Runs on the CUDA device unless --device cpu is given. Writes
<out>/curve.jsonl ({"step", "loss", "psnr_per_pose", "n_eval_scenes",
"psnr_novel", "elapsed_s"} per eval), progress to stderr, and ends in one
JSON verdict line (utils/verdict.py) with the final scores, the step time,
the peak device memory and the warp kernels' launches in the run.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import statistics
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.data.synthetic import _intrinsics, _render_view, make_synthetic_batch
from mine_tpu_torch.inference.trajectory import poses_from_offsets
from mine_tpu_torch.inference.video import predict_blended_mpi, predict_blended_mpi_c2f, render_many
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.ops.kernels import warp as kw
from mine_tpu_torch.ops.sampling import fixed_disparity_linspace
from mine_tpu_torch.training.optimizer import make_optimizer
from mine_tpu_torch.training.step import batch_to_device, build_model, train_step
from mine_tpu_torch.utils.device import resolve_device
from mine_tpu_torch.utils.verdict import emit, emit_failure

# camera offsets for eval; the training baseline is fixed at 0.08 along +x
# (make_synthetic_batch), so none of these equals a trained pose
NOVEL_OFFSETS = np.array([
    [0.03, 0.0, 0.0],
    [0.06, 0.02, 0.0],
    [-0.04, 0.01, 0.0],
])
CROP = 16  # interior crop: the border band is clamp padding, not scene content
# held-out scenes: phases the training stream cannot also draw (training
# phases come from seeded default_rng; these are fixed constants)
HELDOUT_PHASES = [2.5, 4.1, 0.7]
METRIC = "synthetic_novel_pose_psnr_after_training"
# processes that build the synthetic batches ahead of the steps: one builds a
# batch in well under a step's time
BATCH_WORKERS = 1


def build_cfg(height: int, width: int, batch: int, num_planes: int,
              disparity_end: float = 0.2, num_layers: int = 18,
              num_bins_fine: int = 0, dtype: str = "float32",
              compositor: str = "dense") -> Config:
    return Config().replace(**{
        "data.name": "synthetic",
        "data.img_h": height, "data.img_w": width,
        "data.per_gpu_batch_size": batch,
        "mpi.num_bins_fine": num_bins_fine,
        "model.num_layers": num_layers,
        "model.dtype": dtype,
        "mpi.num_bins_coarse": num_planes,
        "mpi.compositor": compositor,
        # bracket the scene's depth range (near 1.0, far 4.0) instead of the
        # LLFF default end 0.001 (depth 1000): 8 planes can't afford to
        # waste bins behind the far plane
        "mpi.disparity_start": 1.0,
        "mpi.disparity_end": disparity_end,
        "loss.smoothness_gmin": 0.8,
        "loss.smoothness_grad_ratio": 0.2,
        "training.epochs": 1,
    })


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(-10.0 * np.log10(np.mean((a - b) ** 2) + 1e-12))


def render_novel_poses(cfg: Config, model: torch.nn.Module, phase: float,
                       fine_u: torch.Tensor | None = None) -> np.ndarray:
    """The held-out scene `phase` seen from the source camera -> an MPI
    (predict_blended_mpi, or predict_blended_mpi_c2f with its fine draws
    `fine_u` when mpi.num_bins_fine > 0) rendered at every NOVEL_OFFSETS
    pose. Returns rgb (N, H, W, 3) on the host. The model runs in eval mode
    on its own device."""
    h, w = cfg.data.img_h, cfg.data.img_w
    dev = next(model.parameters()).device
    k_np = _intrinsics(h, w)
    k = torch.from_numpy(k_np)[None].to(dev)
    src_img, _ = _render_view(h, w, k_np, np.zeros(3), phase)
    img = torch.from_numpy(src_img)[None].to(dev)
    was_training = model.training
    model.eval()
    try:
        if cfg.mpi.num_bins_fine > 0:
            # a coarse-to-fine model renders at its merged plane list
            mpi_rgb, mpi_sigma, disparity = predict_blended_mpi_c2f(cfg, model, img, k, fine_u)
        else:
            disparity = fixed_disparity_linspace(1, cfg.mpi.num_bins_coarse,
                                                 cfg.mpi.disparity_start,
                                                 cfg.mpi.disparity_end, dev)
            mpi_rgb, mpi_sigma = predict_blended_mpi(cfg, model, img, disparity, k)
        poses = torch.from_numpy(poses_from_offsets(NOVEL_OFFSETS)).to(dev)
        rgb, _ = render_many(cfg, mpi_rgb, mpi_sigma, disparity, k, poses)
    finally:
        model.train(was_training)
    return rgb.cpu().numpy()


def eval_novel_pose_psnr(cfg: Config, model: torch.nn.Module, phase,
                         fine_u: torch.Tensor | None = None) -> dict:
    """Predict an MPI from held-out source image(s), render NOVEL poses,
    score against the analytic renderer on the interior crop. Returns the
    per-pose PSNR of the first scene and the mean over all scenes x poses.
    `phase` is a float or a sequence of floats: a single scene carries
    about +-1.5 dB of run-to-run noise, so curves average several."""
    h, w = cfg.data.img_h, cfg.data.img_w
    k = _intrinsics(h, w)
    phases = [phase] if isinstance(phase, (int, float)) else list(phase)
    all_scores = []
    for ph in phases:
        rgb = render_novel_poses(cfg, model, ph, fine_u)
        scores = []
        for i, offset in enumerate(NOVEL_OFFSETS):
            want, _ = _render_view(h, w, k, -offset, ph)
            scores.append(psnr(rgb[i, CROP:-CROP, CROP:-CROP], want[CROP:-CROP, CROP:-CROP]))
        all_scores.append(scores)
    return {"psnr_per_pose": [round(s, 3) for s in all_scores[0]],
            "n_eval_scenes": len(phases),
            "psnr_novel": round(float(np.mean(all_scores)), 3)}


def no_tf32() -> None:
    """fp32 means fp32 on the card too: cuDNN's convolutions take TF32 by
    default, as matmuls may; bf16 runs are unaffected (their network runs
    under autocast)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def save_state(model: torch.nn.Module, path: str) -> None:
    """The model's state_dict on the host, through a tmp file and a rename:
    the path only ever holds a complete save."""
    tmp_path = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, tmp_path)
    os.replace(tmp_path, path)


def load_model(cfg: Config, path: str, device: torch.device) -> torch.nn.Module:
    """A --save-final file -> the model cfg describes, in eval mode on
    `device`; a save of another shape (wrong --planes or --layers) fails
    loudly in load_state_dict."""
    model = build_model(cfg)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model.to(device).eval()


def synthetic_batch(step: int, batch: int, height: int, width: int, seed: int) -> dict:
    """The training batch of `step` (from 1) of a run seeded `seed`."""
    out = make_synthetic_batch(batch, height, width, n_points=256,
                               seed=seed * 7_777_777 + step)
    out.pop("src_depth")
    return out


def batch_feed(steps: int, batch: int, height: int, width: int, seed: int,
               ahead: int = 8):
    """The batches of steps 1..`steps` in order, built up to `ahead` steps
    early in BATCH_WORKERS spawned processes: numpy holds the GIL for much of
    a batch (~50 ms at 128x128, B=4 on the H100's host), and on a thread of
    this process it slows the launches of a step that is itself bound by the
    host's launch rate."""
    pool = ProcessPoolExecutor(BATCH_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        pending, nxt = deque(), 1
        while pending or nxt <= steps:
            while nxt <= steps and len(pending) < ahead:
                pending.append(pool.submit(synthetic_batch, nxt, batch, height, width, seed))
                nxt += 1
            yield pending.popleft().result()
    finally:
        pool.shutdown(cancel_futures=True)


def run(args, batches=None) -> dict:
    """Train and evaluate as `args` (parse_args) say. `batches`, a generator
    of the steps' batches (synthetic_batch's dicts), replaces batch_feed."""
    dev = resolve_device(args.device)
    no_tf32()
    cfg = build_cfg(args.height, args.width, args.batch, args.planes,
                    disparity_end=args.disparity_end, num_layers=args.layers,
                    num_bins_fine=args.fine_bins, dtype=args.dtype,
                    compositor=args.compositor)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.training.seed))
    if args.init_from:
        model.load_state_dict(torch.load(args.init_from, map_location="cpu",
                                         weights_only=True))
    model.to(dev).train()
    optimizer, scheduler = make_optimizer(cfg, model, steps_per_epoch=args.steps)
    generator = torch.Generator().manual_seed(cfg.training.seed)
    dropout_generator = torch.Generator().manual_seed(cfg.training.seed + 1)

    os.makedirs(args.out, exist_ok=True)
    curve_path = os.path.join(args.out, "curve.jsonl")
    heldout_phase = HELDOUT_PHASES[:args.eval_phases]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kw.reset_launches()

    t0 = time.time()
    block_start, block_first, block_ms, finite = time.perf_counter(), 0, [], True
    if batches is None:
        batches = batch_feed(args.steps, args.batch, args.height, args.width, args.seed)
    with open(curve_path, "a") as curve:
        try:
            for step, batch in enumerate(batches, start=1):
                loss_dict = train_step(cfg, model, optimizer, scheduler,
                                       batch_to_device(batch, dev), generator,
                                       dropout_generator)
                if step % args.eval_every == 0 or step == args.steps:
                    loss = float(loss_dict["loss"])  # waits for the step
                    block_ms.append((time.perf_counter() - block_start) * 1e3
                                    / (step - block_first))
                    block_first = step
                    finite = finite and math.isfinite(loss)
                    metrics = eval_novel_pose_psnr(cfg, model, heldout_phase)
                    row = {"step": step, "loss": round(loss, 4), **metrics,
                           "elapsed_s": round(time.time() - t0, 1)}
                    curve.write(json.dumps(row) + "\n")
                    curve.flush()
                    print(json.dumps(row), file=sys.stderr, flush=True)
                    block_start = time.perf_counter()
        finally:
            batches.close()

    if args.save_final:
        save_state(model, args.save_final)
    wall_s = time.time() - t0
    return {
        "metric": METRIC,
        "ok": finite and math.isfinite(metrics["psnr_novel"]),
        "steps": args.steps,
        "final_loss": round(loss, 4),
        **metrics,
        "curve": curve_path,
        "wall_s": round(wall_s, 1),
        "dtype": args.dtype, "compositor": args.compositor,
        "device": str(dev),
        # each block of eval_every steps timed from its first step to its
        # last one's loss on the host; the evals are left out
        "step_ms_median": statistics.median(block_ms),
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None,
        "launches": dict(kw.launches),
    }


def _writable(path: str) -> str | None:
    """None when a file can be made beside `path`, else why not; made and
    removed, because os.access() says yes to root whatever the mount."""
    save_dir = os.path.dirname(os.path.abspath(path))
    try:
        os.makedirs(save_dir, exist_ok=True)
        with tempfile.TemporaryFile(dir=save_dir):
            pass
    except OSError as e:
        return f"--save-final directory not writable: {save_dir} ({e})"
    return None


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--planes", type=int, default=8)
    ap.add_argument("--disparity-end", type=float, default=0.2,
                    help="nearest-to-farthest plane disparity range end")
    ap.add_argument("--out", default="workspace/artifacts/torch/convergence")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-phases", type=int, default=1, choices=(1, 2, 3),
                    help="held-out scenes to average the eval over "
                         "(single-scene eval carries ~+-1.5 dB noise)")
    ap.add_argument("--layers", type=int, default=18,
                    help="ResNet encoder depth (18/34/50/101/152)")
    ap.add_argument("--fine-bins", type=int, default=0,
                    help="coarse-to-fine refinement planes (mpi.num_bins_fine)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="model.dtype: the network under bf16 autocast or in fp32")
    ap.add_argument("--compositor", default="dense", choices=("dense", "streaming"),
                    help="mpi.compositor of training and the eval renders")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--save-final", default="",
                    help="if set, torch.save the final state_dict here, for "
                         "post-run analysis (disocclusion_analysis --params)")
    ap.add_argument("--init-from", default="",
                    help="start from a prior run's --save-final state_dict (fresh "
                         "optimizer and schedule)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.save_final:
        # fail on an unwritable path now, not after the training, and
        # without creating the file
        reason = _writable(args.save_final)
        if reason:
            ap.error(reason)
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    try:
        return emit(run(args))
    except Exception as exc:  # noqa: BLE001 - the verdict line reports it
        return emit_failure(METRIC, exc, steps=args.steps, dtype=args.dtype,
                            compositor=args.compositor)


if __name__ == "__main__":
    sys.exit(main())
