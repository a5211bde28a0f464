"""Representation ceiling of an S-plane MPI on the analytic scene, with no
training anywhere (counterpart of tools/oracle_mpi_ceiling.py).

The MPI is built FROM THE ANALYTIC SCENE ITSELF: per-pixel true disparity
assigns each pixel's source colour to its bracketing planes. It renders the
held-out novel poses through the same `render_many` path the trained
model's eval uses (inference/video.py) and is scored against the analytic
renderer: what a PERFECT S-plane predictor that copies the source could
score. Two variants bound the ceiling from both sides:

  hard: each pixel fully opaque on its nearest plane
  soft: alpha w on the nearer bracketing plane + opaque on the farther one

    python -m mine_tpu_torch.tools.oracle_mpi_ceiling --planes 8 16 32 \
        [--compositor streaming] [--device cpu]

The MPIs composite their fourth channel as alpha (mpi.use_alpha), so under
--compositor streaming they take the streaming compositor's chunked scan.
Prints one JSON line per (S, variant), each with a source-pose sanity score:
the oracle composited at the SOURCE pose must reproduce the source image
(alpha sums to 1 along every ray), which pins any surprise to novel-pose
parallax, not to the construction. The last line is the JSON verdict
(utils/verdict.py) holding every row and the warp kernels' launches.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from mine_tpu_torch.data.synthetic import _intrinsics, _render_view
from mine_tpu_torch.inference.trajectory import poses_from_offsets
from mine_tpu_torch.inference.video import render_many
from mine_tpu_torch.ops.kernels import warp as kw
from mine_tpu_torch.tools.convergence_run import CROP, NOVEL_OFFSETS, build_cfg, psnr
from mine_tpu_torch.utils.device import resolve_device
from mine_tpu_torch.utils.verdict import emit, emit_failure

EVAL_PHASES = [2.5, 4.1, 0.7]  # the convergence runs' held-out scenes
METRIC = "oracle_mpi_novel_psnr"
# the source-pose render of a construction whose alphas sum to 1 along every
# ray reproduces the source image to float rounding
SRC_POSE_MIN_DB = 100.0


def oracle_alphas(depth: np.ndarray, disp_planes: np.ndarray, variant: str) -> np.ndarray:
    """(H,W) true depth + (S,) descending plane disparities -> (S,H,W,1)
    per-plane alpha, front (highest disparity) first."""
    s = disp_planes.shape[0]
    disp_true = np.clip(1.0 / depth, disp_planes[-1], disp_planes[0])
    alphas = np.zeros((s,) + depth.shape, np.float32)
    # bracketing indices: a = nearer plane (disp_a >= disp_true), b = a+1
    # (descending disparity), weight w -> plane a, 1-w -> plane b
    idx_b = np.searchsorted(-disp_planes, -disp_true, side="right")
    idx_b = np.clip(idx_b, 1, s - 1)
    idx_a = idx_b - 1
    da, db = disp_planes[idx_a], disp_planes[idx_b]
    w = (disp_true - db) / np.maximum(da - db, 1e-12)
    hh, ww = np.meshgrid(np.arange(depth.shape[0]), np.arange(depth.shape[1]), indexing="ij")
    if variant == "hard":
        nearest = np.where(w >= 0.5, idx_a, idx_b)
        alphas[nearest, hh, ww] = 1.0
    else:  # soft: translucent near plane over an opaque far plane
        alphas[idx_a, hh, ww] = w
        alphas[idx_b, hh, ww] = 1.0
    return alphas[..., None]


def oracle_mpi(src_img: np.ndarray, alphas: np.ndarray, device) -> tuple:
    """(H, W, 3) source image + (S, H, W, 1) alphas -> the (1, S, H, W, 3)
    source-copy MPI and its (1, S, H, W, 1) alphas, contiguous on `device`."""
    s = alphas.shape[0]
    rgb = np.ascontiguousarray(np.broadcast_to(src_img[None], (s,) + src_img.shape))
    return (torch.from_numpy(rgb)[None].to(device),
            torch.from_numpy(np.ascontiguousarray(alphas))[None].to(device))


def oracle_rows(planes, height: int, width: int, disparity_end: float, device,
                compositor: str = "dense") -> list[dict]:
    """One row per (S, variant): the mean novel-pose PSNR over EVAL_PHASES x
    NOVEL_OFFSETS and the mean source-pose PSNR."""
    h, w = height, width
    k_np = _intrinsics(h, w)
    k = torch.from_numpy(k_np)[None].to(device)
    poses = torch.from_numpy(poses_from_offsets(NOVEL_OFFSETS)).to(device)
    ident = torch.from_numpy(poses_from_offsets(np.zeros((1, 3)))).to(device)
    rows = []
    for s in planes:
        cfg = build_cfg(h, w, batch=1, num_planes=s, disparity_end=disparity_end,
                        compositor=compositor).replace(**{"mpi.use_alpha": True})
        disp_planes = np.linspace(1.0, disparity_end, s).astype(np.float32)
        disparity = torch.from_numpy(disp_planes)[None].to(device)
        for variant in ("soft", "hard"):
            scores, src_scores = [], []
            for ph in EVAL_PHASES:
                src_img, src_depth = _render_view(h, w, k_np, np.zeros(3), ph)
                mpi_rgb, mpi_alpha = oracle_mpi(src_img, oracle_alphas(src_depth, disp_planes,
                                                                       variant), device)
                rgb0, _ = render_many(cfg, mpi_rgb, mpi_alpha, disparity, k, ident)
                src_scores.append(psnr(rgb0.cpu().numpy()[0, CROP:-CROP, CROP:-CROP],
                                       src_img[CROP:-CROP, CROP:-CROP]))
                rgb = render_many(cfg, mpi_rgb, mpi_alpha, disparity, k, poses)[0].cpu().numpy()
                for i, offset in enumerate(NOVEL_OFFSETS):
                    want, _ = _render_view(h, w, k_np, -offset, ph)
                    scores.append(psnr(rgb[i, CROP:-CROP, CROP:-CROP],
                                       want[CROP:-CROP, CROP:-CROP]))
            rows.append({
                "metric": METRIC,
                "planes": s,
                "variant": variant,
                "disparity_end": disparity_end,
                "psnr_novel": round(float(np.mean(scores)), 3),
                "psnr_src_pose": round(float(np.mean(src_scores)), 3),
                "n_eval_scenes": len(EVAL_PHASES),
                "n_poses": len(NOVEL_OFFSETS),
                "compositor": compositor,
            })
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--planes", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--disparity-end", type=float, default=0.2)
    ap.add_argument("--compositor", default="dense", choices=("dense", "streaming"),
                    help="mpi.compositor of the renders")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rows = oracle_rows(args.planes, args.height, args.width, args.disparity_end,
                           resolve_device(args.device), args.compositor)
    except Exception as exc:  # noqa: BLE001 - the verdict line reports it
        return emit_failure(METRIC, exc, compositor=args.compositor)
    for row in rows:
        print(json.dumps(row), flush=True)
    ok = all(math.isfinite(r["psnr_novel"]) and r["psnr_src_pose"] >= SRC_POSE_MIN_DB
             for r in rows)
    return emit({"metric": METRIC, "ok": ok, "compositor": args.compositor,
                 "src_pose_min_db": SRC_POSE_MIN_DB, "rows": rows,
                 "launches": dict(kw.launches)})


if __name__ == "__main__":
    sys.exit(main())
