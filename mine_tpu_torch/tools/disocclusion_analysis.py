"""Disocclusion-region quality: a trained model against the source-copy
oracle (counterpart of tools/disocclusion_analysis.py).

An MPI that only copies source pixels is bound by disocclusion
(oracle_mpi_ceiling): novel poses reveal far-plane content that the near
strip hides from the source view. A trained network can inpaint plausible
texture there. This tool measures that per region:

  * the disocclusion mask is analytic: a novel-view pixel is disoccluded iff
    it sees the far plane AND the source ray to that far point passes
    through the near strip (|x * NEAR/FAR| < half-width; source camera at
    the origin, world axes == camera axes, data/synthetic.py _render_view);
  * PSNR is reported over disoccluded, source-visible and all interior
    pixels, for the trained model (single-pass, or coarse-to-fine with
    --fine-bins) and for the soft source-copy oracle on the same poses.

If trained-disoccluded beats oracle-disoccluded, the network inpaints.

    python -m mine_tpu_torch.tools.disocclusion_analysis \
        --params workspace/artifacts/torch/final_state.pt --planes 8 [--device cpu]

--params is a convergence_run --save-final file (a torch.save'd state_dict;
tools/jax_workspace_to_torch.py --msgpack converts the JAX harness's). Ends
in one JSON verdict line (utils/verdict.py), also written to --out, with the
warp kernels' launches.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from mine_tpu_torch.data.synthetic import (
    FAR_DEPTH,
    NEAR_DEPTH,
    _NEAR_HALF_WIDTH,
    _intrinsics,
    _render_view,
)
from mine_tpu_torch.inference.trajectory import poses_from_offsets
from mine_tpu_torch.inference.video import render_many
from mine_tpu_torch.ops.kernels import warp as kw
from mine_tpu_torch.tools.convergence_run import (
    CROP,
    NOVEL_OFFSETS,
    build_cfg,
    load_model,
    no_tf32,
    psnr,
    render_novel_poses,
)
from mine_tpu_torch.tools.oracle_mpi_ceiling import EVAL_PHASES, oracle_alphas, oracle_mpi
from mine_tpu_torch.utils.device import resolve_device
from mine_tpu_torch.utils.verdict import emit, emit_failure

METRIC = "disocclusion_region_psnr_trained_vs_src_copy_oracle"


def disocclusion_mask(h: int, w: int, k: np.ndarray, cam_pos: np.ndarray):
    """(H, W) bool: novel-view pixels showing far-plane content that the
    SOURCE camera (at the origin) cannot see past the near strip."""
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    k_inv = np.linalg.inv(k)
    rays = np.einsum(
        "ij,hwj->hwi", k_inv,
        np.stack([u, v, np.ones_like(u)], -1).astype(np.float64),
    )
    # far-plane intersection from the novel camera
    t_far = (FAR_DEPTH - cam_pos[2]) / rays[..., 2]
    x_far = cam_pos[None, None, :] + rays * t_far[..., None]
    # does the novel view see the far plane here? (the analytic renderer's
    # test on the near plane)
    t_near = (NEAR_DEPTH - cam_pos[2]) / rays[..., 2]
    x_near = cam_pos[None, None, :] + rays * t_near[..., None]
    sees_far = np.abs(x_near[..., 0]) >= _NEAR_HALF_WIDTH
    # the source ray to that far point crosses z=NEAR at x * NEAR/FAR
    shadowed = np.abs(x_far[..., 0]) * (NEAR_DEPTH / FAR_DEPTH) < _NEAR_HALF_WIDTH
    return sees_far & shadowed


def masked_psnr(a: np.ndarray, b: np.ndarray, mask: np.ndarray) -> float:
    if not mask.any():
        return float("nan")
    return psnr(a[mask], b[mask])


def analyse(model: torch.nn.Module, planes: int, fine_bins: int, layers: int, height: int,
            width: int, disparity_end: float, compositor: str = "dense",
            fine_u: torch.Tensor | None = None) -> dict:
    """The verdict's numbers for `model` (on its own device, in the
    configuration the other arguments describe)."""
    dev = next(model.parameters()).device
    h, w = height, width
    k_np = _intrinsics(h, w)
    cfg = build_cfg(h, w, batch=1, num_planes=planes, disparity_end=disparity_end,
                    num_layers=layers, num_bins_fine=fine_bins, compositor=compositor)
    oracle_cfg = cfg.replace(**{"mpi.use_alpha": True, "mpi.num_bins_fine": 0})
    disp_planes = np.linspace(1.0, disparity_end, planes, dtype=np.float32)
    disparity = torch.from_numpy(disp_planes)[None].to(dev)
    k = torch.from_numpy(k_np)[None].to(dev)
    poses = torch.from_numpy(poses_from_offsets(NOVEL_OFFSETS)).to(dev)

    crop = np.s_[CROP:-CROP, CROP:-CROP]
    # masks depend on pose geometry only, not on the scene's phase; the band
    # widens with |offset|, so disoccluded_px_frac pools every scored pose
    masks = [disocclusion_mask(h, w, k_np, -np.asarray(off, np.float64))[crop]
             for off in NOVEL_OFFSETS]
    acc: dict[str, list[float]] = {}

    def add(key: str, value: float) -> None:
        acc.setdefault(key, []).append(value)

    for ph in EVAL_PHASES:
        src_img, src_depth = _render_view(h, w, k_np, np.zeros(3), ph)
        trained = render_novel_poses(cfg, model, ph, fine_u)
        o_rgb, o_alpha = oracle_mpi(src_img, oracle_alphas(src_depth, disp_planes, "soft"), dev)
        oracle = render_many(oracle_cfg, o_rgb, o_alpha, disparity, k, poses)[0].cpu().numpy()
        for i, offset in enumerate(NOVEL_OFFSETS):
            want, _ = _render_view(h, w, k_np, -np.asarray(offset, np.float64), ph)
            mask = masks[i]
            want_c = want[crop]
            for name, got in (("trained", trained[i][crop]), ("oracle", oracle[i][crop])):
                add(f"{name}_disoccluded", masked_psnr(want_c, got, mask))
                add(f"{name}_visible", masked_psnr(want_c, got, ~mask))
                add(f"{name}_all", psnr(want_c, got))

    out = {
        "metric": METRIC,
        "planes": planes, "fine_bins": fine_bins,
        "n_scenes": len(EVAL_PHASES), "n_poses": len(NOVEL_OFFSETS),
        "disoccluded_px_frac": round(float(np.mean([m.mean() for m in masks])), 4),
    }
    out.update({key: round(float(np.nanmean(v)), 3) for key, v in acc.items()})
    out["inpainting_gain_db"] = round(out["trained_disoccluded"] - out["oracle_disoccluded"], 3)
    out["compositor"] = compositor
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True,
                    help="--save-final state_dict from mine_tpu_torch.tools.convergence_run")
    ap.add_argument("--planes", type=int, default=8)
    ap.add_argument("--fine-bins", type=int, default=0)
    ap.add_argument("--layers", type=int, default=18)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--disparity-end", type=float, default=0.2)
    ap.add_argument("--compositor", default="dense", choices=("dense", "streaming"),
                    help="mpi.compositor of the renders")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="workspace/artifacts/torch/disocclusion.json",
                    help="also write the JSON line here (empty disables the file copy)")
    args = ap.parse_args(argv)
    try:
        no_tf32()
        cfg = build_cfg(args.height, args.width, batch=1, num_planes=args.planes,
                        num_layers=args.layers, num_bins_fine=args.fine_bins)
        model = load_model(cfg, args.params, resolve_device(args.device))
        out = analyse(model, args.planes, args.fine_bins, args.layers, args.height,
                      args.width, args.disparity_end, args.compositor)
    except Exception as exc:  # noqa: BLE001 - the verdict line reports it
        return emit_failure(METRIC, exc, params=args.params)
    out["ok"] = all(math.isfinite(out[k]) for k in out
                    if k.startswith("oracle_") or k.endswith("_all"))
    out["launches"] = dict(kw.launches)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(out) + "\n")
    return emit(out)


if __name__ == "__main__":
    sys.exit(main())
