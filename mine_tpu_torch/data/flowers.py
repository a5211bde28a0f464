"""Flowers light-field dataset (the port's own copy of
mine_tpu/data/flowers.py; batches bit for bit the JAX package's).

The Flowers dataset (Srinivasan et al.'s Lytro light fields) ships each
sample as ONE image tiling the G x G grid of sub-aperture views; the
sub-aperture cameras form a planar translation array with a shared focal
length. Layout:

  * `<root>/meta.json`: {"grid": G, "focal_px": f, "baseline": b}: G x G
    views per sample, focal in pixels at the STORED sub-aperture
    resolution, baseline = camera spacing in scene units.
  * `<root>/grids[_val]/*.png`: the tiled light-field samples; each file is
    one scene of G*G posed frames.

Geometry: view (row r, col c) sits at t = baseline * (c - (G-1)/2,
r - (G-1)/2, 0) with identity rotation, so g_cam_world = [I | -t]; K has the
shared focal (per-axis rescaled stored -> target) and a centered principal
point. Light fields carry no sparse SfM tracks: frames ship `pts_cam=None`
(`flowers` is in training/step.py NO_DISP_SUPERVISION).
"""

from __future__ import annotations

import json
import os

import numpy as np
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.frames import PosedFrame, PosedFrameDataset
from mine_tpu_torch.data.image import read_rgb, resize_bicubic, to_unit_float


def load_meta(root: str) -> tuple[int, float, float]:
    """meta.json -> (grid, focal_px, baseline), validated."""
    path = os.path.join(root, "meta.json")
    try:
        with open(path) as fh:
            meta = json.load(fh)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"{path}: flowers needs the light-field metadata "
            '({"grid": G, "focal_px": f, "baseline": b})'
        ) from None
    try:
        grid = int(meta["grid"])
        focal = float(meta["focal_px"])
        baseline = float(meta["baseline"])
    except (KeyError, TypeError, ValueError) as exc:
        raise ValueError(f"{path}: bad metadata: {exc}") from None
    if grid < 2 or focal <= 0 or baseline <= 0:
        raise ValueError(
            f"{path}: grid must be >= 2 and focal_px/baseline > 0, got "
            f"grid={grid} focal_px={focal} baseline={baseline}"
        )
    return grid, focal, baseline


def load_grid(
    path: str, scene: str, grid: int, focal_px: float, baseline: float,
    img_hw: tuple[int, int],
) -> list[PosedFrame]:
    """One tiled light-field image -> G*G posed frames."""
    h, w = img_hw
    full = read_rgb(path)
    fh, fw = full.shape[:2]
    if fh % grid or fw % grid:
        raise ValueError(
            f"{path}: image {fw}x{fh} is not a {grid}x{grid} tiling "
            "(dimensions must divide by the grid)"
        )
    vh, vw = fh // grid, fw // grid
    center = (grid - 1) / 2.0
    frames: list[PosedFrame] = []
    for r in range(grid):
        for c in range(grid):
            view = full[r * vh:(r + 1) * vh, c * vw:(c + 1) * vw]
            img = to_unit_float(resize_bicubic(view, img_hw))
            k = np.array(
                [[focal_px * w / vw, 0.0, w / 2.0],
                 [0.0, focal_px * h / vh, h / 2.0],
                 [0.0, 0.0, 1.0]],
                dtype=np.float32,
            )
            t = baseline * np.array([c - center, r - center, 0.0])
            g = np.eye(4, dtype=np.float32)
            g[:3, 3] = -t  # world -> camera: X_cam = X_world - t
            frames.append(PosedFrame(
                scene=scene, img=img, k=k, g_cam_world=g,
                pts_cam=None,  # no sparse supervision (module docstring)
            ))
    return frames


class FlowersDataset(PosedFrameDataset):
    """Loader-protocol dataset over tiled light-field samples; target
    candidates are the other sub-aperture views of the same sample."""

    def __init__(self, cfg: Config, split: str, global_batch: int,
                 host_slice: tuple[int, int] | None = None):
        root = cfg.data.training_set_path
        grid, focal_px, baseline = load_meta(root)
        folder = "grids_val" if split == "val" else "grids"
        grid_dir = os.path.join(root, folder)
        if not os.path.isdir(grid_dir):
            raise FileNotFoundError(
                f"no {folder}/ under {root!r} (tiled light-field samples)"
            )
        frames: list[PosedFrame] = []
        for name in sorted(os.listdir(grid_dir)):
            if os.path.splitext(name)[1].lower() not in (".png", ".jpg",
                                                         ".jpeg"):
                continue
            frames.extend(load_grid(
                os.path.join(grid_dir, name), os.path.splitext(name)[0],
                grid, focal_px, baseline,
                (cfg.data.img_h, cfg.data.img_w),
            ))
        if not frames:
            raise FileNotFoundError(f"no light-field samples in {grid_dir!r}")
        super().__init__(cfg, split, global_batch, frames,
                         host_slice=host_slice)
