"""DTU multi-view dataset (the port's own copy of mine_tpu/data/dtu.py;
batches bit for bit the JAX package's).

Layout per scan, the MVSNet-lineage camera convention DTU is almost always
distributed in:

  * `<root>/<scan>/images[_val]/<id>.png`: the posed views.
  * `<root>/<scan>/cams/<id>_cam.txt`: per-view camera file:

        extrinsic
        <4x4 world-to-camera, row per line>

        intrinsic
        <3x3 K at the stored image resolution>

    (a trailing `depth_min depth_interval` line may follow; ignored: the
    recipe's mpi.disparity_start/end carry the sweep range).

Val views are a held-out id set in `images_val/`, sharing the one `cams/`
directory. K rescales per-axis from the stored image size to the target.
MINE's dtu recipe trains without sparse-depth supervision (`dtu` is in
training/step.py NO_DISP_SUPERVISION): frames ship `pts_cam=None`.
"""

from __future__ import annotations

import os

import numpy as np
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.frames import PosedFrame, PosedFrameDataset
from mine_tpu_torch.data.image import read_rgb, resize_bicubic, to_unit_float


def parse_cam_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """MVSNet cam.txt -> (extrinsic (4,4) world-to-camera, intrinsic (3,3)
    at stored resolution)."""
    with open(path) as fh:
        tokens = fh.read().split()
    try:
        e_at = tokens.index("extrinsic")
        i_at = tokens.index("intrinsic")
    except ValueError:
        raise ValueError(
            f"{path}: missing 'extrinsic'/'intrinsic' section headers "
            "(MVSNet cam.txt format)"
        ) from None
    try:
        extr = np.asarray(
            [float(v) for v in tokens[e_at + 1:e_at + 17]], np.float64
        ).reshape(4, 4)
        intr = np.asarray(
            [float(v) for v in tokens[i_at + 1:i_at + 10]], np.float64
        ).reshape(3, 3)
    except ValueError as exc:
        raise ValueError(f"{path}: malformed camera matrix: {exc}") from None
    return extr, intr


def load_scan(
    scan_dir: str, split: str, img_hw: tuple[int, int]
) -> list[PosedFrame]:
    """Load every posed view of one scan directory."""
    suffix = "_val" if split == "val" else ""
    image_dir = os.path.join(scan_dir, "images" + suffix)
    if not os.path.isdir(image_dir):
        return []
    scan = os.path.basename(scan_dir.rstrip("/"))
    h, w = img_hw
    frames: list[PosedFrame] = []
    for name in sorted(os.listdir(image_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        cam_path = os.path.join(scan_dir, "cams", f"{stem}_cam.txt")
        if not os.path.exists(cam_path):
            raise FileNotFoundError(
                f"{image_dir}/{name}: no paired camera file {cam_path}"
            )
        extr, intr = parse_cam_file(cam_path)
        stored = read_rgb(os.path.join(image_dir, name))
        stored_h, stored_w = stored.shape[:2]
        img = to_unit_float(resize_bicubic(stored, img_hw))
        k = np.array(
            [[intr[0, 0] * w / stored_w, 0.0, intr[0, 2] * w / stored_w],
             [0.0, intr[1, 1] * h / stored_h, intr[1, 2] * h / stored_h],
             [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )
        frames.append(PosedFrame(
            scene=scan, img=img, k=k,
            g_cam_world=extr.astype(np.float32),
            pts_cam=None,  # no sparse supervision (module docstring)
        ))
    return frames


class DTUDataset(PosedFrameDataset):
    """Loader-protocol dataset over DTU scan directories; target candidates
    are all other views of the scan (DTU cameras all see the one object —
    no temporal window)."""

    def __init__(self, cfg: Config, split: str, global_batch: int,
                 host_slice: tuple[int, int] | None = None):
        root = cfg.data.training_set_path
        frames: list[PosedFrame] = []
        for scan in sorted(os.listdir(root)):
            scan_dir = os.path.join(root, scan)
            if not os.path.isdir(scan_dir):
                continue
            frames.extend(load_scan(
                scan_dir, split, (cfg.data.img_h, cfg.data.img_w)
            ))
        if not frames:
            raise FileNotFoundError(
                f"no DTU views under {root!r} (expected <scan>/images"
                f"{'_val' if split == 'val' else ''}/ + <scan>/cams/)"
            )
        super().__init__(cfg, split, global_batch, frames,
                         host_slice=host_slice)
