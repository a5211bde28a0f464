"""KITTI raw dataset (the port's own copy of mine_tpu/data/kitti.py;
batches bit for bit the JAX package's).

Layout per drive (the KITTI wire formats, trimmed to what the recipe needs:
the monocular left-color stream + poses):

  * `<root>/<drive>/image_02/data[_val]/*.png`: the rectified left color
    frames; the filename stem is the frame index (KITTI's zero-padded
    numbering).
  * `<root>/<drive>/poses[_val].txt`: one row-major 3x4 CAM-to-WORLD
    matrix per frame index (the KITTI odometry pose convention).
  * `<root>/<drive>/calib.txt`: the `P2:` projection row of the rectified
    left color camera (12 values; fx = P[0], cx = P[2], fy = P[5],
    cy = P[6] at the STORED frame resolution).

K scales per-axis from the stored frame size to the target (img_h, img_w)
like the COLMAP loaders. KITTI carries no per-frame sparse point tracks in
this stream, so frames ship `pts_cam=None`: the recipe trains WITHOUT
sparse-depth supervision (`kitti_raw` is in training/step.py's
NO_DISP_SUPERVISION, the contract's `sparse_depth=False`).
"""

from __future__ import annotations

import os

import numpy as np
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.frames import PosedFrame, PosedFrameDataset
from mine_tpu_torch.data.image import read_rgb, resize_bicubic, to_unit_float

# target candidates: same-drive frames within this many list positions
# (KITTI is 10 Hz video; nearby frames give usable stereo-like baselines)
FRAME_WINDOW = 10


def parse_calib(path: str) -> np.ndarray:
    """`P2:` row of a KITTI calib file -> (3, 4) projection matrix."""
    with open(path) as fh:
        for line in fh:
            key, _, rest = line.partition(":")
            if key.strip() == "P2":
                vals = [float(v) for v in rest.split()]
                if len(vals) != 12:
                    raise ValueError(
                        f"{path}: P2 row has {len(vals)} values, expected 12"
                    )
                return np.asarray(vals, np.float64).reshape(3, 4)
    raise ValueError(f"{path}: no P2 row (rectified left color projection)")


def parse_poses(path: str) -> np.ndarray:
    """Pose file -> (N, 4, 4) cam-to-world stack."""
    rows = np.loadtxt(path, dtype=np.float64)
    rows = np.atleast_2d(rows)
    if rows.shape[1] != 12:
        raise ValueError(
            f"{path}: pose rows must be 12 values (3x4 cam-to-world), got "
            f"{rows.shape[1]}"
        )
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :4] = rows.reshape(-1, 3, 4)
    return out


def load_drive(
    drive_dir: str, split: str, img_hw: tuple[int, int]
) -> list[PosedFrame]:
    """Load every posed frame of one drive directory."""
    suffix = "_val" if split == "val" else ""
    image_dir = os.path.join(drive_dir, "image_02", "data" + suffix)
    if not os.path.isdir(image_dir):
        return []
    p2 = parse_calib(os.path.join(drive_dir, "calib.txt"))
    c2w = parse_poses(os.path.join(drive_dir, f"poses{suffix}.txt"))
    drive = os.path.basename(drive_dir.rstrip("/"))

    h, w = img_hw
    frames: list[PosedFrame] = []
    for name in sorted(os.listdir(image_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        try:
            frame_idx = int(stem)
        except ValueError:
            raise ValueError(
                f"{image_dir}/{name}: filename stem must be the KITTI frame "
                "index (the pose-row key)"
            ) from None
        if frame_idx >= len(c2w):
            raise ValueError(
                f"{image_dir}/{name}: frame index {frame_idx} beyond the "
                f"{len(c2w)} rows of poses{suffix}.txt — truncated pose file?"
            )
        stored = read_rgb(os.path.join(image_dir, name))
        stored_h, stored_w = stored.shape[:2]
        img = to_unit_float(resize_bicubic(stored, img_hw))
        # P2 intrinsics live at the stored frame resolution; per-axis
        # rescale to the target exactly like the COLMAP loaders
        k = np.array(
            [[p2[0, 0] * w / stored_w, 0.0, p2[0, 2] * w / stored_w],
             [0.0, p2[1, 1] * h / stored_h, p2[1, 2] * h / stored_h],
             [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )
        g_cam_world = np.linalg.inv(c2w[frame_idx]).astype(np.float32)
        frames.append(PosedFrame(
            scene=drive, img=img, k=k, g_cam_world=g_cam_world,
            pts_cam=None,  # no sparse supervision (module docstring)
        ))
    return frames


class KittiRawDataset(PosedFrameDataset):
    """Loader-protocol dataset over KITTI drive directories."""

    def __init__(self, cfg: Config, split: str, global_batch: int,
                 host_slice: tuple[int, int] | None = None):
        root = cfg.data.training_set_path
        frames: list[PosedFrame] = []
        for drive in sorted(os.listdir(root)):
            drive_dir = os.path.join(root, drive)
            if not os.path.isdir(drive_dir):
                continue
            frames.extend(load_drive(
                drive_dir, split, (cfg.data.img_h, cfg.data.img_w)
            ))
        if not frames:
            raise FileNotFoundError(
                f"no KITTI frames under {root!r} "
                f"(expected <drive>/image_02/data"
                f"{'_val' if split == 'val' else ''}/)"
            )
        super().__init__(cfg, split, global_batch, frames,
                         host_slice=host_slice)

    def candidate_targets(self, src_idx: int) -> list[int]:
        # nearby-frame pairs; per-drive indices are contiguous
        return [
            i for i in self.scene_indices[self.frames[src_idx].scene]
            if i != src_idx and abs(i - src_idx) <= FRAME_WINDOW
        ]

    def _validate_candidates(self) -> None:
        if self.num_tgt_views > FRAME_WINDOW:
            raise ValueError(
                f"data.num_tgt_views={self.num_tgt_views} exceeds the "
                f"±{FRAME_WINDOW}-frame candidate window"
            )
        for drive, idxs in self.scene_indices.items():
            if len(idxs) < self.num_tgt_views + 1:
                raise ValueError(
                    f"drive {drive} has {len(idxs)} frame(s); need >= "
                    f"{self.num_tgt_views + 1}"
                )
