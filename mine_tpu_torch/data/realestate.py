"""RealEstate10K dataset (the port's own copy of mine_tpu/data/realestate.py;
batches bit for bit the JAX package's).

Protocol: the camera-trajectory txt format defined with the dataset and
used by the single-view MPI line of work ("Single-View View Synthesis with
Multiplane Images", arxiv 2004.11364, §4):

  * `<root>/<split>/<sequence>.txt`: line 1 is the source video URL; every
    following line is one frame,
    `timestamp fx fy cx cy k1 k2 p11 p12 p13 p14 ... p34`,
    where (fx, fy, cx, cy) are intrinsics NORMALIZED by image width/height
    and p11..p34 is the row-major 3x4 world-to-camera pose.
  * `<root>/frames/<sequence>/<timestamp>.png`: the extracted frames.
  * `<root>/points/<sequence>.npz` (key `xyz`, (N, 3) world points): the
    SfM sparse cloud the scale-invariant depth supervision needs
    (realestate10k is NOT in training/step.py NO_DISP_SUPERVISION, so a
    missing cloud is a loud error).

Normalized intrinsics are resolution-independent, so K at the target
(img_h, img_w) is exact. Per-frame sparse points are the world cloud
transformed to the camera, culled to in-view (z past the shared near cull,
projecting inside the image).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.frames import (
    PosedFrame,
    PosedFrameDataset,
    cull_near_points,
)
from mine_tpu_torch.data.image import read_rgb, resize_bicubic, to_unit_float

# target candidates: same-sequence frames within this many list positions —
# the small-baseline pair sampling the RealEstate10K MPI protocol trains on
# (2004.11364 samples nearby video frames)
FRAME_WINDOW = 10


@dataclass
class CameraLine:
    timestamp: str
    k_norm: np.ndarray  # (fx, fy, cx, cy) normalized by (W, H, W, H)
    g_cam_world: np.ndarray  # (4, 4) world -> camera


def parse_camera_file(path: str) -> tuple[str, list[CameraLine]]:
    """One sequence txt -> (video url, per-frame camera lines). Fails with
    the offending line number on malformed rows (truncated downloads are
    the common real-world corruption)."""
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty camera file")
    url, rows = lines[0], []
    for lineno, line in enumerate(lines[1:], start=2):
        parts = line.split()
        if len(parts) != 19:
            raise ValueError(
                f"{path}:{lineno}: expected 19 fields "
                f"(timestamp, 4 intrinsics, 2 distortion, 12 pose), got "
                f"{len(parts)}"
            )
        vals = np.asarray([float(v) for v in parts[1:]], np.float64)
        g = np.eye(4, dtype=np.float64)
        g[:3, :4] = vals[6:18].reshape(3, 4)
        rows.append(CameraLine(
            timestamp=parts[0], k_norm=vals[0:4], g_cam_world=g,
        ))
    return url, rows


def _pixel_intrinsics(k_norm: np.ndarray, img_hw: tuple[int, int]) -> np.ndarray:
    h, w = img_hw
    fx, fy, cx, cy = k_norm
    return np.array(
        [[fx * w, 0.0, cx * w], [0.0, fy * h, cy * h], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def load_sequence(
    root: str, split: str, seq: str, img_hw: tuple[int, int],
    min_points: int = 1,
) -> list[PosedFrame]:
    """Load every posed frame of one sequence whose image exists on disk."""
    _, rows = parse_camera_file(os.path.join(root, split, seq + ".txt"))
    pts_path = os.path.join(root, "points", seq + ".npz")
    if not os.path.exists(pts_path):
        raise FileNotFoundError(
            f"{pts_path}: sequence {seq} has no SfM point cloud — "
            "realestate10k trains with sparse-depth calibration "
            "(see module docstring for the expected layout)"
        )
    world = np.asarray(np.load(pts_path)["xyz"], np.float64)
    if world.ndim != 2 or world.shape[1] != 3:
        raise ValueError(f"{pts_path}: xyz must be (N, 3), got {world.shape}")
    homo = np.concatenate([world, np.ones((len(world), 1))], axis=1)

    h, w = img_hw
    frames: list[PosedFrame] = []
    for row in rows:
        img_path = os.path.join(root, "frames", seq, row.timestamp + ".png")
        if not os.path.exists(img_path):
            continue  # the txt indexes the full video; only some frames ship
        img = to_unit_float(resize_bicubic(read_rgb(img_path), img_hw))
        k = _pixel_intrinsics(row.k_norm, img_hw)
        cam = (row.g_cam_world @ homo.T).T[:, :3]
        pts_cam, _ = cull_near_points(cam.astype(np.float32))
        # keep only points this camera actually sees: the cloud is
        # sequence-global, unlike COLMAP's per-image tracks
        uvw = pts_cam @ k.T
        uv = uvw[:, :2] / uvw[:, 2:3]
        inside = (
            (uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        )
        pts_cam = pts_cam[inside]
        if len(pts_cam) < min_points:
            raise ValueError(
                f"{img_path}: {len(pts_cam)} in-view SfM points < required "
                f"{min_points} ({len(world)} in the sequence cloud) — "
                "frame/point-cloud mismatch?"
            )
        frames.append(PosedFrame(
            scene=seq, img=img, k=k,
            g_cam_world=row.g_cam_world.astype(np.float32),
            pts_cam=pts_cam,
        ))
    return frames


class RealEstateDataset(PosedFrameDataset):
    """Loader-protocol dataset over RealEstate10K camera-txt sequences."""

    def __init__(self, cfg: Config, split: str, global_batch: int,
                 host_slice: tuple[int, int] | None = None):
        root = cfg.data.training_set_path
        split_dir = os.path.join(root, split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(
                f"no {split!r} split under {root!r} (expected "
                f"{split_dir}/<sequence>.txt camera files)"
            )
        frames: list[PosedFrame] = []
        for name in sorted(os.listdir(split_dir)):
            if not name.endswith(".txt"):
                continue
            frames.extend(load_sequence(
                root, split, name[:-4],
                (cfg.data.img_h, cfg.data.img_w),
            ))
        if not frames:
            raise FileNotFoundError(
                f"no posed frames under {root!r} ({split} split)"
            )
        super().__init__(cfg, split, global_batch, frames,
                         host_slice=host_slice)

    def candidate_targets(self, src_idx: int) -> list[int]:
        # nearby-frame pairs (the protocol's small-baseline sampling);
        # per-sequence frame indices are contiguous by construction
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
        # contiguous per-sequence indices: an edge frame of a sequence with
        # >= k+1 frames always has min(window, len-1) >= k in-window
        # neighbors once num_tgt_views <= FRAME_WINDOW holds
        for seq, idxs in self.scene_indices.items():
            if len(idxs) < self.num_tgt_views + 1:
                raise ValueError(
                    f"sequence {seq} has {len(idxs)} frame(s); need >= "
                    f"{self.num_tgt_views + 1}"
                )
