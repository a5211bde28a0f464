"""Camera-path generation for novel-view videos (the port's own copy of
mine_tpu/inference/trajectory.py).

Reference: visualizations/image_to_video.py:24-50 (path_planning) and
:158-192 (per-dataset shift ranges). Pure numpy on the host — trajectories
are tiny (N,3) arrays; only the renderer runs on device.
"""

from __future__ import annotations

import numpy as np

# Per-dataset trajectory recipes (image_to_video.py:158-177). Keys are
# config `data.name` values; every supported dataset renders a zoom-in
# (double-straight-line) and a swing (circle).
_DEFAULT_PRESET = {
    "fps": 30,
    "num_frames": 90,
    "x_shift_range": (0.0, -0.16),
    "y_shift_range": (0.0, -0.0),
    "z_shift_range": (-0.30, -0.2),
    "traj_types": ("double-straight-line", "circle"),
    "name": ("zoom-in", "swing"),
}
TRAJECTORY_PRESETS: dict[str, dict] = {
    "kitti_raw": {
        **_DEFAULT_PRESET,
        "x_shift_range": (0.0, -0.8),
        "z_shift_range": (-1.5, -1.0),
    },
    **{
        name: dict(_DEFAULT_PRESET)
        for name in (
            "nyu", "ibims", "realestate10k", "llff", "objectron",
            "nocs_llff", "synthetic",
        )
    },
}


def trajectory_preset(dataset_name: str) -> dict:
    """Shift ranges / fps / frame count for a dataset (image_to_video.py:158-177)."""
    try:
        return dict(TRAJECTORY_PRESETS[dataset_name])
    except KeyError:
        raise ValueError(
            f"no trajectory preset for dataset {dataset_name!r}; "
            f"known: {sorted(TRAJECTORY_PRESETS)}"
        ) from None


def _quadratic_through(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Quadratic Lagrange interpolation through 3 points at t=0, .5, 1
    (the scipy interp1d(kind='quadratic') call at image_to_video.py:29,
    without the scipy dependency)."""
    p0, p1, p2 = points
    l0 = (t - 0.5) * (t - 1.0) / ((0.0 - 0.5) * (0.0 - 1.0))
    l1 = (t - 0.0) * (t - 1.0) / ((0.5 - 0.0) * (0.5 - 1.0))
    l2 = (t - 0.0) * (t - 0.5) / ((1.0 - 0.0) * (1.0 - 0.5))
    return l0[:, None] * p0 + l1[:, None] * p1 + l2[:, None] * p2


def path_planning(
    num_frames: int, x: float, y: float, z: float, path_type: str, s: float = 0.3
) -> np.ndarray:
    """Camera-center offsets along a canned path, (N, 3) float64
    (image_to_video.py:24-50; N == num_frames for straight-line/circle,
    2 * (num_frames // 2) for double-straight-line — same as the reference's
    concat of two int(num_frames*0.5) halves)."""
    shift = np.array([x, y, z], dtype=np.float64)
    if path_type == "straight-line":
        corners = np.stack([np.zeros(3), 0.5 * shift, shift])
        t = np.linspace(0.0, 1.0, num_frames)
        return _quadratic_through(corners, t)
    if path_type == "double-straight-line":
        # linear from s*shift out to -shift, then retrace backwards
        t = np.linspace(0.0, 1.0, int(num_frames * 0.5))
        fwd = (1.0 - t)[:, None] * (s * shift)[None] + t[:, None] * (-shift)[None]
        return np.concatenate([fwd, np.flip(fwd, axis=0)], axis=0)
    if path_type == "circle":
        v = np.arange(-2.0, 2.0, 4.0 / num_frames)
        xs = np.cos(v * np.pi) * x
        ys = np.sin(v * np.pi) * y
        zs = np.cos(v * np.pi / 2.0) * z - s * z
        return np.stack([xs, ys, zs], axis=-1)
    raise ValueError(f"unknown path type {path_type!r}")


def poses_from_offsets(offsets: np.ndarray) -> np.ndarray:
    """Offsets (N, 3) -> G_tgt_src stack (N, 4, 4): identity rotation with the
    offset as translation (image_to_video.py:179-191)."""
    n = offsets.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
    poses[:, :3, 3] = offsets.astype(np.float32)
    return poses


def camera_trajectories(dataset_name: str) -> tuple[list[tuple[str, np.ndarray]], int]:
    """All canned trajectories for a dataset.

    Returns ([(name, poses (N,4,4)), ...], fps) — one entry per preset
    trajectory type (zoom-in, swing).
    """
    preset = trajectory_preset(dataset_name)
    out = []
    for i, traj_type in enumerate(preset["traj_types"]):
        offsets = path_planning(
            preset["num_frames"],
            preset["x_shift_range"][i],
            preset["y_shift_range"][i],
            preset["z_shift_range"][i],
            path_type=traj_type,
        )
        out.append((preset["name"][i], poses_from_offsets(offsets)))
    return out, preset["fps"]
