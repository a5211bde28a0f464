"""Deterministic on-disk fixtures (the port's own copy of
mine_tpu/data/conformance/fixtures.py): one writer per dataset family, all
rendering the SAME analytic two-plane scene (data/synthetic.py: a textured
far plane at z=4, a near occluder strip at z=1, cameras translated along
+x), so every loader in the registry runs with nothing downloaded, and the
geometry each loader reconstructs is knowable in closed form.

Each writer lays the scene down in its family's REAL wire format: COLMAP
binary models, RealEstate10K camera-txt lines, KITTI calib/pose files,
MVSNet cam.txt grids, tiled light fields, Objectron metadata pickles. All
writers are seeded: the same call writes the same files, byte-equal to the
JAX package's writers (the PNGs decode to equal pixels; an .npz holds equal
arrays, its zip container carries the time it was written).

`write_fixture(family, root)` dispatches; it returns the path to use as
`data.training_set_path` ('' for the procedural synthetic family).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from mine_tpu_torch.data.image import as_image, rotate_cw, save_png
from mine_tpu_torch.data.synthetic import (
    _intrinsics,
    _render_view,
    _sample_points,
    write_colmap_scene,
)

# train cameras sit at BASELINE * i along +x (write_colmap_scene idiom);
# val cameras offset half a step so no val pose equals a train pose
BASELINE = 0.06


def _save_png(img01: np.ndarray, path: str) -> None:
    save_png((np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8), path)


def _cam_positions(n: int, val: bool = False) -> list[np.ndarray]:
    off = BASELINE / 2 if val else 0.0
    return [np.array([BASELINE * i + off, 0.02 * i + off / 3, 0.0])
            for i in range(n)]


# -- per-family writers ------------------------------------------------------


def write_llff_fixture(root: str, hw=(64, 64), n_views: int = 4,
                       n_val_views: int = 3) -> str:
    """LLFF: COLMAP sparse/0 binary model + images[_val]/ (the shared
    write_colmap_scene)."""
    write_colmap_scene(root, "scene_a", n_views=n_views, hw=hw,
                       n_val_views=n_val_views)
    return root


def write_nocs_fixture(root: str, n_views: int = 4,
                       n_val_views: int = 3) -> str:
    """NOCS: same COLMAP layout, images stored at EXACTLY 640x384 so the
    loader's hardcoded (384, 640) center crop is the identity and the
    crop-shifted principal point stays put (data/llff.py)."""
    write_colmap_scene(root, "scene_a", n_views=n_views, hw=(384, 640),
                       n_val_views=n_val_views)
    return root


def write_realestate_fixture(root: str, hw=(64, 64), n_frames: int = 4,
                             n_val_frames: int = 3) -> str:
    """RealEstate10K: <split>/<seq>.txt camera lines (19 normalized
    fields), frames/<seq>/<timestamp>.png, points/<seq>.npz SfM cloud."""
    h, w = hw
    k = _intrinsics(h, w)
    rng = np.random.default_rng(7)
    world = _sample_points(rng, 64, np.zeros(3)).astype(np.float64)

    for split, n, val in (("train", n_frames, False),
                          ("val", n_val_frames, True)):
        seq = f"seq_{split}"
        os.makedirs(os.path.join(root, split), exist_ok=True)
        os.makedirs(os.path.join(root, "frames", seq), exist_ok=True)
        os.makedirs(os.path.join(root, "points"), exist_ok=True)
        np.savez(os.path.join(root, "points", seq + ".npz"), xyz=world)
        lines = [f"https://example.test/{seq}"]
        for i, pos in enumerate(_cam_positions(n, val)):
            ts = str(100 + i)
            img, _ = _render_view(h, w, k, pos, phase=0.3)
            _save_png(img, os.path.join(root, "frames", seq, ts + ".png"))
            pose = np.eye(4)[:3, :4].copy()
            pose[:, 3] = -pos  # world -> camera: [I | -pos]
            vals = [
                k[0, 0] / w, k[1, 1] / h, k[0, 2] / w, k[1, 2] / h,
                0.0, 0.0, *pose.reshape(-1),
            ]
            lines.append(ts + " " + " ".join(f"{v:.9f}" for v in vals))
        with open(os.path.join(root, split, seq + ".txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return root


def write_kitti_fixture(root: str, hw=(64, 64), n_frames: int = 4,
                        n_val_frames: int = 3) -> str:
    """KITTI raw: <drive>/image_02/data[_val]/<idx>.png + poses[_val].txt
    (3x4 cam-to-world rows) + calib.txt (P2 row at stored resolution)."""
    h, w = hw
    k = _intrinsics(h, w)
    drive = os.path.join(root, "2011_09_26_drive_0001_sync")
    p2 = np.zeros((3, 4))
    p2[:3, :3] = k
    os.makedirs(drive, exist_ok=True)
    with open(os.path.join(drive, "calib.txt"), "w") as fh:
        fh.write("P0: " + " ".join(["0.0"] * 12) + "\n")
        fh.write("P2: " + " ".join(f"{v:.9f}" for v in p2.reshape(-1)) + "\n")
    for suffix, n, val in (("", n_frames, False),
                           ("_val", n_val_frames, True)):
        img_dir = os.path.join(drive, "image_02", "data" + suffix)
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i, pos in enumerate(_cam_positions(n, val)):
            img, _ = _render_view(h, w, k, pos, phase=0.3)
            _save_png(img, os.path.join(img_dir, f"{i:010d}.png"))
            c2w = np.eye(4)
            c2w[:3, 3] = pos
            rows.append(" ".join(f"{v:.9f}" for v in c2w[:3, :4].reshape(-1)))
        with open(os.path.join(drive, f"poses{suffix}.txt"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return root


def write_dtu_fixture(root: str, hw=(64, 64), n_views: int = 4,
                      n_val_views: int = 3) -> str:
    """DTU: <scan>/images[_val]/<id>.png + <scan>/cams/<id>_cam.txt
    (MVSNet extrinsic/intrinsic sections)."""
    h, w = hw
    k = _intrinsics(h, w)
    scan = os.path.join(root, "scan1")
    os.makedirs(os.path.join(scan, "cams"), exist_ok=True)
    view_id = 0
    for folder, n, val in (("images", n_views, False),
                           ("images_val", n_val_views, True)):
        img_dir = os.path.join(scan, folder)
        os.makedirs(img_dir, exist_ok=True)
        for pos in _cam_positions(n, val):
            stem = f"{view_id:08d}"
            img, _ = _render_view(h, w, k, pos, phase=0.3)
            _save_png(img, os.path.join(img_dir, stem + ".png"))
            extr = np.eye(4)
            extr[:3, 3] = -pos  # world -> camera
            with open(os.path.join(scan, "cams", stem + "_cam.txt"),
                      "w") as fh:
                fh.write("extrinsic\n")
                for row in extr:
                    fh.write(" ".join(f"{v:.9f}" for v in row) + "\n")
                fh.write("\nintrinsic\n")
                for row in k:
                    fh.write(" ".join(f"{v:.9f}" for v in row) + "\n")
                fh.write("\n425.0 2.5\n")  # depth_min/interval: ignored
            view_id += 1
    return root


def write_flowers_fixture(root: str, hw=(64, 64), grid: int = 3,
                          n_samples: int = 1, n_val_samples: int = 1) -> str:
    """Flowers: meta.json + grids[_val]/<sample>.png tiled G x G
    sub-aperture views of the analytic scene (planar camera array)."""
    h, w = hw
    k = _intrinsics(h, w)
    center = (grid - 1) / 2.0
    baseline = 0.08
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "meta.json"), "w") as fh:
        json.dump({"grid": grid, "focal_px": float(k[0, 0]),
                   "baseline": baseline}, fh)
    # square views keep the scalar focal exact on both axes
    assert h == w, "flowers fixture uses square sub-aperture views"
    for folder, n, phase0 in (("grids", n_samples, 0.3),
                              ("grids_val", n_val_samples, 1.1)):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        for s in range(n):
            tile = np.zeros((grid * h, grid * w, 3), np.float32)
            for r in range(grid):
                for c in range(grid):
                    pos = baseline * np.array(
                        [c - center, r - center, 0.0]
                    )
                    img, _ = _render_view(h, w, k, pos,
                                          phase=phase0 + 0.7 * s)
                    tile[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
            _save_png(tile, os.path.join(root, folder, f"sample_{s}.png"))
    return root


def write_objectron_fixture(root: str, hw=(64, 64), n_frames: int = 6,
                            n_val_frames: int = 3) -> str:
    """Objectron: <scene>/<scene>_metadata.pickle + mask-driven frame
    lists in masks_3[_val]/ + images_3[_val]/ (the reference's layout).
    Frame indices: train 0..n-1, val n..n+m-1, all posed in ONE metadata
    pose array (how real scenes store their held-out tail)."""
    from mine_tpu_torch.data.objectron import ADJUST

    h, w = hw
    k = _intrinsics(h, w)
    scene = "chair_batch-1_0"
    scene_dir = os.path.join(root, scene)
    for d in ("images_3", "masks_3", "images_3_val", "masks_3_val"):
        os.makedirs(os.path.join(scene_dir, d), exist_ok=True)

    rng = np.random.default_rng(11)
    # tight world cloud in front of the cameras (|xy| small at z ~ 0.4:
    # projects inside even the smallest fixture frames)
    world_pts = rng.uniform(-0.08, 0.08, size=(64, 3)) + np.array([0, 0, 0.4])

    poses, focals, centers = [], [], []
    total = n_frames + n_val_frames
    for i in range(total):
        g_cam_world = np.eye(4)
        g_cam_world[:3, 3] = [0.01 * i, 0.0, 0.0]
        # reference stores c2w with G = inv(c2w @ ADJUST)
        poses.append(np.linalg.inv(g_cam_world) @ np.linalg.inv(ADJUST))
        focals.append([float(k[0, 0]), float(k[1, 1])])
        centers.append([w / 2, h / 2])

        suffix = "" if i < n_frames else "_val"
        img, _ = _render_view(h, w, k, np.array([0.01 * i, 0.0, 0.0]),
                              phase=0.3)
        # image is rotated 90° CCW at load; store pre-rotated so the
        # loaded frame lands at (h, w)
        save_png(rotate_cw(as_image((img * 255).astype(np.uint8))),
                 os.path.join(scene_dir, "images_3" + suffix, f"{i}.png"))
        save_png(np.zeros((8, 8), np.uint8),
                 os.path.join(scene_dir, "masks_3" + suffix, f"seg_{i}.png"))

    with open(os.path.join(scene_dir, f"{scene}_metadata.pickle"),
              "wb") as fh:
        pickle.dump({
            "poses": np.stack(poses),
            "focal": np.array(focals),
            "c": np.array(centers),
            "RT": np.eye(4),
            "scale": 1.0,
            "all_scene_points": world_pts,
        }, fh)
    return root


def write_synthetic_fixture(root: str, **_) -> str:
    """Synthetic is procedural: nothing on disk, empty set path."""
    return ""


_WRITERS = {
    "llff": write_llff_fixture,
    "nocs_llff": write_nocs_fixture,
    "objectron": write_objectron_fixture,
    "realestate10k": write_realestate_fixture,
    "kitti_raw": write_kitti_fixture,
    "dtu": write_dtu_fixture,
    "flowers": write_flowers_fixture,
    "synthetic": write_synthetic_fixture,
}


def write_fixture(family: str, root: str, **kwargs) -> str:
    """Write `family`'s fixture under `root`; returns the
    data.training_set_path to point the config at."""
    try:
        writer = _WRITERS[family]
    except KeyError:
        raise KeyError(
            f"no fixture writer for family {family!r}; have: "
            f"{', '.join(sorted(_WRITERS))}"
        ) from None
    os.makedirs(root, exist_ok=True)
    return writer(root, **kwargs)
