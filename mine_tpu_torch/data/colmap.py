"""COLMAP sparse-model I/O (the port's own copy of mine_tpu/data/colmap.py):
cameras / images / points3D, binary and text.

From the COLMAP file-format spec (scripts/python/read_write_model.py
documents it):

  cameras.bin : u64 count; per camera: i32 id, i32 model_id, u64 w, u64 h,
                f64 params[num_params(model)]
  images.bin  : u64 count; per image: i32 id, f64 qvec[4], f64 tvec[3],
                i32 camera_id, cstring name, u64 n_pts, (f64 x, f64 y,
                i64 point3D_id)[n_pts]
  points3D.bin: u64 count; per point: i64 id, f64 xyz[3], u8 rgb[3],
                f64 error, u64 track_len, (i32 image_id, i32 p2d_idx)[len]

The writers make the test fixtures (data/conformance/fixtures.py) and write
the same bytes as the JAX package's.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass(frozen=True)
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # (num_params,) f64


@dataclass(frozen=True)
class ImageMeta:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2) keypoints
    point3d_ids: np.ndarray  # (N,) i64, -1 = untracked


@dataclass(frozen=True)
class Point3D:
    id: int
    xyz: np.ndarray  # (3,)
    rgb: np.ndarray  # (3,) u8
    error: float


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion -> rotation matrix (colmap_utils.py:454-464)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
    ])


def rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (for the test-fixture writers)."""
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
        [r[0, 1] + r[1, 0], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
        [r[0, 2] + r[2, 0], r[1, 2] + r[2, 1], r[2, 2] - r[0, 0] - r[1, 1], 0],
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1],
         r[0, 0] + r[1, 1] + r[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ------------------------------- binary IO ---------------------------------


def _read(fh, fmt: str):
    return struct.unpack(fmt, fh.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, Camera]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(fh, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            out[cam_id] = Camera(cam_id, name, w, h, params)
    return out


def read_images_binary(path: str) -> dict[int, ImageMeta]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            img_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            (camera_id,) = _read(fh, "<i")
            name = b""
            while (c := fh.read(1)) != b"\x00":
                name += c
            (n_pts,) = _read(fh, "<Q")
            data = np.frombuffer(
                fh.read(24 * n_pts), dtype=[("xy", "<2f8"), ("id", "<i8")]
            )
            out[img_id] = ImageMeta(
                img_id, qvec, tvec, camera_id, name.decode(),
                data["xy"].reshape(-1, 2).copy(), data["id"].copy(),
            )
    return out


def read_points3d_binary(path: str) -> dict[int, Point3D]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            pt_id = _read(fh, "<q")[0]
            xyz = np.array(_read(fh, "<3d"))
            rgb = np.array(_read(fh, "<3B"), dtype=np.uint8)
            (error,) = _read(fh, "<d")
            (track_len,) = _read(fh, "<Q")
            fh.read(8 * track_len)  # (i32 image_id, i32 point2D_idx) pairs
            out[pt_id] = Point3D(pt_id, xyz, rgb, float(error))
    return out


def write_cameras_binary(cameras: dict[int, Camera], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            fh.write(struct.pack("<iiQQ", cam.id, _MODEL_IDS[cam.model],
                                 cam.width, cam.height))
            fh.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: dict[int, ImageMeta], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for im in images.values():
            fh.write(struct.pack("<i", im.id))
            fh.write(struct.pack("<4d", *im.qvec))
            fh.write(struct.pack("<3d", *im.tvec))
            fh.write(struct.pack("<i", im.camera_id))
            fh.write(im.name.encode() + b"\x00")
            fh.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3d_ids):
                fh.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_points3d_binary(points: dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            fh.write(struct.pack("<q", pt.id))
            fh.write(struct.pack("<3d", *pt.xyz))
            fh.write(struct.pack("<3B", *pt.rgb))
            fh.write(struct.pack("<d", pt.error))
            fh.write(struct.pack("<Q", 0))  # empty track


# -------------------------------- text IO ----------------------------------


def read_cameras_text(path: str) -> dict[int, Camera]:
    out = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            out[cam_id] = Camera(
                cam_id, model, int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return out


def read_images_text(path: str) -> dict[int, ImageMeta]:
    out = {}
    with open(path) as fh:
        lines = [ln for ln in fh if ln.strip() and not ln.startswith("#")]
    for meta_line, pts_line in zip(lines[0::2], lines[1::2]):
        parts = meta_line.split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id, name = int(parts[8]), parts[9]
        pts = pts_line.split()
        xys = np.array([[float(x), float(y)] for x, y in zip(pts[0::3], pts[1::3])])
        ids = np.array([int(i) for i in pts[2::3]], dtype=np.int64)
        out[img_id] = ImageMeta(
            img_id, qvec, tvec, camera_id, name,
            xys.reshape(-1, 2), ids,
        )
    return out


def read_points3d_text(path: str) -> dict[int, Point3D]:
    out = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            pt_id = int(parts[0])
            out[pt_id] = Point3D(
                pt_id,
                np.array([float(p) for p in parts[1:4]]),
                np.array([int(p) for p in parts[4:7]], dtype=np.uint8),
                float(parts[7]),
            )
    return out


def read_model(
    path: str, ext: str = ".bin"
) -> tuple[dict[int, Camera], dict[int, ImageMeta], dict[int, Point3D]]:
    """Load a sparse model directory (colmap_utils.py:420-439)."""
    if ext == ".bin":
        return (
            read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")),
        )
    if ext == ".txt":
        return (
            read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3d_text(os.path.join(path, "points3D.txt")),
        )
    raise ValueError(f"unknown model extension {ext!r}")
