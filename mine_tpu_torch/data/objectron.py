"""Objectron dataset (the port's own copy of mine_tpu/data/objectron.py;
batches bit for bit the JAX package's).

Reference: input_pipelines/objectron.py. Scene layout:
  <root>/<scene>/<scene>_metadata.pickle   poses (c2w), focal, c, RT, scale,
                                           all_scene_points
  <root>/<scene>/masks_3[_val]/*.png       frame list (mask name encodes the
                                           image name: "<prefix>_<img>.png")
  <root>/<scene>/images_3[_val]/<img>

Behaviours kept: the frame list is mask-driven; the pose is
inv(c2w @ ADJUST) with the axis-adjust matrix; images are rotated 90° CCW
and center-cropped to 384x640; K comes per frame from the metadata focal/c;
one shared world point cloud per scene, transformed per frame; targets
sampled within a ±10-frame window, the deterministic neighbour for val;
a ~150-frame cap per scene. The metadata pickle is read with `pickle`: load
only files this program or a trusted exporter wrote.

Deviation kept from the JAX package: the center crop shifts K's principal
point by the crop offset (the reference leaves K untouched).
"""

from __future__ import annotations

import bisect
import glob
import os
import pickle
from dataclasses import dataclass

import numpy as np
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.frames import PosedFrameDataset
from mine_tpu_torch.data.image import open_rgb, resize_bicubic, rotate_ccw, to_unit_float

ADJUST = np.array(
    [[0.0, 1.0, 0.0, 0.0],
     [1.0, 0.0, 0.0, 0.0],
     [0.0, 0.0, -1.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]]
)
CROP_HW = (384, 640)
FRAME_WINDOW = 10
MAX_FRAMES_PER_SCENE = 150


@dataclass
class ObjectronFrame:
    scene: str
    img: np.ndarray  # (H, W, 3) f32
    k: np.ndarray  # (3, 3) f32
    g_cam_world: np.ndarray  # (4, 4) f32
    pts_cam: np.ndarray  # (N, 3) f32


def _load_frame_image(path: str, img_hw: tuple[int, int]):
    """RGB decode + 90° CCW rotate + center crop (clamped to the image);
    returns (img, crop offsets at cropped-orientation resolution)."""
    img = rotate_ccw(open_rgb(path))
    ch, cw = CROP_HW
    left = max((img.width - cw) // 2, 0)
    top = max((img.height - ch) // 2, 0)
    img = img.crop((left, top, min(left + cw, img.width), min(top + ch, img.height)))
    if (img.height, img.width) != tuple(img_hw):
        img = resize_bicubic(img, img_hw)
    return to_unit_float(img), (left, top)


def load_objectron_scene(
    scene_dir: str, split: str, img_hw: tuple[int, int]
) -> list[ObjectronFrame]:
    scene = os.path.basename(scene_dir.rstrip("/"))
    suffix = "_val" if split == "val" else ""
    meta_path = os.path.join(scene_dir, f"{scene}_metadata.pickle")
    with open(meta_path, "rb") as fh:
        meta = pickle.load(fh)

    poses_c2w = np.asarray(meta["poses"])
    focals = np.asarray(meta["focal"])
    centers = np.asarray(meta["c"])
    world_pts = np.asarray(meta["all_scene_points"], dtype=np.float64)

    mask_files = sorted(glob.glob(os.path.join(scene_dir, f"masks_3{suffix}", "*.png")))
    frames: list[ObjectronFrame] = []
    for seg_name in mask_files[: MAX_FRAMES_PER_SCENE + 1]:
        img_name = os.path.basename(seg_name).split("_")[1]
        img_path = os.path.join(scene_dir, f"images_3{suffix}", img_name)
        if not os.path.exists(img_path):
            continue
        frame_idx = int(img_name.split(".")[0])

        c2w = np.squeeze(poses_c2w[frame_idx])
        g_cam_world = np.linalg.inv(c2w @ ADJUST)

        img, (left, top) = _load_frame_image(img_path, img_hw)
        fx, fy = focals[frame_idx][0], focals[frame_idx][1]
        cx, cy = centers[frame_idx][0], centers[frame_idx][1]
        k = np.array(
            [[fx, 0.0, cx - left], [0.0, fy, cy - top], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

        homo = np.concatenate([world_pts, np.ones((len(world_pts), 1))], axis=1)
        cam = (g_cam_world @ homo.T).T
        pts_cam = (cam[:, :3] / cam[:, 3:4]).astype(np.float32)

        frames.append(
            ObjectronFrame(scene, img, k, g_cam_world.astype(np.float32), pts_cam)
        )
    return frames


class ObjectronDataset(PosedFrameDataset):
    """Loader-protocol dataset over Objectron scene directories (shared
    frame core, data/frames.py; target candidates narrowed to the
    reference's ±FRAME_WINDOW same-scene neighbors). Val epochs now get
    the frame core's wrap-padded tail + eval_weight masking — previously
    a short Objectron val tail was silently dropped."""

    def __init__(self, cfg: Config, split: str, global_batch: int,
                 host_slice: tuple[int, int] | None = None):
        root = cfg.data.training_set_path
        frames: list[ObjectronFrame] = []
        for scene in sorted(os.listdir(root)):
            scene_dir = os.path.join(root, scene)
            if not os.path.isdir(scene_dir):
                continue
            frames.extend(
                load_objectron_scene(scene_dir, split, (cfg.data.img_h, cfg.data.img_w))
            )
        if not frames:
            raise FileNotFoundError(f"no objectron frames under {root!r}")
        super().__init__(cfg, split, global_batch, frames,
                         host_slice=host_slice)

    def candidate_targets(self, src_idx: int) -> list[int]:
        # ±FRAME_WINDOW same-scene candidates (objectron.py:176-186)
        return [
            i for i in self.scene_indices[self.frames[src_idx].scene]
            if i != src_idx and abs(i - src_idx) <= FRAME_WINDOW
        ]

    def _validate_candidates(self) -> None:
        # fail at construction, not hours into an epoch: every frame must
        # have enough in-window neighbors for num_tgt_views distinct targets
        # (bisect count — idxs are sorted — keeps this O(F log F) per scene)
        for scene, idxs in self.scene_indices.items():
            for i in idxs:
                lo = bisect.bisect_left(idxs, i - FRAME_WINDOW)
                hi = bisect.bisect_right(idxs, i + FRAME_WINDOW)
                n = hi - lo - 1  # excluding the frame itself
                if n < self.num_tgt_views:
                    raise ValueError(
                        f"frame {i} of scene {scene} has {n} neighbors within "
                        f"±{FRAME_WINDOW}; need >= num_tgt_views="
                        f"{self.num_tgt_views}"
                    )
