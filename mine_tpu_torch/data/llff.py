"""LLFF / NOCS posed multi-view datasets over COLMAP sparse models (the
port's own copy of mine_tpu/data/llff.py; batches bit for bit the JAX
package's).

Reference: input_pipelines/llff/nerf_dataset.py (LLFF) and nocs_dataset.py
(NOCS variant: center crop + first-50-images cap). Behaviours kept:

  * scene layout <root>/<scene>/{sparse/0, images_<ratio>[_val]/}
  * eager RAM load of the (small) scene set at construction
  * K built from the single SIMPLE_* camera with per-axis ratios between the
    stored image and the target resolution
  * per-image COLMAP points transformed to the camera frame; per-item random
    point subsets; train targets sampled uniformly from the same scene, the
    val target a deterministic neighbour

Deliberate fix, as in the JAX package: the NOCS center crop shifts the
principal point by the crop offset (the reference computes its ratios from
the post-crop size, so the crop never reaches K).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np

from mine_tpu_torch.config import Config
from mine_tpu_torch.data import colmap
from mine_tpu_torch.data.frames import (  # noqa: F401 - re-export
    MIN_DEPTH_FRACTION,
    PosedFrameDataset,
    cull_near_points,
)
from mine_tpu_torch.data.image import open_rgb, resize_bicubic, to_unit_float


@dataclass
class PosedImage:
    scene: str
    img: np.ndarray  # (H, W, 3) f32 in [0, 1]
    k: np.ndarray  # (3, 3) f32
    g_cam_world: np.ndarray  # (4, 4) f32
    pts_cam: np.ndarray  # (N, 3) f32 camera-frame COLMAP points


def _load_image(path: str, img_hw: tuple[int, int], crop_hw: tuple[int, int] | None):
    """Decode, optional center crop, bicubic resize to (H, W). Returns
    (img f32 HWC, stored (w, h), crop offset (left, top))."""
    img = open_rgb(path)
    left = top = 0
    if crop_hw is not None:
        ch, cw = crop_hw
        left = (img.width - cw) // 2
        top = (img.height - ch) // 2
        img = img.crop((left, top, left + cw, top + ch))
    w, h = img.width, img.height
    return to_unit_float(resize_bicubic(img, img_hw)), (w, h), (left, top)


def load_scene(
    scene_dir: str,
    image_folder: str,
    img_hw: tuple[int, int],
    pre_downsample_ratio: float,
    center_crop: tuple[int, int] | None = None,
    max_images: int | None = None,
    min_points: int = 1,
) -> list[PosedImage]:
    """Load every posed image of one COLMAP scene.

    Fail-loud deviations from the reference, as in the JAX package:
      * SIMPLE_RADIAL distortion is read and IGNORED like the reference,
        but a non-trivial coefficient warns instead of silently
        mis-projecting; other camera models raise (their parameter layout
        would be misread as (f, cx, cy)).
      * points behind the camera OR closer than MIN_DEPTH_FRACTION of the
        image's median track depth are dropped from that image's track.
      * a track referencing a 3D point id missing from points3D fails with
        the offending image, not a bare KeyError.
    """
    cameras, images, points3d = colmap.read_model(os.path.join(scene_dir, "sparse/0"))
    if len(cameras) != 1:
        raise ValueError(f"{scene_dir}: expected a single shared camera, found {len(cameras)}")
    cam = next(iter(cameras.values()))
    if cam.model not in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        raise ValueError(
            f"{scene_dir}: camera model {cam.model} has a parameter layout "
            "this loader (and the reference) cannot read; re-run COLMAP "
            "with a SIMPLE_* camera model, or extend load_scene"
        )
    if len(cam.params) > 3 and np.any(np.abs(cam.params[3:]) > 1e-8):
        warnings.warn(
            f"{scene_dir}: camera model {cam.model} has non-trivial "
            f"distortion params {cam.params[3:].tolist()} which are IGNORED "
            "(reference parity, nerf_dataset.py:154-163); undistort images "
            "first (colmap image_undistorter) for geometric accuracy",
            stacklevel=2,
        )

    out: list[PosedImage] = []
    for img_id in sorted(images):
        if max_images is not None and len(out) >= max_images:
            break
        meta = images[img_id]
        path = os.path.join(scene_dir, image_folder, meta.name)
        if not os.path.exists(path):
            continue
        arr, (w, h), (left, top) = _load_image(path, img_hw, center_crop)

        # the stored image is the original divided by pre_downsample_ratio;
        # the COLMAP camera lives at the original resolution
        ratio_x = w * pre_downsample_ratio / img_hw[1]
        ratio_y = h * pre_downsample_ratio / img_hw[0]
        f = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
        # the principal point shifts by the crop offset at stored resolution
        cx -= left * pre_downsample_ratio
        cy -= top * pre_downsample_ratio
        k = np.array(
            [[f / ratio_x, 0.0, cx / ratio_x],
             [0.0, f / ratio_y, cy / ratio_y],
             [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

        r = colmap.qvec2rotmat(meta.qvec).astype(np.float32)
        t = meta.tvec.astype(np.float32)
        g = np.eye(4, dtype=np.float32)
        g[:3, :3] = r
        g[:3, 3] = t

        tracked = meta.point3d_ids >= 0
        try:
            world = np.stack(
                [points3d[pid].xyz for pid in meta.point3d_ids[tracked]]
            ) if tracked.any() else np.zeros((0, 3))
        except KeyError as e:
            raise ValueError(
                f"{path}: track references 3D point id {e.args[0]} absent "
                "from points3D — corrupt/truncated COLMAP model"
            ) from None
        pts_cam = (world @ r.T + t).astype(np.float32)  # (N, 3)
        n_tracked = len(pts_cam)
        pts_cam, min_depth = cull_near_points(pts_cam)
        if len(pts_cam) < min_points:
            raise ValueError(
                f"{path}: {len(pts_cam)} usable points < required "
                f"{min_points} ({n_tracked} tracked, "
                f"{n_tracked - len(pts_cam)} culled below the scene min "
                f"depth {min_depth:.3g})"
            )
        out.append(PosedImage(os.path.basename(scene_dir), arr, k, g, pts_cam))
    return out


class LLFFDataset(PosedFrameDataset):
    """Loader-protocol dataset over COLMAP scene directories (the frame
    core, data/frames.py, owns the epoch machinery)."""

    def __init__(self, cfg: Config, split: str, global_batch: int,
                 host_slice: tuple[int, int] | None = None):
        is_val = split == "val"
        ratio = cfg.data.img_pre_downsample_ratio
        folder = "images" if ratio is None or ratio <= 1 else f"images_{ratio}"
        if is_val:
            folder += "_val"
        is_nocs = cfg.data.name == "nocs_llff"
        crop = (384, 640) if is_nocs else None

        root = cfg.data.training_set_path
        images: list[PosedImage] = []
        for scene in sorted(os.listdir(root)):
            scene_dir = os.path.join(root, scene)
            if not os.path.isdir(scene_dir):
                continue
            images.extend(
                load_scene(
                    scene_dir, folder, (cfg.data.img_h, cfg.data.img_w),
                    1.0 if is_nocs else ratio,
                    center_crop=crop,
                    # the reference NOCS caps at the first ~50 images
                    max_images=51 if is_nocs else None,
                    min_points=cfg.data.visible_point_count,
                )
            )
        if not images:
            raise FileNotFoundError(f"no posed images under {root!r} ({folder})")
        super().__init__(cfg, split, global_batch, images, host_slice=host_slice)
        self.images = self.frames  # historical attribute name
