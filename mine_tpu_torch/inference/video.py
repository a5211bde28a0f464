"""Predict-once / render-many novel-view video generation (counterpart of
mine_tpu/inference/video.py).

The network runs once per image; every frame after that is warp + composite
only, one render per pose. Encoder and decoder run under bf16 autocast when
model.dtype is "bfloat16" (the default) and in fp32 when it is "float32"; the
MPI heads' outputs and everything after them are fp32.
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from mine_tpu_torch.config import Config
from mine_tpu_torch.inference.trajectory import camera_trajectories
from mine_tpu_torch.ops.geometry import inverse_3x3
from mine_tpu_torch.ops.mpi_render import render_src
from mine_tpu_torch.training.step import (
    forward_coarse_to_fine,
    build_model,
    make_disparity_list,
    predict_mpis,
    render_novel_view,
)
from mine_tpu_torch.utils.device import resolve_device
from mine_tpu_torch.utils.logging import normalize_disparity_for_vis


def fov_intrinsics(height: int, width: int, fov_deg: float = 90.0) -> np.ndarray:
    """Pinhole K for a horizontal FoV, principal point at the centre."""
    fx = width * 0.5 / math.tan(math.radians(fov_deg) * 0.5)
    return np.array(
        [[fx, 0.0, width * 0.5], [0.0, fx, height * 0.5], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def prepare_image(image: np.ndarray, height: int, width: int,
                  device: torch.device | str) -> torch.Tensor:
    """HWC numpy image (uint8, or float in [0, 1]) -> (1, height, width, 3)
    fp32 on `device`, bilinear-resized with antialiasing on downsampling, as
    jax.image.resize does."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) rgb image, got shape {img.shape}")
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).to(device)[None]
    if tuple(t.shape[1:3]) != (height, width):
        t = F.interpolate(
            t.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
            align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1)
    return t.clamp(0.0, 1.0).contiguous()


@torch.no_grad()
def predict_blended_mpi(cfg: Config, model: torch.nn.Module, img: torch.Tensor,
                        disparity: torch.Tensor, k: torch.Tensor):
    """One network pass + source-RGB blending: plane rgb is replaced by the
    source pixels wherever the source view sees them. Returns (mpi_rgb,
    mpi_sigma), (B, S, H, W, 3) and (B, S, H, W, 1), both contiguous: the
    streaming compositor's kernel reads them in place for every frame."""
    return _blend_src_rgb(cfg, img, predict_mpis(cfg, model, img, disparity)[0], disparity, k)


def _blend_src_rgb(cfg: Config, img, mpi, disparity, k):
    """Scale-0 MPI -> (blended mpi_rgb, contiguous mpi_sigma)."""
    mpi_rgb, mpi_sigma = mpi[..., 0:3], mpi[..., 3:4].contiguous()
    _, _, blend_weights, _ = render_src(
        mpi_rgb, mpi_sigma, disparity, inverse_3x3(k),
        use_alpha=cfg.mpi.use_alpha, is_bg_depth_inf=cfg.mpi.is_bg_depth_inf,
    )
    return blend_weights * img[:, None] + (1.0 - blend_weights) * mpi_rgb, mpi_sigma


# the fine draws of a coarse-to-fine predict: the counterpart of the JAX
# package's PRNGKey(1) (the numbers differ between the frameworks)
FINE_SEED = 1


@torch.no_grad()
def predict_blended_mpi_c2f(cfg: Config, model: torch.nn.Module, img: torch.Tensor,
                            k: torch.Tensor, fine_u: torch.Tensor | None = None):
    """Coarse-to-fine predict (mpi.num_bins_fine > 0): the fixed coarse
    disparities, two network passes through forward_coarse_to_fine with the
    fine draws `fine_u` (B, 1, S_fine) or, when None, drawn from a generator
    seeded FINE_SEED, then source-RGB blending at the merged planes. Returns
    (mpi_rgb, mpi_sigma, merged disparity (B, S_coarse + S_fine)): render
    with the returned disparity."""
    fixed = cfg.replace(**{"mpi.fix_disparity": True})
    b = img.shape[0]
    disparity = make_disparity_list(fixed, b, img.device)
    if fine_u is None:
        fine_u = torch.rand((b, 1, cfg.mpi.num_bins_fine),
                            generator=torch.Generator().manual_seed(FINE_SEED))
    mpis, disparity = forward_coarse_to_fine(fixed, model, img, inverse_3x3(k), disparity,
                                             fine_u=fine_u)
    mpi_rgb, mpi_sigma = _blend_src_rgb(cfg, img, mpis[0], disparity, k)
    return mpi_rgb, mpi_sigma, disparity


@torch.no_grad()
def render_many(cfg: Config, mpi_rgb, mpi_sigma, disparity, k, poses: torch.Tensor):
    """Render one source MPI into every (4, 4) G_tgt_src pose of `poses`
    (N, 4, 4), one render per pose; intrinsics are shared between source and
    target. Returns (rgb (N, H, W, 3), disparity (N, H, W, 1))."""
    k_inv = inverse_3x3(k)
    rgb, disp = [], []
    for g in poses:
        out = render_novel_view(cfg, mpi_rgb, mpi_sigma, disparity, g[None], k_inv, k)
        rgb.append(out["tgt_imgs_syn"][0])
        disp.append(out["tgt_disparity_syn"][0])
    return torch.stack(rgb), torch.stack(disp)


def normalize_disparity(disparity: np.ndarray) -> np.ndarray:
    """Per-frame min-max normalisation to [0, 1] for display (the eval
    grids' normaliser, clipped)."""
    return np.clip(normalize_disparity_for_vis(disparity), 0.0, 1.0)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)


def colorize_heat(gray_u8: np.ndarray) -> np.ndarray:
    """(..., H, W) uint8 -> (..., H, W, 3) heat colormap (grayscale without cv2)."""
    try:
        import cv2
    except ImportError:
        return np.repeat(gray_u8[..., None], 3, axis=-1)
    flat = gray_u8.reshape(-1, *gray_u8.shape[-2:])
    out = np.stack([
        cv2.cvtColor(cv2.applyColorMap(f, cv2.COLORMAP_HOT), cv2.COLOR_BGR2RGB)
        for f in flat
    ])
    return out.reshape(*gray_u8.shape, 3)


def write_video(frames: np.ndarray, path: str, fps: int = 30) -> str:
    """(N, H, W, 3) uint8 frames -> mp4 through cv2, or a PNG sequence
    directory without an mp4 encoder. Returns the path written."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"write_video wants (N, H, W, 3) uint8, got {frames.dtype} "
                         f"{frames.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import cv2

        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if writer.isOpened():
            for frame in frames:
                writer.write(frame[..., ::-1])  # rgb -> bgr
            writer.release()
            return path
    except ImportError:
        pass
    import imageio.v3 as iio

    frame_dir = os.path.splitext(path)[0]
    os.makedirs(frame_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        iio.imwrite(os.path.join(frame_dir, f"{i:04d}.png"), frame)
    return frame_dir


class VideoGenerator:
    """Predict an MPI from one image, then render camera-path videos.

    state_dict: MPINetwork weights (models/convert.py carries the JAX
    package's across). device None means CUDA, which must be present; pass
    "cpu" to run the plain versions on the CPU. With mpi.num_bins_fine > 0
    the predict is coarse-to-fine (predict_blended_mpi_c2f, its fine draws
    `fine_u` or seeded) and every render uses the merged disparities."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 image: np.ndarray, fov_deg: float = 90.0,
                 device: torch.device | str | None = None,
                 fine_u: torch.Tensor | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        h, w = cfg.data.img_h, cfg.data.img_w
        model = build_model(cfg)
        model.load_state_dict(state_dict)
        model.to(self.device)
        self.img = prepare_image(image, h, w, self.device)
        self.k = torch.from_numpy(fov_intrinsics(h, w, fov_deg))[None].to(self.device)
        if cfg.mpi.num_bins_fine > 0:
            self.mpi_rgb, self.mpi_sigma, self.disparity = predict_blended_mpi_c2f(
                cfg, model, self.img, self.k, fine_u)
            return
        fixed_cfg = cfg.replace(**{"mpi.fix_disparity": True})
        self.disparity = make_disparity_list(fixed_cfg, 1, self.device)
        self.mpi_rgb, self.mpi_sigma = predict_blended_mpi(
            cfg, model, self.img, self.disparity, self.k
        )

    def render_poses(self, poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N, 4, 4) poses -> (rgb (N, H, W, 3) in [0, 1], disparity (N, H, W, 1))."""
        rgb, disp = render_many(
            self.cfg, self.mpi_rgb, self.mpi_sigma, self.disparity, self.k,
            torch.from_numpy(np.asarray(poses, np.float32)).to(self.device),
        )
        return rgb.cpu().numpy(), disp.cpu().numpy()

    def render_videos(self, output_dir: str, basename: str) -> list[str]:
        """Render every preset trajectory of the dataset and write
        <basename>_<trajectory>_{rgb,disp} videos. Returns the paths written."""
        trajectories, fps = camera_trajectories(self.cfg.data.name)
        written = []
        for name, poses in trajectories:
            rgb, disp = self.render_poses(poses)
            disp_u8 = colorize_heat(to_uint8(normalize_disparity(disp))[..., 0])
            written.append(write_video(
                to_uint8(rgb), os.path.join(output_dir, f"{basename}_{name}_rgb.mp4"), fps
            ))
            written.append(write_video(
                disp_u8, os.path.join(output_dir, f"{basename}_{name}_disp.mp4"), fps
            ))
        return written


def load_video_generator(workspace: str, image: np.ndarray, fov_deg: float = 90.0,
                         allow_random_init: bool = False,
                         device: torch.device | str | None = None) -> VideoGenerator:
    """A VideoGenerator from a training workspace: the config from its
    params.yaml, the weights from its newest checkpoint (integrity-checked;
    the optimizer state is not loaded). With no checkpoint it raises
    FileNotFoundError unless `allow_random_init`."""
    from mine_tpu_torch.training.checkpoint import load_for_serving

    cfg, state_dict, _ = load_for_serving(workspace, allow_random_init=allow_random_init)
    return VideoGenerator(cfg, state_dict, image, fov_deg=fov_deg, device=device)
