"""RenderEngine: predict-once / render-many over one set of weights
(counterpart of the core of mine_tpu/serving/engine.py).

  * shape buckets (H, W, S): each holds its intrinsics and fixed plane
    disparities; a predict resizes the image to its bucket;
  * pose-count buckets (powers of two): a render of N poses runs on poses
    padded with identities up to the next bucket and returns the first N
    frames; N past the largest bucket goes in largest-bucket chunks, so the
    per-dispatch shapes stay a finite set;
  * the streaming compositor is the default: each frame is one fused
    warp-composite launch and no warped plane is ever materialised.

Weight swap, compression tiers, pruning, degradation, metrics, tracing and
the HTTP server are not ported yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.inference.video import (
    fov_intrinsics,
    predict_blended_mpi,
    prepare_image,
    render_many,
)
from mine_tpu_torch.ops.mpi_render import compositor_from_config
from mine_tpu_torch.training.step import build_model, make_disparity_list
from mine_tpu_torch.utils.device import resolve_device

BucketSpec = tuple[int, int, int]  # (H, W, S)

_IDENTITY_POSE = np.eye(4, dtype=np.float32)


@dataclass
class MPIEntry:
    """One predicted MPI: everything render-many needs, device-resident
    (own copy of mine_tpu/serving/cache.py MPIEntry)."""

    mpi_rgb: Any  # (1, S, H, W, 3)
    mpi_sigma: Any  # (1, S, H, W, 1)
    disparity: Any  # (1, S)
    k: Any  # (1, 3, 3) shared source/target intrinsics
    bucket: tuple[int, int, int]  # (H, W, S)
    nbytes: int = field(default=0)

    def __post_init__(self) -> None:
        if not self.nbytes:
            self.nbytes = sum(
                int(a.numel()) * int(a.element_size())
                for a in (self.mpi_rgb, self.mpi_sigma, self.disparity, self.k)
            )


class _Bucket:
    """One (H, W, S) shape bucket: its config, intrinsics and disparities."""

    def __init__(self, engine: "RenderEngine", spec: BucketSpec):
        h, w, s = spec
        self.spec = spec
        self.cfg = engine.base_cfg.replace(**{
            "data.img_h": h, "data.img_w": w, "mpi.num_bins_coarse": s,
            "mpi.compositor": engine.compositor,
        })
        fixed = self.cfg.replace(**{"mpi.fix_disparity": True})
        self.disparity = make_disparity_list(fixed, 1, engine.device)
        self.k = torch.from_numpy(fov_intrinsics(h, w, engine.fov_deg))[None].to(
            engine.device
        )


class RenderEngine:
    """Predict-once / render-many. Thread-safe: predict and render may run
    concurrently (eval-mode network, no autograd state)."""

    def __init__(
        self,
        cfg: Config,
        state_dict: Mapping[str, torch.Tensor],
        pose_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
        fov_deg: float = 90.0,
        compositor: str = "streaming",
        device: torch.device | str | None = None,
    ):
        if cfg.mpi.num_bins_fine > 0:
            raise NotImplementedError("coarse-to-fine predict is not ported yet")
        self.device = resolve_device(device)
        self.base_cfg = cfg
        # unknown names fail here, not inside the first render
        compositor_from_config(cfg.replace(**{"mpi.compositor": compositor}))
        self.compositor = compositor
        self.model = build_model(cfg)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        self.pose_buckets = tuple(sorted({int(n) for n in pose_buckets}))
        if not self.pose_buckets or self.pose_buckets[0] < 1:
            raise ValueError(f"bad pose_buckets {pose_buckets}")
        self.fov_deg = fov_deg
        self.default_bucket: BucketSpec = (
            cfg.data.img_h, cfg.data.img_w, cfg.mpi.num_bins_coarse
        )
        self._buckets: dict[BucketSpec, _Bucket] = {}  # guarded-by: _buckets_lock
        self._buckets_lock = threading.Lock()

    def bucket(self, spec: BucketSpec | None = None) -> _Bucket:
        spec = self.default_bucket if spec is None else tuple(map(int, spec))
        h, w, s = spec
        if h % 128 or w % 128:
            raise ValueError(
                f"bucket H={h}, W={w} must be multiples of 128 "
                "(MPI decoder receptive-field extension)"
            )
        if s < 2:
            raise ValueError(f"bucket S={s} must be >= 2")
        with self._buckets_lock:
            b = self._buckets.get(spec)
            if b is None:
                b = self._buckets[spec] = _Bucket(self, spec)
            return b

    def _pose_bucket(self, n: int) -> int:
        for b in self.pose_buckets:
            if n <= b:
                return b
        return self.pose_buckets[-1]

    def predict(self, image: np.ndarray, spec: BucketSpec | None = None) -> MPIEntry:
        """Run the encoder-decoder once. image: (h, w, 3) uint8 or float in
        [0, 1] at any resolution, resized to the bucket's (H, W)."""
        bucket = self.bucket(spec)
        h, w, _ = bucket.spec
        img = prepare_image(image, h, w, self.device)
        mpi_rgb, mpi_sigma = predict_blended_mpi(
            bucket.cfg, self.model, img, bucket.disparity, bucket.k
        )
        return MPIEntry(mpi_rgb, mpi_sigma, bucket.disparity, bucket.k, bucket.spec)

    def render(self, entry: MPIEntry, poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Render (N, 4, 4) G_tgt_src poses against a predicted MPI. Returns
        host arrays (rgb (N, H, W, 3) in [0, 1], disparity (N, H, W, 1))."""
        poses = np.asarray(poses, np.float32)
        if poses.ndim != 3 or poses.shape[1:] != (4, 4):
            raise ValueError(f"poses must be (N, 4, 4), got {poses.shape}")
        n = poses.shape[0]
        h, w, _ = entry.bucket
        bucket = self.bucket(entry.bucket)
        max_b = self.pose_buckets[-1]
        # each chunk's frames are copied straight into these: one copy to the
        # host per frame, and no second host buffer to fault in and fill
        rgb_out = np.empty((n, h, w, 3), np.float32)
        disp_out = np.empty((n, h, w, 1), np.float32)
        for start in range(0, n, max_b):
            chunk = poses[start:start + max_b]
            k = chunk.shape[0]
            pad = np.broadcast_to(_IDENTITY_POSE, (self._pose_bucket(k) - k, 4, 4))
            rgb, disp = render_many(
                bucket.cfg, entry.mpi_rgb, entry.mpi_sigma, entry.disparity, entry.k,
                torch.from_numpy(np.concatenate([chunk, pad])).to(self.device),
            )
            torch.from_numpy(rgb_out[start:start + k]).copy_(rgb[:k])
            torch.from_numpy(disp_out[start:start + k]).copy_(disp[:k])
        return rgb_out, disp_out
