"""Synthetic two-view scene with analytically known geometry (the port's
own copy of mine_tpu/data/synthetic.py).

Scene: a far fronto-parallel plane at FAR_DEPTH plus a near occluder strip at
NEAR_DEPTH; texture is a smooth analytic function of the plane point, so any
camera pose renders exactly (pixels are evaluated, not warped). It is the
zero-setup dataset for training runs (`data.name: synthetic`): every batch
is generated procedurally, so training runs with nothing on disk.
`write_colmap_scene` lays the same scene down as an LLFF/COLMAP directory
(the fixtures of data/conformance/fixtures.py).
"""

from __future__ import annotations

import numpy as np

NEAR_DEPTH = 1.0
FAR_DEPTH = 4.0
_NEAR_HALF_WIDTH = 0.25  # near strip spans plane-x in [-w, w] at z=NEAR_DEPTH


def _texture(x: np.ndarray, y: np.ndarray, phase: float) -> np.ndarray:
    """Smooth rgb texture of plane coordinates, in [0, 1]. (..., 3)."""
    r = 0.5 + 0.5 * np.sin(7.0 * x + phase) * np.cos(5.0 * y)
    g = 0.5 + 0.5 * np.cos(11.0 * x - 3.0 * y + phase)
    b = 0.5 + 0.5 * np.sin(4.0 * x * y + 2.0 * phase)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _intrinsics(height: int, width: int) -> np.ndarray:
    f = 0.8 * width
    return np.array(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def _render_view(
    height: int, width: int, k: np.ndarray, cam_pos: np.ndarray, phase: float
) -> tuple[np.ndarray, np.ndarray]:
    """Render the scene from a camera at `cam_pos` (world axes == camera axes,
    no rotation). Returns (img (H,W,3), depth (H,W))."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    k_inv = np.linalg.inv(k)
    rays = np.einsum("ij,hwj->hwi", k_inv, np.stack([u, v, np.ones_like(u)], -1).astype(np.float64))

    # intersection with plane world-z = Z: world point = cam_pos + rays * (Z - cam_pos_z)
    def plane_point(z_world):
        t = (z_world - cam_pos[2]) / rays[..., 2]
        return cam_pos[None, None, :] + rays * t[..., None]

    p_near = plane_point(NEAR_DEPTH)
    p_far = plane_point(FAR_DEPTH)
    near_hit = np.abs(p_near[..., 0]) < _NEAR_HALF_WIDTH

    img = np.where(
        near_hit[..., None],
        _texture(p_near[..., 0] * 6.0, p_near[..., 1] * 6.0, phase + 1.7),
        _texture(p_far[..., 0], p_far[..., 1], phase),
    )
    depth = np.where(near_hit, NEAR_DEPTH - cam_pos[2], FAR_DEPTH - cam_pos[2])
    return img.astype(np.float32), depth.astype(np.float32)


def _sample_points(
    rng: np.random.Generator, n_points: int, cam_pos: np.ndarray
) -> np.ndarray:
    """Sparse scene points visible from both cameras (COLMAP stand-ins),
    in the frame of a camera at cam_pos. (N, 3)."""
    n_near = n_points // 4
    n_far = n_points - n_near
    # far points away from the near strip's shadow (|x| < 4*half_width at
    # z=4) to dodge occlusion, but inside the fov: u = f x/z + cx < W needs
    # |x| < z/(2*0.8) = 2.5 at the border, margin for the baseline shift
    sign = rng.choice([-1.0, 1.0], size=n_far)
    x_far = sign * rng.uniform(_NEAR_HALF_WIDTH * 6.0, 2.2, size=n_far)
    y_far = rng.uniform(-1.4, 1.4, size=n_far)
    far = np.stack([x_far, y_far, np.full(n_far, FAR_DEPTH)], axis=-1)
    x_near = rng.uniform(-_NEAR_HALF_WIDTH, _NEAR_HALF_WIDTH, size=n_near)
    y_near = rng.uniform(-0.3, 0.3, size=n_near)
    near = np.stack([x_near, y_near, np.full(n_near, NEAR_DEPTH)], axis=-1)
    pts = np.concatenate([far, near], axis=0)
    return (pts - cam_pos[None, :]).astype(np.float32)


def write_colmap_scene(
    root: str,
    scene: str,
    n_views: int = 4,
    hw: tuple[int, int] = (64, 64),
    n_val_views: int = 0,
    phase: float = 0.3,
) -> list[np.ndarray]:
    """Write the analytic scene to disk in LLFF/COLMAP layout (images/ +
    sparse/0 binary model), for fixtures and loader measurements. Camera i
    sits at [0.06i, 0.02i, 0] with identity rotation; every 3D point is
    tracked in every view. With n_val_views > 0, extra held-out cameras
    (offset half a baseline step from the train line, so no val pose equals
    a train pose) land in images_val/, the `<folder>_val` layout
    LLFFDataset's val split reads; all poses live in the one sparse/0
    model. Returns the train camera positions. The model files are
    byte-equal to the JAX package's, the images decode equal."""
    import os

    from mine_tpu_torch.data import colmap
    from mine_tpu_torch.data.image import save_png

    h, w = hw
    k = _intrinsics(h, w)
    scene_dir = os.path.join(root, scene)
    os.makedirs(os.path.join(scene_dir, "sparse/0"), exist_ok=True)
    os.makedirs(os.path.join(scene_dir, "images"), exist_ok=True)
    if n_val_views:
        os.makedirs(os.path.join(scene_dir, "images_val"), exist_ok=True)

    rng = np.random.default_rng(0)
    world_pts = _sample_points(rng, 80, np.zeros(3))  # camera-0 frame == world
    points3d = {
        i + 1: colmap.Point3D(i + 1, world_pts[i].astype(np.float64),
                              np.array([255, 0, 0], np.uint8), 0.5)
        for i in range(len(world_pts))
    }

    cameras = {1: colmap.Camera(1, "SIMPLE_RADIAL", w, h,
                                np.array([k[0, 0], k[0, 2], k[1, 2], 0.0]))}
    images = {}
    positions = []
    views = [(f"view_{i:03d}.png", np.array([0.06 * i, 0.02 * i, 0.0]), "images")
             for i in range(n_views)]
    views += [(f"val_{j:03d}.png",
               np.array([0.06 * j + 0.03, 0.02 * j + 0.01, 0.0]), "images_val")
              for j in range(n_val_views)]
    for img_id, (name, pos, folder) in enumerate(views, start=1):
        if folder == "images":
            positions.append(pos)
        img, _ = _render_view(h, w, k, pos, phase=phase)
        save_png((img * 255).astype(np.uint8), os.path.join(scene_dir, folder, name))
        # G_cam_world = [I | -pos]; all points tracked in every view
        uvw = (world_pts - pos) @ k.T
        xys = uvw[:, :2] / uvw[:, 2:]
        images[img_id] = colmap.ImageMeta(
            img_id, np.array([1.0, 0, 0, 0]), (-pos).astype(np.float64), 1, name,
            xys.astype(np.float64), np.arange(1, len(world_pts) + 1, dtype=np.int64),
        )

    colmap.write_cameras_binary(cameras, os.path.join(scene_dir, "sparse/0/cameras.bin"))
    colmap.write_images_binary(images, os.path.join(scene_dir, "sparse/0/images.bin"))
    colmap.write_points3d_binary(points3d, os.path.join(scene_dir, "sparse/0/points3D.bin"))
    return positions


class SyntheticDataset:
    """Procedural dataset speaking the loader protocol (`len()` steps per
    epoch, `epoch(n)` iterating numpy batch dicts). Every batch is a fresh
    scene, deterministic in (seed, epoch, step), each example seeded by its
    GLOBAL index in the batch: with `host_slice=(start, count)` only those
    rows are made, bit for bit the rows of the whole batch."""

    def __init__(self, height: int, width: int, global_batch: int,
                 steps_per_epoch: int = 50, n_points: int = 256, seed: int = 0,
                 host_slice: tuple[int, int] | None = None):
        self.height = height
        self.width = width
        self.global_batch = global_batch
        self.steps_per_epoch = steps_per_epoch
        self.n_points = n_points
        self.seed = seed
        if host_slice is not None:
            start, count = host_slice
            if start < 0 or count < 1 or start + count > global_batch:
                raise ValueError(f"host_slice={host_slice} outside the global batch "
                                 f"of {global_batch}")
        self.host_slice = host_slice

    def __len__(self) -> int:
        return self.steps_per_epoch

    @property
    def num_eval_examples(self) -> int:
        """Examples in one pass over every host's rows (no batch is padded):
        run_evaluation's audit, which counts the whole mesh's examples, as
        the frame loaders' count (data/frames.py)."""
        return self.steps_per_epoch * self.global_batch

    def epoch(self, epoch: int):
        start, count = self.host_slice or (0, self.global_batch)
        for step in range(self.steps_per_epoch):
            batch = make_synthetic_batch(
                count, self.height, self.width, n_points=self.n_points,
                seed=self.seed + epoch * 1_000_003 + step, example_offset=start,
            )
            batch.pop("src_depth")
            yield batch


def make_synthetic_batch(
    batch_size: int,
    height: int,
    width: int,
    n_points: int = 64,
    seed: int = 0,
    baseline: float = 0.08,
    example_offset: int = 0,
) -> dict[str, np.ndarray]:
    """A batch dict in the training-step contract (training/step.py), plus
    the source view's ground-truth depth as "src_depth".

    The target camera is the source camera translated by `baseline` along +x
    (and a touch of +y), like an LLFF stereo pair. Every example draws from
    its own generator seeded by (seed, example_offset + row), so an example
    is a function of its index alone, bit for bit the JAX package's.
    """
    k = _intrinsics(height, width)

    out = {
        "src_img": np.zeros((batch_size, height, width, 3), np.float32),
        "tgt_img": np.zeros((batch_size, height, width, 3), np.float32),
        "k_src": np.tile(k[None], (batch_size, 1, 1)),
        "k_tgt": np.tile(k[None], (batch_size, 1, 1)),
        "g_tgt_src": np.zeros((batch_size, 4, 4), np.float32),
        "pt3d_src": np.zeros((batch_size, n_points, 3), np.float32),
        "pt3d_tgt": np.zeros((batch_size, n_points, 3), np.float32),
        "src_depth": np.zeros((batch_size, height, width), np.float32),
    }
    for b in range(batch_size):
        rng = np.random.default_rng([seed, example_offset + b])
        phase = float(rng.uniform(0.0, 6.28))
        src_pos = np.zeros(3)
        tgt_pos = np.array([baseline, 0.3 * baseline, 0.0])
        out["src_img"][b], out["src_depth"][b] = _render_view(height, width, k, src_pos, phase)
        out["tgt_img"][b], _ = _render_view(height, width, k, tgt_pos, phase)
        # world axes == camera axes: X_tgt = X_src - tgt_pos
        g = np.eye(4, dtype=np.float32)
        g[:3, 3] = (src_pos - tgt_pos).astype(np.float32)
        out["g_tgt_src"][b] = g
        out["pt3d_src"][b] = _sample_points(rng, n_points, src_pos)
        out["pt3d_tgt"][b] = out["pt3d_src"][b] - (tgt_pos - src_pos)[None, :].astype(np.float32)
    return out
