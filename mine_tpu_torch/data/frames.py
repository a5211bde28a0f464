"""The posed-frame dataset core (the port's own copy of
mine_tpu/data/frames.py): the loader protocol, implemented once.

Every real dataset family reduces to the same shape: a list of posed frames
(image + intrinsics + world pose + optional camera-frame sparse points),
grouped into scenes, paired (src, tgt) per batch slot. `PosedFrameDataset`
owns the protocol:

  * `__len__` / `epoch(n)` / `num_eval_examples`: the loader contract the
    training loop and the conformance runner consume (data/conformance/).
  * train drop-last vs val wrap-pad tails with `eval_weight` masking, so
    every family evaluates its full val set under static shapes.
  * `data.num_tgt_views` k-targets-per-source flattening.
  * `host_slice`: every example's randomness comes from a numpy generator
    seeded by its GLOBAL (epoch, step, source-slot) coordinates, never from
    a shared sequential stream, so a host materializing only its
    `host_slice` rows produces bit for bit the rows a global-batch build
    would slice out; and the batches equal the JAX package's bit for bit.

Subclasses provide the frames (their on-disk layout knowledge) and may
override `candidate_targets` (e.g. Objectron's ±frame window), nothing else.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mine_tpu_torch.config import Config


@dataclass
class PosedFrame:
    """One posed view. `pts_cam=None` marks a family without sparse-depth
    supervision (the contract's `sparse_depth` flag; training/step.py zeros
    the disparity terms for those families via NO_DISP_SUPERVISION)."""

    scene: str
    img: np.ndarray  # (H, W, 3) f32 in [0, 1]
    k: np.ndarray  # (3, 3) f32, pixels at the TARGET (img_h, img_w)
    g_cam_world: np.ndarray  # (4, 4) f32 world -> camera
    pts_cam: np.ndarray | None  # (N, 3) f32 camera-frame points, or None


class PosedFrameDataset:
    """Loader-protocol dataset over a frame list (duck-typed: any object
    with .scene/.img/.k/.g_cam_world/.pts_cam works — LLFF's PosedImage and
    Objectron's ObjectronFrame predate PosedFrame and stay as they are).

    Replaces torch Dataset + DistributedSampler + DataLoader + collate
    (reference train.py:76-132): one logical global batch per step; with
    `host_slice=(start, count)` only those rows are materialized.
    """

    def __init__(
        self,
        cfg: Config,
        split: str,
        global_batch: int,
        frames: list,
        host_slice: tuple[int, int] | None = None,
    ):
        self.cfg = cfg
        self.split = split
        self.is_val = split == "val"
        self.global_batch = global_batch
        self.rng_seed = cfg.training.seed + (991 if self.is_val else 0)
        self.frames = frames
        # num_tgt_views targets per source, each filling one batch slot (the
        # reference's supervision_count, capped at 1 in practice —
        # synthesis_task.py:203-204; here any k dividing the batch works)
        self.num_tgt_views = cfg.data.num_tgt_views
        if self.num_tgt_views < 1 or global_batch % self.num_tgt_views:
            raise ValueError(
                f"data.num_tgt_views={self.num_tgt_views} must be >= 1 and "
                f"divide the global batch {global_batch}"
            )
        if not self.is_val and len(frames) < global_batch // self.num_tgt_views:
            # with drop_last a too-small train set would yield ZERO batches
            # per epoch — a silent no-op training run; fail loudly instead
            raise ValueError(
                f"train split has {len(frames)} source image(s) but one "
                f"global batch needs {global_batch // self.num_tgt_views}; "
                "every epoch would be empty (reduce the batch or add data)"
            )
        if host_slice is not None:
            start, count = host_slice
            if start < 0 or count < 1 or start + count > global_batch:
                raise ValueError(
                    f"host_slice={host_slice} outside the global batch "
                    f"of {global_batch}"
                )
        self.host_slice = host_slice
        # scene -> global indices (reference nerf_dataset.py scene_to_indices)
        self.scene_indices: dict[str, list[int]] = {}
        for i, fr in enumerate(frames):
            self.scene_indices.setdefault(fr.scene, []).append(i)
        self._validate_candidates()

    # -- subclass surface ----------------------------------------------------

    def candidate_targets(self, src_idx: int) -> list[int]:
        """Target candidates for one source view; default: every other view
        of the same scene. Subclasses narrow this (Objectron: ±frame
        window)."""
        scene = self.frames[src_idx].scene
        return [i for i in self.scene_indices[scene] if i != src_idx]

    def _validate_candidates(self) -> None:
        """Fail at construction, not mid-epoch: every source needs >=
        num_tgt_views distinct targets. The default same-scene candidate
        set makes this a per-scene size check."""
        for scene, idxs in self.scene_indices.items():
            if len(idxs) < self.num_tgt_views + 1:
                raise ValueError(
                    f"scene {scene} has {len(idxs)} image(s); need >= "
                    f"{self.num_tgt_views + 1} for {self.num_tgt_views} "
                    "target(s)"
                )

    # -- the loader protocol -------------------------------------------------

    def __len__(self) -> int:
        n_src = self.global_batch // self.num_tgt_views
        if self.is_val:
            # val covers EVERY image (reference run_eval iterates the full
            # val DataLoader, drop_last=False — synthesis_task.py:506-515);
            # the final short batch is wrap-padded to keep shapes static
            return -(-len(self.frames) // n_src)
        # train drops the short tail (reference DataLoader drop_last=True,
        # train.py:110); __len__ must agree with what epoch() yields
        return len(self.frames) // n_src

    @property
    def num_eval_examples(self) -> int:
        """Genuine (weight-1) examples one val epoch yields: every image
        serves as source exactly once, num_tgt_views pairs each. The eval
        loop audits its metered count against this (training/loop.py
        run_evaluation) so a wrap-pad miscount can't silently skew the one
        number users compare."""
        return len(self.frames) * self.num_tgt_views

    def _examples(
        self, src_idx: int, rng: np.random.Generator
    ) -> list[dict[str, np.ndarray]]:
        """num_tgt_views (src, tgt) pairs for one source view, from ONE
        per-source generator (the k 'without replacement' targets must be
        drawn together; the host slice trims rows afterwards)."""
        src = self.frames[src_idx]
        candidates = self.candidate_targets(src_idx)
        k = self.num_tgt_views
        if self.is_val:
            # deterministic neighbor(s) (nerf_dataset.py:205-208)
            base = (src_idx + 1) % len(candidates) - 1
            tgt_idxs = [candidates[(base + j) % len(candidates)]
                        for j in range(k)]
        else:
            tgt_idxs = [int(i) for i in
                        rng.choice(candidates, size=k, replace=False)]

        n_pt = self.cfg.data.visible_point_count
        out = []
        for tgt_idx in tgt_idxs:
            tgt = self.frames[tgt_idx]
            # G_tgt_src maps src-camera coords to tgt-camera coords
            # (reference builds G_src_tgt then inverts at set_data,
            # nerf_dataset.py:219-221 + synthesis_task.py:211)
            g_tgt_src = tgt.g_cam_world @ np.linalg.inv(src.g_cam_world)
            example = {
                "src_img": src.img,
                "tgt_img": tgt.img,
                "k_src": src.k,
                "k_tgt": tgt.k,
                "g_tgt_src": g_tgt_src.astype(np.float32),
            }
            if src.pts_cam is not None:
                # sampling with replacement only when a frame holds fewer
                # tracked points than requested (Objectron's small clouds)
                example["pt3d_src"] = src.pts_cam[rng.choice(
                    len(src.pts_cam), n_pt,
                    replace=len(src.pts_cam) < n_pt,
                )]
                example["pt3d_tgt"] = tgt.pts_cam[rng.choice(
                    len(tgt.pts_cam), n_pt,
                    replace=len(tgt.pts_cam) < n_pt,
                )]
            out.append(example)
        return out

    def epoch(self, epoch: int):
        """Batches for one epoch — only this host's `host_slice` rows.

        Per-example determinism contract: the epoch ORDER comes from one
        (seed, epoch) generator shared by every host, and each source
        slot's targets/point-subsets come from a generator seeded by the
        slot's global (seed, epoch, step, position) coordinates — so the
        rows a host materializes are a pure function of their global
        coordinates, bitwise-equal to the same rows of a global build
        (tests/test_torch_data.py pins this per family)."""
        order = np.random.default_rng((self.rng_seed, epoch)).permutation(
            len(self.frames)
        )
        n_src = self.global_batch // self.num_tgt_views
        k = self.num_tgt_views
        start, count = self.host_slice or (0, self.global_batch)
        for step in range(len(self)):
            idxs = order[step * n_src:(step + 1) * n_src]
            n_genuine = len(idxs)
            if n_genuine < n_src:
                if not self.is_val:  # drop_last, like the reference's train
                    break            # DataLoader (train.py:110)
                # Val: wrap-pad the tail from the start of the order so
                # every image is evaluated under one static batch shape.
                # Padded slots carry eval_weight
                # 0.0 below, so the epoch average counts every genuine
                # example exactly once (synthesis_task.py:506-515 parity).
                idxs = np.concatenate(
                    [idxs, np.resize(order, n_src - len(idxs))]
                )
            examples: list[dict[str, np.ndarray]] = []
            weights: list[float] = []
            for p, src_idx in enumerate(idxs):
                lo = p * k
                if lo + k <= start or lo >= start + count:
                    continue  # no overlap with this host's rows
                rng = np.random.default_rng(
                    (self.rng_seed, epoch, step, p)
                )
                group = self._examples(int(src_idx), rng)
                for j, e in enumerate(group):
                    if start <= lo + j < start + count:
                        examples.append(e)
                        weights.append(1.0 if p < n_genuine else 0.0)
            batch = {
                key: np.stack([e[key] for e in examples])
                for key in examples[0]
            }
            if self.is_val:
                # per-example validity mask for the wrap-padded tail
                batch["eval_weight"] = np.asarray(weights, np.float32)
            yield batch


MIN_DEPTH_FRACTION = 0.01


def cull_near_points(pts_cam: np.ndarray) -> tuple[np.ndarray, float]:
    """Drop behind-camera and lens-grazing points from one frame's track.

    A negative/zero depth would NaN the 1/z disparity supervision, and a
    single z ~ 1e-5 survivor contributes log(1/z) ~ 11.5 to
    compute_scale_factor's exp(mean(log...)): one reconstruction artifact
    can shift a whole image's scale calibration. A point closer
    than MIN_DEPTH_FRACTION of the frame's MEDIAN track depth is an
    artifact, not geometry. Returns (kept points, the threshold used)."""
    z = pts_cam[:, 2]
    positive = z[z > 0]
    min_depth = (
        max(MIN_DEPTH_FRACTION * float(np.median(positive)), 1e-6)
        if len(positive) else 1e-6
    )
    return pts_cam[z > min_depth], min_depth
