"""RenderEngine: predict-once / render-many over hot-swappable weights (the
port's counterpart of mine_tpu/serving/engine.py).

  * shape buckets (H, W, S): each holds its intrinsics and fixed plane
    disparities; a predict resizes the image to its bucket. Under a
    coarse-to-fine config (mpi.num_bins_fine > 0) S stays the coarse count
    (the key), a predict runs the two passes and its entry carries its own
    S + S_fine merged disparities, which every render uses;
  * pose-count buckets (powers of two): a render of N poses runs on poses
    padded with identities up to the next bucket and returns the first N
    frames; N past the largest bucket goes in largest-bucket chunks;
  * plane-count buckets: a pruned entry (serving/compress.py) renders at the
    smallest power of two (or the full count) holding its surviving planes,
    padded in front with inert planes (sigma 0 at the nearest surviving
    disparity, so alpha is 0; the only deviation is the compositor's +1e-6
    cumprod epsilon per pad plane);
  * the streaming compositor is the default: each frame is one fused
    warp-composite launch (K5) and no warped plane is ever materialised;
  * compression tiers and pruning (serving.cache_tier,
    serving.prune_transmittance_eps), validated at startup; compressed
    entries dequantize on render;
  * weight generations: `swap_weights` validates a candidate state dict,
    loads it into a NEW module, runs one verification predict per warm
    bucket on it, then flips one reference. The live module is never
    written to: a predict reads one WeightSet for its whole dispatch, so an
    in-flight predict finishes on the generation it started on. Peak memory
    during a swap is two models, small beside the MPI cache.

The JAX engine compiles one executable per bucket ahead of time and counts
the compiles. Here the first dispatch of each predict bucket and of each
(plane count, pose count) render bucket is what builds the kernels and warms
cuDNN and the caching allocator: `compiles` counts those first dispatches,
under the same name and metric, and `warmup` runs them before traffic (one
predict per shape bucket, one render per plane and pose bucket).

Thread-safe: HTTP handler threads predict while the batcher's thread
renders, all on the device's current stream; frames reach the host before
render returns.

The brownout ladder's L1 (serving/degrade.py) overrides the tier and the
pruning threshold of new predicts (`set_degraded_compression`); a caller
reads `effective_tier` / `effective_prune_eps` once and passes both into
`predict`, so a key and its entry never straddle a level flip. An entry
fetched off a peer's wire (compress.py from_wire, CPU tensors) is checked
against its bucket and placed on the engine's device by `_adopt_entry`, so
its render dequantizes and composites there.

Cost (obs/cost.py): each bucket's first predict, its warm-up's as a rule,
runs under the FLOP counter once; with metrics, every predict then sets
`mine_serve_step_flops{kind="predict"}`, and the achieved TFLOP/s and
`mine_serve_mfu` against the card's peak (or `--peak-flops`) from its time
to completion. On the card that time is read off two timing events on the
predict's stream, one before its dispatch and one after, and nothing waits
for them: `publish_cost` sets the gauges of every predict whose end event
has completed, at the next predict and on each /metrics scrape. On the
CPU it is the predict's wall time.
Renders count 0 FLOPs (their compositing is the hand-written kernel), so
they set no cost gauge. Chaos seams (resilience/chaos.py): `predict_raise`
at the top of `predict`, `engine_raise` at the top of `render`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.inference.video import (
    fov_intrinsics,
    predict_blended_mpi,
    predict_blended_mpi_c2f,
    prepare_image,
    render_many,
)
from mine_tpu_torch.obs.cost import StepCost, counted_cost, resolve_peak_flops
from mine_tpu_torch.obs.trace import NULL_TRACER, Tracer
from mine_tpu_torch.ops.mpi_render import compositor_from_config
from mine_tpu_torch.resilience import chaos
from mine_tpu_torch.serving.cache import MPIEntry
from mine_tpu_torch.serving.compress import TIERS, CompressedMPI, compress_mpi, decompress
from mine_tpu_torch.training.checkpoint import CheckpointTreeMismatch, validate_variables_tree
from mine_tpu_torch.training.step import build_model, make_disparity_list
from mine_tpu_torch.utils.device import resolve_device

BucketSpec = tuple[int, int, int]  # (H, W, S)

_IDENTITY_POSE = np.eye(4, dtype=np.float32)


class SwapError(RuntimeError):
    """Base of the named hot-swap failures: the previous generation is
    still serving."""


class SwapRejected(SwapError):
    """The candidate failed validation (state-dict keys, shapes or dtypes)
    or its verification predict raised."""


class SwapInProgress(SwapError):
    """A swap is already running; swaps never interleave."""


@dataclass(frozen=True)
class WeightSet:
    """One immutable weight generation: its own eval-mode module on the
    engine's device, the checkpoint step it came from, and a generation id
    that rises with every swap. The MPI cache keys on checkpoint_step, so a
    swap's new predicts mint new keys while entries of the old step stay
    servable until they age out."""

    model: torch.nn.Module
    checkpoint_step: int
    generation: int


class _Bucket:
    """One (H, W, S) shape bucket: its config, intrinsics, disparities, plane
    buckets and which of its dispatches have run once. S is the coarse plane
    count (the bucket's key); a coarse-to-fine config (mpi.num_bins_fine > 0)
    predicts through predict_blended_mpi_c2f and renders num_planes = S +
    S_fine planes at each entry's own merged disparities."""

    def __init__(self, engine: "RenderEngine", spec: BucketSpec):
        h, w, s = spec
        self.spec = spec
        self.cfg = engine.base_cfg.replace(**{
            "data.img_h": h, "data.img_w": w, "mpi.num_bins_coarse": s,
            "mpi.compositor": engine.compositor,
        })
        self.is_c2f = self.cfg.mpi.num_bins_fine > 0
        self.num_planes = s + (self.cfg.mpi.num_bins_fine if self.is_c2f else 0)
        fixed = self.cfg.replace(**{"mpi.fix_disparity": True})
        self.disparity = make_disparity_list(fixed, 1, engine.device)
        # the warm-ups' render planes: num_planes fixed disparities
        self.warm_disparity = make_disparity_list(
            fixed.replace(**{"mpi.num_bins_coarse": self.num_planes, "mpi.disparity_list": ()}),
            1, engine.device)
        self.k = torch.from_numpy(fov_intrinsics(h, w, engine.fov_deg))[None].to(
            engine.device
        )
        # pruned entries render at powers of two under S, or S itself
        n = self.num_planes
        self.plane_buckets: tuple[int, ...] = tuple(sorted(
            {n} | {1 << p for p in range(1, n.bit_length()) if (1 << p) < n}
        ))
        self.predict_warm = False  # guarded-by: engine._warm_lock
        # the predict's counted cost, set by its first predict
        self.predict_cost: StepCost | None = None
        self.render_warm: set[tuple[int, int]] = set()  # (n_planes, n_poses)

    def plane_bucket(self, n_planes: int) -> int:
        """Smallest plane bucket >= n_planes."""
        for b in self.plane_buckets:
            if n_planes <= b:
                return b
        return self.plane_buckets[-1]


class RenderEngine:
    """Predict-once / render-many over one weight generation at a time."""

    def __init__(
        self,
        cfg: Config,
        state_dict: Mapping[str, torch.Tensor],
        checkpoint_step: int = 0,
        metrics: Any | None = None,
        pose_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
        fov_deg: float = 90.0,
        compositor: str = "streaming",
        device: torch.device | str | None = None,
        tracer: Tracer | None = None,
        peak_flops_override: float = 0.0,
    ):
        self.device = resolve_device(device)
        # what mine_serve_mfu divides by: the override, else the card's row
        self.peak_flops = resolve_peak_flops(self.device, peak_flops_override)
        self.base_cfg = cfg
        # the tier new predicts land at (a cache-key part) and the pruning
        # threshold; a bad value fails here, not inside the first predict
        self.cache_tier = cfg.serving.cache_tier
        if self.cache_tier not in TIERS:
            raise ValueError(f"serving.cache_tier={self.cache_tier!r} must be one of {TIERS}")
        self.prune_eps = float(cfg.serving.prune_transmittance_eps)
        if not 0.0 <= self.prune_eps < 1.0:
            # a compositing weight never reaches 1, so eps >= 1 would collapse
            # every MPI to its single best plane
            raise ValueError(f"serving.prune_transmittance_eps={self.prune_eps} must be "
                             "in [0, 1): it thresholds a compositing weight")
        # the brownout override (None: the configured operating point)
        self._degraded_tier: str | None = None
        self._degraded_prune_eps = 0.0
        # unknown names fail here, not inside the first render
        compositor_from_config(cfg.replace(**{"mpi.compositor": compositor}))
        self.compositor = compositor
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pose_buckets = tuple(sorted({int(n) for n in pose_buckets}))
        if not self.pose_buckets or self.pose_buckets[0] < 1:
            raise ValueError(f"bad pose_buckets {pose_buckets}")
        self.fov_deg = fov_deg
        self.default_bucket: BucketSpec = (
            cfg.data.img_h, cfg.data.img_w, cfg.mpi.num_bins_coarse
        )
        self._weights = WeightSet(self._place(state_dict), int(checkpoint_step), 0)
        self._swap_lock = threading.Lock()  # serializes swaps; predict never takes it
        self.compiles = 0  # first dispatches (also in metrics); guarded-by: _warm_lock
        self._warm_lock = threading.Lock()
        self._buckets: dict[BucketSpec, _Bucket] = {}  # guarded-by: _buckets_lock
        self._buckets_lock = threading.Lock()
        # (flops, start, end) of predicts on the card whose end event has
        # not been read yet (publish_cost); guarded-by: _cost_lock
        self._pending_costs: deque[tuple[float, Any, Any]] = deque(maxlen=64)
        self._cost_lock = threading.Lock()

    # -- weight generations ----------------------------------------------------

    @property
    def model(self) -> torch.nn.Module:
        """The serving generation's module."""
        return self._weights.model

    @property
    def checkpoint_step(self) -> int:
        return self._weights.checkpoint_step

    @property
    def generation(self) -> int:
        return self._weights.generation

    def weights(self) -> WeightSet:
        """One consistent (model, checkpoint_step, generation) snapshot. A
        caller that keys a cache entry AND dispatches a predict reads this
        once and uses it for both, so the two cannot straddle a swap."""
        return self._weights

    def _place(self, state_dict: Mapping[str, torch.Tensor]) -> torch.nn.Module:
        """A fresh eval-mode module holding `state_dict`, on the device."""
        model = build_model(self.base_cfg)
        model.load_state_dict(state_dict)
        return model.to(self.device)

    def swap_weights(self, state_dict: Mapping[str, torch.Tensor], checkpoint_step: int,
                     verify: bool = True) -> WeightSet:
        """Hot-swap to a new weight generation; returns the new WeightSet.

        Validate (the candidate's keys, shapes and dtypes against the
        serving module's: SwapRejected), place (a new module; the serving
        one is untouched), verify (one predict of a zeros image per warm
        bucket on the new module: a candidate that cannot run fails here,
        on the swap's thread, as SwapRejected), then flip one reference.
        In-flight predicts keep their snapshot; the old module is freed
        when the last of them drops it. Raises SwapInProgress when another
        swap holds the lock."""
        if not self._swap_lock.acquire(blocking=False):
            raise SwapInProgress("a weight swap is already in progress")
        try:
            serving = self._weights
            try:
                validate_variables_tree(
                    serving.model.state_dict(), state_dict,
                    context=f"swap candidate (step {checkpoint_step}) vs serving "
                            f"generation {serving.generation}",
                )
            except CheckpointTreeMismatch as exc:
                raise SwapRejected(str(exc)) from exc
            model = self._place(state_dict)
            if verify:
                for spec in self.bucket_specs():
                    h, w, _ = spec
                    try:
                        with torch.no_grad():
                            self._dispatch_predict(self.bucket(spec), np.zeros(
                                (h, w, 3), np.float32), model)
                    except Exception as exc:  # noqa: BLE001 - named rollback
                        raise SwapRejected(f"verification predict failed on bucket {spec}: "
                                           f"{type(exc).__name__}: {exc}") from exc
            new = WeightSet(model, int(checkpoint_step), serving.generation + 1)
            self._weights = new  # the atomic flip
            if self.metrics is not None:
                self.metrics.weight_generation.set(new.generation)
            return new
        finally:
            self._swap_lock.release()

    # -- the degraded compression override (serving/degrade.py L1) ------------

    def set_degraded_compression(self, tier: str, prune_eps: float) -> None:
        """New predicts land at `tier` with at least `prune_eps` pruning (the
        configured threshold still applies where it is stricter). Cached
        entries stay as they are: the tier is part of their keys."""
        if tier not in TIERS:
            raise ValueError(f"degraded tier {tier!r} must be one of {TIERS}")
        if not 0.0 <= float(prune_eps) < 1.0:
            raise ValueError(f"degraded prune_eps={prune_eps} must be in [0, 1)")
        self._degraded_prune_eps = float(prune_eps)
        self._degraded_tier = tier

    def clear_degraded_compression(self) -> None:
        self._degraded_tier = None
        self._degraded_prune_eps = 0.0

    def effective_tier(self) -> str:
        """The tier new predicts land at now (a cache-key part)."""
        return self._degraded_tier or self.cache_tier

    def effective_prune_eps(self) -> float:
        if self._degraded_tier is None:
            return self.prune_eps
        return max(self.prune_eps, self._degraded_prune_eps)

    # -- buckets ---------------------------------------------------------------

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

    def bucket_specs(self) -> list[BucketSpec]:
        with self._buckets_lock:
            return list(self._buckets)

    def _pose_bucket(self, n: int) -> int:
        for b in self.pose_buckets:
            if n <= b:
                return b
        return self.pose_buckets[-1]

    def _first_dispatch(self, bucket: _Bucket, kind: str, key: tuple[int, int] | None) -> None:
        """Count the first dispatch of a predict bucket (key None) or a
        (n_planes, n_poses) render bucket, once."""
        with self._warm_lock:
            if key is None:
                if bucket.predict_warm:
                    return
                bucket.predict_warm = True
            else:
                if key in bucket.render_warm:
                    return
                bucket.render_warm.add(key)
            self.compiles += 1
        if self.metrics is not None:
            self.metrics.engine_compiles.inc(kind=kind)

    # -- the two halves --------------------------------------------------------

    def _predict_pass(self, bucket: _Bucket, image: np.ndarray, model: torch.nn.Module):
        """_dispatch_predict, under the FLOP counter the first time per
        bucket (obs/cost.py)."""
        if bucket.predict_cost is not None:
            return self._dispatch_predict(bucket, image, model)
        out, bucket.predict_cost = counted_cost(self._dispatch_predict, bucket, image, model)
        return out

    def _dispatch_predict(self, bucket: _Bucket, image: np.ndarray, model: torch.nn.Module):
        """One network pass + blending on an explicit module; (mpi_rgb,
        mpi_sigma, disparity). Shared by live predicts, warmup and the
        swap's verify."""
        h, w, _ = bucket.spec
        img = prepare_image(image, h, w, self.device)
        if bucket.is_c2f:
            out = predict_blended_mpi_c2f(bucket.cfg, model, img, bucket.k)
            self._first_dispatch(bucket, "predict", None)
            return out
        mpi_rgb, mpi_sigma = predict_blended_mpi(bucket.cfg, model, img, bucket.disparity,
                                                 bucket.k)
        self._first_dispatch(bucket, "predict", None)
        return mpi_rgb, mpi_sigma, bucket.disparity

    @torch.no_grad()
    def predict(self, image: np.ndarray, spec: BucketSpec | None = None,
                request_id: str | None = None, weights: WeightSet | None = None,
                tier: str | None = None,
                prune_eps: float | None = None) -> MPIEntry | CompressedMPI:
        """Run the encoder-decoder once; returns the device-resident cache
        value at the tier: a plain MPIEntry at fp32 with pruning off (or
        nothing pruned), a CompressedMPI otherwise.

        image: (h, w, 3) uint8 or float in [0, 1] at any resolution, resized
        to the bucket's (H, W). weights: an explicit snapshot
        (engine.weights()), so that the caller's cache key and this
        dispatch are one generation; tier/prune_eps likewise (default: the
        effective operating point at call time)."""
        chaos.maybe_raise("predict_raise")  # fault seam (resilience/chaos.py)
        ws = weights if weights is not None else self._weights
        bucket = self.bucket(spec)
        on_card = self.metrics is not None and self.device.type == "cuda"
        with self.tracer.span("engine_predict", cat="serve", bucket=str(bucket.spec),
                              request_id=request_id):
            if on_card:
                self.publish_cost()
                stream = torch.cuda.current_stream(self.device)
                start = stream.record_event(torch.cuda.Event(enable_timing=True))
            counted = bucket.predict_cost is None  # slowed by the counter: not timed
            t0 = time.perf_counter()
            mpi_rgb, mpi_sigma, disparity = self._predict_pass(bucket, image, ws.model)
            elapsed = time.perf_counter() - t0
            if on_card:
                end = stream.record_event(torch.cuda.Event(enable_timing=True))
            entry = compress_mpi(
                mpi_rgb, mpi_sigma, disparity, bucket.k, bucket.spec,
                tier=self.effective_tier() if tier is None else tier,
                prune_eps=self.effective_prune_eps() if prune_eps is None else prune_eps,
                use_alpha=bucket.cfg.mpi.use_alpha,
            )
        if self.metrics is not None:
            self.metrics.encoder_invocations.inc()
            if isinstance(entry, CompressedMPI) and entry.planes_kept < entry.num_planes_full:
                self.metrics.pruned_planes.inc(entry.num_planes_full - entry.planes_kept)
            flops = bucket.predict_cost.flops if bucket.predict_cost is not None else None
            if flops:
                self.metrics.step_flops.set(flops, kind="predict")
            if flops and not counted:
                if on_card:
                    with self._cost_lock:
                        self._pending_costs.append((flops, start, end))
                else:
                    self._set_rate(flops, elapsed)
        return entry

    def publish_cost(self) -> None:
        """Set the achieved TFLOP/s and MFU gauges from each predict on the
        card whose end event has completed, oldest first: the counted FLOPs
        over the time between its two events. Never waits on the card."""
        done = []
        with self._cost_lock:
            while self._pending_costs and self._pending_costs[0][2].query():
                done.append(self._pending_costs.popleft())
        for flops, start, end in done:
            self._set_rate(flops, start.elapsed_time(end) / 1e3)

    def _set_rate(self, flops: float, seconds: float) -> None:
        if self.metrics is None or seconds <= 0:
            return
        self.metrics.achieved_tflops.set(flops / seconds / 1e12)
        if self.peak_flops:
            self.metrics.mfu.set(flops / seconds / self.peak_flops)

    def _adopt_entry(self, entry: MPIEntry | CompressedMPI,
                     request_id: str | None = None) -> MPIEntry | CompressedMPI:
        """A cache value from a peer's wire (CPU tensors), checked against
        its bucket and placed on the engine's device: its renders then
        dequantize and composite there. A value that does not fit its
        bucket raises ValueError. nbytes is unchanged (it counts the
        representation, not where it lives)."""
        h, w, s = (int(v) for v in entry.bucket)
        if isinstance(entry, CompressedMPI):
            arrays, tier = entry._arrays(), entry.tier
            kept, full = entry.planes_kept, entry.num_planes_full
        else:
            arrays, tier = {"rgb": entry.mpi_rgb, "sigma": entry.mpi_sigma,
                            "disparity": entry.disparity, "k": entry.k}, "fp32"
            kept = full = int(entry.disparity.shape[-1])
        slab = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[tier]
        want = {"rgb": ((1, kept, h, w, 3), slab), "sigma": ((1, kept, h, w, 1), slab),
                "disparity": ((1, kept), torch.float32), "k": ((1, 3, 3), torch.float32)}
        bad = {name: (tuple(arrays[name].shape), str(arrays[name].dtype))
               for name, spec in want.items()
               if (tuple(arrays[name].shape), arrays[name].dtype) != spec}
        if bad or full != self.bucket((h, w, s)).num_planes or not 1 <= kept <= full:
            raise ValueError(f"a {tier} entry for bucket {(h, w, s)} ({kept} of {full} "
                             f"planes) has fields {bad or 'that fit'}")
        with self.tracer.span("adopt_entry", cat="serve", request_id=request_id):
            placed = {name: None if a is None else a.to(self.device).contiguous()
                      for name, a in arrays.items()}
        if isinstance(entry, CompressedMPI):
            return dataclasses.replace(entry, **placed)
        return MPIEntry(placed["rgb"], placed["sigma"], placed["disparity"], placed["k"],
                        entry.bucket, nbytes=entry.nbytes)

    def _render_inputs(self, bucket: _Bucket, entry: MPIEntry | CompressedMPI):
        """Cache value -> (rgb, sigma, disparity, k, n_planes) fp32 render
        inputs. Compressed entries dequantize here, and their surviving
        planes are padded in front up to a plane bucket with sigma-0 planes
        at the nearest surviving disparity (alpha exactly 0)."""
        if not isinstance(entry, CompressedMPI):
            return (entry.mpi_rgb, entry.mpi_sigma, entry.disparity, entry.k,
                    entry.mpi_rgb.shape[1])
        rgb, sigma, disparity, k = decompress(entry)
        kept = entry.planes_kept
        n_planes = bucket.plane_bucket(kept)
        if kept < n_planes:
            pad = n_planes - kept
            _, _, h, w, _ = rgb.shape
            rgb = torch.cat([rgb.new_zeros((1, pad, h, w, 3)), rgb], dim=1)
            sigma = torch.cat([sigma.new_zeros((1, pad, h, w, 1)), sigma], dim=1)
            disparity = torch.cat([disparity[:, :1].expand(1, pad), disparity], dim=1)
        return rgb, sigma, disparity, k, n_planes

    def _dispatch_render(self, bucket: _Bucket, rgb, sigma, disparity, k,
                         padded: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        out = render_many(bucket.cfg, rgb, sigma, disparity, k,
                          torch.from_numpy(padded).to(self.device))
        self._first_dispatch(bucket, "render", (int(rgb.shape[1]), padded.shape[0]))
        return out

    def render(self, entry: MPIEntry | CompressedMPI,
               poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Render (N, 4, 4) G_tgt_src poses against a cached MPI. Returns
        host arrays (rgb (N, H, W, 3) in [0, 1], disparity (N, H, W, 1))."""
        chaos.maybe_raise("engine_raise")  # fault seam (resilience/chaos.py)
        poses = np.asarray(poses, np.float32)
        if poses.ndim != 3 or poses.shape[1:] != (4, 4):
            raise ValueError(f"poses must be (N, 4, 4), got {poses.shape}")
        n = poses.shape[0]
        h, w, _ = entry.bucket
        # each chunk's frames are copied straight into these: one copy to the
        # host per frame, and no second host buffer to fault in and fill
        rgb_out = np.empty((n, h, w, 3), np.float32)
        disp_out = np.empty((n, h, w, 1), np.float32)
        if n == 0:
            return rgb_out, disp_out
        bucket = self.bucket(entry.bucket)
        rgb_in, sigma_in, disparity, k, _ = self._render_inputs(bucket, entry)
        max_b = self.pose_buckets[-1]
        for start in range(0, n, max_b):
            chunk = poses[start:start + max_b]
            m = chunk.shape[0]
            pad = np.broadcast_to(_IDENTITY_POSE, (self._pose_bucket(m) - m, 4, 4))
            rgb, disp = self._dispatch_render(bucket, rgb_in, sigma_in, disparity, k,
                                              np.concatenate([chunk, pad]))
            torch.from_numpy(rgb_out[start:start + m]).copy_(rgb[:m])
            torch.from_numpy(disp_out[start:start + m]).copy_(disp[:m])
        if self.metrics is not None:
            self.metrics.rendered_frames.inc(n)
            self.metrics.renders_per_sec.record(n)
        return rgb_out, disp_out

    # -- pre-warming -----------------------------------------------------------

    @torch.no_grad()
    def warmup(self, specs: list[BucketSpec] | None = None,
               pose_counts: tuple[int, ...] | None = None) -> int:
        """Run the first dispatches before traffic: per shape bucket one
        predict (of a zeros image) and one render (of a zeros MPI) per plane
        bucket (every one with pruning on, else the full count) and pose
        bucket. Returns how many first dispatches this call made; after
        it, `compiles` stays flat through traffic on these buckets."""
        before = self.compiles
        for spec in (specs if specs is not None else [self.default_bucket]):
            bucket = self.bucket(spec)
            h, w, s = bucket.spec
            if not bucket.predict_warm:
                self._predict_pass(bucket, np.zeros((h, w, 3), np.float32), self.model)
            plane_counts = bucket.plane_buckets if self.prune_eps else (bucket.num_planes,)
            for n_poses in sorted({self._pose_bucket(n) for n in (
                    pose_counts if pose_counts is not None else self.pose_buckets)}):
                poses = np.broadcast_to(_IDENTITY_POSE, (n_poses, 4, 4)).copy()
                for n_planes in plane_counts:
                    if (n_planes, n_poses) in bucket.render_warm:
                        continue
                    zeros = torch.zeros((1, n_planes, h, w, 4), device=self.device)
                    self._dispatch_render(bucket, zeros[..., :3].contiguous(),
                                          zeros[..., 3:].contiguous(),
                                          bucket.warm_disparity[:, :n_planes], bucket.k, poses)
        return self.compiles - before

    def warm_pool(self) -> dict[str, dict]:
        """Per bucket: whether its predict ran once, and which (n_planes,
        n_poses) renders did (surfaced on /healthz)."""
        out: dict[str, dict] = {}
        for spec in self.bucket_specs():
            bucket = self.bucket(spec)
            with self._warm_lock:
                out["x".join(str(v) for v in spec)] = {
                    "predict": bucket.predict_warm,
                    "render": sorted(bucket.render_warm),
                }
        return out
