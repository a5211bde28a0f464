#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mine_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and nvcc:
  1. prints the card's name and power limit, turns TF32 off;
  2. builds the CUDA kernels from mine_tpu_torch/csrc/;
  3. holds each kernel against its plain PyTorch version at the main paths'
     shapes (rtol = atol = 1e-5): the warp at the dense compositor's
     (32, 4, 384, 512), at a 756x1008 source and at the streaming backward's
     chunks (16, 4, 384, 512) and (4, 4, 768, 1024), the fused warp-composite
     (matrix form: per-plane matrices, the MPI read in place) at S=32,
     384x512 with planes behind the target camera, also against the
     coordinate form the Pallas kernel computes; the warp's backward at the
     training path's scale-0 (128, 4, 384, 512), at a 756x1008 source and
     at the two streaming chunk shapes,
     with and without the coordinate cotangent (its atomics add in a
     run-dependent order: atol 1e-5 of max |grad_src|), with the share of
     its blocks on the shared-memory and the direct path;
  4. drives the serving path at the default configuration's full width
     (ResNet-50, 384x512, S=32, bf16 network) with seeded random weights:
     a RenderEngine (streaming compositor) predicts two images and renders
     1, 5 and 90 poses, a VideoGenerator (dense compositor) renders the
     zoom-in trajectory; the kernels' launch counts must rise by exactly the
     frames rendered, dense and streaming must agree to 1e-4, a streaming
     frame must allocate less than one (S, H, W) fp32 array, and a small
     configuration on the card must agree with the same run on the CPU;
  5. drives the training path at the same full width (B=4, dense
     compositor, stratified disparities, 4-scale loss, Adam) on synthetic
     batches: finite loss and gradient norm, both parameter groups move,
     the warp and its backward kernel launch 4 times a step; the first
     step's scale-0 backward operands are captured; the same steps run twice
     more with Adam and twice with sgd, to show how far the gradient norm
     repeats; one train step of a small configuration on the card must
     agree with the CPU's;
  6. drives the streaming compositor's training path (streaming_phases):
     the gradient of a streaming render (K5 forward, the chunked scan's warp
     and its backward) against the dense render's and against the same scan
     on the plain versions (relative L2 1e-4, max 1e-5 of max |grad|);
     Trainer.fit with the streaming compositor at full width (B=4) with a
     checkpoint and an eval, its launches a step asserted, its step time and
     peak memory beside the dense step's; a new Trainer resuming from the
     workspace bit-equal; the eval pass with LPIPS (seeded weights) at full
     width, its val/ image grids checked in the event file; the 768x1024,
     S=128, B=1 recipe with remat (llff_highres.yaml),
     whose scale-0 warps are the size class of the TPU's banded kernels;
  7. trains from the datasets' own on-disk formats (data_phases): the
     default recipe (ResNet-50, 384x512, S=32, B=4, bf16, dense) from an LLFF
     fixture stored at 378x504 through Trainer.fit with a checkpoint and an
     eval (3 val views wrap-padded to 4) and through the train and evaluate
     CLIs as subprocesses; the loader's construction, batch build and copy to
     the card (pageable and pinned) timed; the step fed by the loader with 4
     and with 0 workers and by synthetic batches, alternated, for both
     compositors; the six other recipes at their own shapes from their
     fixtures, contract-checked, 2 steps each;
  8. serves the data_llff workspace over HTTP (serve_phases): the serving
     CLI as a subprocess through the conformance runner's serve stage, then
     a ServingApp behind make_server in this process: /predict of an image
     twice (a miss, then a hit that runs no encoder) and of a second image,
     each with its host spans, /render of 1, 8 and 64
     offsets (decoded frames equal the engine's own render after the same
     uint8 rounding; PNG encoding timed apart), 8 concurrent clients x 10
     rounds on one MPI (requests against dispatches), /healthz, /metrics,
     /debug/trace, GET /mpi/<key> parsed by from_wire, a hot swap to a new
     step (generation 1, the old key still renders, new predicts mint the
     new step's key) and a shape-mismatched one refused with 422; the same
     round at the int8 tier with pruning (bytes, planes kept, plane bucket,
     PSNR against fp32); K5 held against its plain version at every plane
     count the phase launched; then a fleet of that workspace
     (serve_fleet_phase): in-process replicas behind the router, affinity
     and routed answers byte-equal to the owner's, the router's overhead,
     peer fetch at fp32 and int8 when an arc moves off a draining owner
     (the adopted entry on the card, rendering the old owner's frames), the
     swap fan-out, the brownout ladder under a flood and walked L0-L3-L0,
     and an autoscale join and drain over replica processes of the serving
     CLI, under client traffic with no 5xx; K5 held on the adopted and the
     L1-degraded entries;
  9. observes and survives training and serving (obs_resilience_phase):
     Trainer.fit with obs on at full width, dense and streaming, with a
     counted step (FLOPs, MFU) and a profile window attributed per
     component (coverage >= 0.9, K1/K2 inside homography_warp, K5 inside
     composite), a SIGUSR1 flight dump mid-run; the dense step with obs off
     and on in turns (within 3 %); the train CLI preempted by
     MINE_TPU_FAULTS=sigterm@step=3, its checkpoint restored bit-equal and
     trained on; a NaN step skipped and a loader error retried on the LLFF
     fixture; the serving CLI with --peak-flops and a failing predict, a
     corrupt swap and a SIGUSR1 dump;
 10. trains across ranks (parallel_phase, run right after the main path,
     while this process holds little device memory): the train CLI under torchrun,
     two ranks sharing the card over gloo (the script's --train-rank mode
     records each rank's launches, steps and memory), data=2 and plane=2,
     dense and streaming, fp32 (first step's loss dict at rtol 1e-4, its
     gradient and its norm within 5 %) and data=2 bf16 (first step's loss dict
     within 2 %; its gradient no farther from the fp32 one-process gradient
     than the bf16 one-process gradient is, x1.5, and its norm likewise),
     each against a one-process run of the same seed; later steps and the
     weights after 2 Adam steps are reported beside two one-process runs'
     own gaps, not held (Adam's first update turns rounding into +-lr, and
     two identical one-process runs drift apart too); the 768x1024, S=128 recipe at plane=2 (the banded
     size class; first loss within 2 %); a one-rank NCCL job whose bring-up
     survives coord_down@init=1; host_stall@step=2 ending both ranks in the
     named abort (exit 83) within the watchdog window; K5 with a halo plane
     against its plain version on a plane shard's real inputs, and the two
     shards composed into the whole render;
 12. shards training state, preempts it and places planes coarse-to-fine
     (right after the parallel phase): the train CLI on two gloo ranks under
     mesh.fsdp_parallel=2 and under data=2 with parallel.zero1 (fp32, B=4,
     2 steps each; each rank's resident parameter and Adam-moment bytes
     equal the partition-rule table's placement_bytes, below replication;
     the first step's loss dict at rtol 1e-4 and gradient within 5 % of the
     data=2 run's), the fsdp=2 checkpoint resumed in one process for a
     step; mpi.num_bins_fine=32 (64 planes): 2 dense fp32 steps at B=2 with
     their peak memory, 2 steps at plane=2 on two ranks (first step's loss
     dict at rtol 1e-4), a RenderEngine coarse-to-fine bucket predicting
     once and rendering poses (K5 at S=64, held against its plain version)
     and a VideoGenerator rendering them dense; the preemption save under
     fsdp=2 and ZeRO-1 (those same runs, rank 1 alone SIGTERMed after
     step 2 of 3: both ranks save step 2 together, equal bit for bit to
     the state they hold, and end with the SIGTERM's disposition; a
     one-process resume runs step 3;
     each rank's save seconds and the per-step flag all-reduce timed), the
     emergency checkpoint under fsdp=2 (rank 1 raises after step 2: each
     rank writes its own verified shard file, step 2 counts and resumes in
     one process), and a warm start from the ZeRO-1 run's workspace (one
     step, K1 and K2 launched);
 13. trains to quality (quality_phase; the harnesses of mine_tpu_torch/tools/
     as the CLIs a user runs, started before section 4 in the background
     and collected after section 12): the oracle ceiling at S = 8, 16, 32,
     dense and streaming, each row equal to the same row on the CPU and to
     each other (1e-2 dB), the source pose >= 100 dB; the fp32 convergence
     run (128x128, ResNet-18, S=8, B=4, 2200 steps, 3 held-out scenes every
     100 steps), finite loss, 4 K1 and 4 K2 launches a step, the median
     novel-pose PSNR of its last 5 evals >= 16.0 dB and >= the median of its
     first 3 + 1.0 dB, its save scored again here under streaming (K5 once a
     pose) to 1e-2 dB of the run's score, K5 held on one of those poses; the bf16 run of the same
     recipe (finite loss, its gap to fp32 at equal steps reported);
     disocclusion_analysis on the fp32 save (the oracle's keys equal the
     CPU's); the end-to-end chain through the train and evaluate CLIs (900
     steps), both exit 0 and val PSNR >= 12.0 dB; every figure beside the
     JAX package's (fp32, CPU, BASELINE.md); then, on a card nothing else
     uses, the convergence harness's step time with its batches built
     inline (as the JAX harness builds them) against batch_feed's;
 11. times every kernel (CUDA events), its plain version and, for the warp
     and its backward, torch's grid_sample, beside each kernel's memory
     bound (the backward also on the captured training operands; the
     warp-composite also at the 768x1024, S=128 size); times predict and
     render per frame, the frames' copy to host memory on its own, and the
     train step; profiles them, with the device events per frame, and the
     coordinate-form prep the streaming render no longer runs (device time
     sums kernels and copies only, not the profiler's annotation ranges; a
     busy share above 1 fails the phase).
Every result line is JSON and carries the card's name and power limit; a
line emitted while section 13's CLIs may still run beside it (from their
start before section 4 to the end of their collection) carries
"contended": true, its timings taken on a shared card and host. The
last line is {"ok": true, "device": {...}}. Any failure raises and the exit
code is not 0. Without a CUDA device, or outside a checkout, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 rate outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-5)
T_START = time.perf_counter()
# true from start_quality_runs to the end of quality_phase's collection: the
# quality CLIs may run beside whatever is measured meanwhile
CONTENDED = False


def card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power = (p.strip() for p in out.split(","))
    return {"gpu": name, "power_limit": power, "nvidia_smi": out}


def emit(info: dict, **fields) -> None:
    if CONTENDED:
        fields["contended"] = True
    print(json.dumps({**fields, "gpu": info["gpu"], "power_limit": info["power_limit"],
                      "elapsed_s": time.perf_counter() - T_START}), flush=True)


def time_cuda_ms(fn, reps: int = 20, inner: int = 5, warmup: int = 3) -> float:
    """Median per-call device time over `reps` CUDA-event windows of `inner`
    back-to-back calls each, after `warmup` calls. Before each window the
    stream sleeps ~1 ms on the card, so the host has queued the window's
    calls before it starts: a kernel shorter than its wrapper's host
    overhead is timed on the device, not on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # clock cycles, ~1 ms at the H100's ~2 GHz
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        windows.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / inner for s, e in windows)


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of fn, synchronised before and after."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def plane_coords(h: int, w: int, s: int, g: np.ndarray, dev, gen) -> tuple:
    """Sample coords of s real MPI planes (disparity 1 .. 0.001) at pose g,
    with a band of rows replaced by random far-out-of-bounds coordinates."""
    from mine_tpu_torch.inference.video import fov_intrinsics
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.homography import homography_sample_coords

    k = torch.from_numpy(fov_intrinsics(h, w))[None].to(dev).expand(s, 3, 3)
    depth = 1.0 / torch.linspace(1.0, 0.001, s, device=dev)
    gt = torch.from_numpy(g)[None].to(dev).expand(s, 4, 4)
    xy, _ = homography_sample_coords(depth, gt, inverse_3x3(k), k, h, w)
    band = slice(h // 3, h // 3 + 16)
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    noise = torch.rand(xy[:, band].shape, generator=gen, device=dev)
    xy[:, band] = noise * (size + 100.0) - 50.0
    return xy[..., 0].contiguous(), xy[..., 1].contiguous()


def pose(tx: float, ty: float, tz: float, yaw: float = 0.02) -> np.ndarray:
    g = np.eye(4, dtype=np.float32)
    c, s = math.cos(yaw), math.sin(yaw)
    g[0, 0], g[0, 2], g[2, 0], g[2, 2] = c, s, -s, c
    g[:3, 3] = (tx, ty, tz)
    return g


def device_work(events) -> list:
    """The profiler's device events that are work: kernels, copies and
    sets. Dropped are the ranges it also reports on the device: the GPU-side
    user annotations (`gpu_user_annotation`, which obs/attrib.py scope's
    record_function opens around the kernels of a component) and any other
    event that encloses another one on its stream, which only spans work
    counted already. Kernels on one stream never overlap."""
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and "annotation" not in (getattr(e, "activity_type", None) or "")]
    by_stream: dict = {}
    for e in on_device:
        by_stream.setdefault((e.device_index, e.device_resource_id), []).append(e)
    kept = []
    for stream in by_stream.values():
        stream.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        for e, nxt in zip(stream, stream[1:] + [None]):
            if nxt is None or nxt.time_range.end > e.time_range.end:
                kept.append(e)
    return kept


def profile_breakdown(fn, frames: int, top: int = 8) -> dict:
    """One profiled call of fn (after a warm one): wall and device time per
    frame, the device's busy share, and the kernels taking the most device
    time. Device time sums `device_work` events only, so no kernel is
    counted twice; a busy share above 1 fails the phase. The profiler's own
    overhead inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name: dict[str, list] = {}
    for e in device_work(prof.events()):
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us()
        row[1] += 1
    top_items = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    share = device_ms / wall_ms
    if not by_name or share > 1.0:
        raise AssertionError(f"profile: device time {device_ms} ms against {wall_ms} ms of wall "
                             f"time (busy share {share}) over {len(by_name)} device kernels")
    return {
        "wall_ms_per_frame": wall_ms / frames,
        "device_ms_per_frame": device_ms / frames,
        "device_busy_share": share,
        # kernels and copies the card ran, per frame
        "device_events_per_frame": sum(n for _, n in by_name.values()) / frames,
        "top_kernels": [
            {"name": name[:100], "ms_per_frame": us / 1e3 / frames, "calls_per_frame": n / frames}
            for name, (us, n) in top_items[:top]
        ],
    }


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, **tol) -> float:
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, **tol):
        raise AssertionError(f"{name}: max abs err {err} is outside tolerance {tol}")
    return err


VMEM_SRC_BUDGET = 8 * 1024 * 1024  # the TPU's banded-kernel threshold (K3/K4 past it)
# (H, W, S, B) of mine_tpu/configs/llff_highres.yaml
HIGHRES = (768, 1024, 128, 1)


class SizeTally:
    """Kernel launches of warp_bilinear (K1/K3) and its backward (K2/K4) by
    the TPU's size class, counted where the package's own launch count rose:
    a source plane of C*H*W fp32 past 8 MiB is the banded class. Wraps the
    two functions WarpBilinear calls until `close()`."""

    def __init__(self, kw):
        self.kw, self.fwd, self.grad = kw, kw._warp_bilinear_forward, kw.warp_bilinear_grad
        self.counts = {}
        self.reset()

        def count(name, c, hh, ww, before):
            if kw.launches[name] > before:
                cls = "banded" if c * hh * ww * 4 > VMEM_SRC_BUDGET else "resident"
                self.counts[name][cls] += 1

        def fwd(src, cx, cy):
            before = kw.launches["warp_bilinear"]
            out = self.fwd(src, cx, cy)
            count("warp_bilinear", *src.shape[1:], before)
            return out

        def grad(g, cx, cy, hh, ww, src=None):
            before = kw.launches["warp_bilinear_grad"]
            out = self.grad(g, cx, cy, hh, ww, src)
            count("warp_bilinear_grad", g.shape[1], hh, ww, before)
            return out

        kw._warp_bilinear_forward, kw.warp_bilinear_grad = fwd, grad

    def reset(self) -> None:
        self.counts = {name: {"resident": 0, "banded": 0}
                       for name in ("warp_bilinear", "warp_bilinear_grad")}

    def read(self) -> dict:
        return {name: dict(v) for name, v in self.counts.items()}

    def close(self) -> None:
        self.kw._warp_bilinear_forward, self.kw.warp_bilinear_grad = self.fwd, self.grad


def write_seeded_lpips(path: str, seed: int = 0) -> None:
    """Seeded random LPIPS-VGG weights in the converted layout (conv kernels
    HWIO, non-negative lin weights (C,)), so that LPIPS runs at full width."""
    from mine_tpu_torch.losses.lpips import _TAP_CHANNELS, _VGG16_CFG

    rng = np.random.default_rng(seed)
    arrays, c_in = {}, 3
    for i, c in enumerate(c for c in _VGG16_CFG if c != "M"):
        bound = 1.0 / math.sqrt(9 * c_in)
        arrays[f"conv{i}_w"] = rng.uniform(-bound, bound, (3, 3, c_in, c)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
        c_in = c
    for j, c in enumerate(_TAP_CHANNELS):
        arrays[f"lin{j}_w"] = rng.uniform(0.0, 2.0 / c, c).astype(np.float32)
    np.savez(path, **arrays)


class GridRecorder:
    """MetricWriter's event writer where tensorboardX does not import: it
    keeps each image grid's array."""

    def __init__(self):
        self.images: dict[str, np.ndarray] = {}

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def add_image(self, tag, img, step, dataformats) -> None:
        self.images[tag] = np.asarray(img)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def rel_l2_and_max(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """||got - want|| / ||want|| and max |got - want| / max |want|."""
    diff = (got - want).double()
    return ((diff.norm() / want.double().norm()).item(),
            (diff.abs().max() / want.abs().max()).item())


def streaming_phases(info, dev, gen, h, w, s, train_cfg, train_state, batch_size,
                     dense_trainer, dense_ds) -> dict:
    """The streaming compositor's training path: its gradient check, Trainer
    .fit with a checkpoint and an eval, a resume, the eval pass with LPIPS,
    and the 768x1024 S=128 recipe with remat. Returns the launches of each
    path (by kernel, K1/K2 split by size class) and the inputs of K5 at the
    recipe's size, for the timing phase."""
    import copy
    import shutil

    from mine_tpu_torch.config import load_config
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.inference.video import fov_intrinsics
    from mine_tpu_torch.losses.lpips import load_lpips_params
    from mine_tpu_torch.ops import mpi_render as mr
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.loop import Trainer, run_evaluation
    from mine_tpu_torch.training.step import batch_to_device, loss_fcn, make_disparity_list
    from mine_tpu_torch.utils.logging import MetricWriter, event_summaries

    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    out = {"launches": {}}
    chunk = train_cfg.mpi.stream_chunk_planes
    n_chunks = s // chunk

    # the gradient of a streaming render (K5 forward, the chunked scan's K1
    # and K2 in the backward) against the dense render's (K1, K2) and the
    # same chunked scan on the plain versions; B=4, S=32, 384x512
    tol = {"rel_l2": 1e-4, "max_abs_over_max_grad": 1e-5}
    gb = 4
    k = torch.from_numpy(fov_intrinsics(h, w))[None].to(dev).expand(gb, 3, 3).contiguous()
    operands = (torch.rand((gb, s, h, w, 3), generator=gen, device=dev),
                torch.rand((gb, s, h, w, 1), generator=gen, device=dev) * 4.0)
    rest = (torch.linspace(1.0, 0.001, s, device=dev)[None].expand(gb, s).contiguous(),
            torch.from_numpy(pose(0.08, -0.04, 0.15)).to(dev)[None].expand(gb, 4, 4).contiguous(),
            inverse_3x3(k), k)
    c_rgb = torch.randn((gb, h, w, 3), generator=gen, device=dev)
    c_disp = torch.randn((gb, h, w, 1), generator=gen, device=dev)

    def render_grads(render):
        rgb, sigma = (t.clone().requires_grad_() for t in operands)
        out_rgb, out_depth, _ = render(rgb, sigma, *rest)
        (torch.sum(out_rgb * c_rgb) + torch.sum(c_disp / out_depth)).backward()
        return rgb.grad, sigma.grad

    kw.reset_launches()
    got = render_grads(mr.render_tgt_rgb_depth_streaming)
    torch.cuda.synchronize()
    grad_launches = dict(kw.launches)
    want_launches = {"warp_composite": 1, "warp_bilinear": 2 * n_chunks - 1,
                     "warp_bilinear_grad": n_chunks}
    if grad_launches != want_launches:
        raise AssertionError(f"streaming render with a gradient launched {grad_launches}, "
                             f"expected {want_launches}")
    dense = render_grads(mr.render_tgt_rgb_depth)
    kernels = kw._warp_bilinear_forward, kw.warp_bilinear_grad
    kw._warp_bilinear_forward = kw.warp_bilinear_plain
    kw.warp_bilinear_grad = kw.warp_bilinear_grad_plain
    before = dict(kw.launches)
    try:
        plain = render_grads(mr.render_tgt_rgb_depth_streaming)
    finally:
        kw._warp_bilinear_forward, kw.warp_bilinear_grad = kernels
    if any(kw.launches[n] != before[n] for n in ("warp_bilinear", "warp_bilinear_grad")):
        raise AssertionError("the plain scan launched a warp kernel")
    gaps = {}
    for ref_name, ref in (("dense", dense), ("plain_scan", plain)):
        for name, a, b in zip(("d_rgb", "d_sigma"), got, ref):
            rel, mx = rel_l2_and_max(a, b)
            gaps[f"{name}_vs_{ref_name}"] = {"rel_l2": rel, "max_abs_over_max_grad": mx}
            if not (math.isfinite(rel) and rel <= tol["rel_l2"]
                    and mx <= tol["max_abs_over_max_grad"]):
                raise AssertionError(f"streaming {name} vs {ref_name}: rel L2 {rel}, max {mx}, "
                                     f"tolerance {tol}")
    render_rows = {}
    for label, render in (("streaming", mr.render_tgt_rgb_depth_streaming),
                          ("dense", mr.render_tgt_rgb_depth)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        render_grads(render)
        torch.cuda.synchronize()
        render_rows[label] = {
            "peak_alloc_gb_above_inputs": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "ms": time_cuda_ms(lambda r=render: render_grads(r), reps=5, inner=1, warmup=1)}
    emit(info, phase="streaming_grad_check", shape={"mpi": [gb, s, h, w, 4]}, chunk=chunk,
         tolerance=tol, gaps=gaps, launches=grad_launches, forward_backward=render_rows)
    del got, dense, plain, operands

    # Trainer.fit through the streaming compositor at the default width, with
    # a checkpoint and an eval on the card
    s_cfg = train_cfg.replace(**{"mpi.compositor": "streaming", "training.checkpoint_interval": 2,
                                 "training.eval_interval": 2,
                                 "data.per_gpu_batch_size": batch_size})
    s_ws = os.path.join(scratch, "train_streaming")
    s_trainer = Trainer(s_cfg, s_ws, state_dict=train_state)
    s_train_ds = build_dataset(s_cfg, "train", batch_size)
    s_val_ds = build_dataset(s_cfg, "val", batch_size)
    steps = 4
    tally = SizeTally(kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw.reset_launches()
    logged = s_trainer.fit(s_train_ds, s_val_ds, max_steps=steps)
    torch.cuda.synchronize()
    fit_launches, fit_sizes = dict(kw.launches), tally.read()
    fit_peak = torch.cuda.max_memory_allocated() / 1e9
    n_evals, saved = len(s_trainer.evals), ckpt.all_steps(s_ws)
    per_step = {"warp_composite": 4, "warp_bilinear": 4 * (2 * n_chunks - 1),
                "warp_bilinear_grad": 4 * n_chunks}
    expected = {name: n * steps for name, n in per_step.items()}
    expected["warp_composite"] += 4 * len(s_val_ds) * n_evals  # eval renders: K5 alone
    if fit_launches != expected:
        raise AssertionError(f"train_streaming launched {fit_launches}, expected {expected}")
    if not (saved and n_evals and math.isfinite(logged["loss"])
            and math.isfinite(logged["grad_norm"])):
        raise AssertionError(f"train_streaming: checkpoints {saved}, evals {n_evals}, {logged}")
    # what the last checkpoint holds, and an eval-mode loss on a fixed batch
    # with fixed disparities, for the resume below
    saved_state = copy.deepcopy(s_trainer.state())
    fixed = batch_to_device(next(iter(s_val_ds.epoch(0))), dev)
    fixed_disp = make_disparity_list(s_cfg.replace(**{"mpi.fix_disparity": True}),
                                     batch_size, dev)

    def eval_loss(tr):
        tr.model.eval()
        with torch.no_grad():
            total = loss_fcn(s_cfg, tr.model, fixed, disparity=fixed_disp)[0]
        tr.model.train()
        return total

    loss_before = eval_loss(s_trainer)
    # step time and peak memory, streaming and dense alternated on the same batches
    timed = list(itertools.islice(s_train_ds.epoch(2), 6))
    for batch in timed[:1]:
        s_trainer.step(batch)
        dense_trainer.step(batch)
    step_ms, peak_gb = {"streaming": [], "dense": []}, {}
    for i, batch in enumerate(timed[1:]):
        for label in (("streaming", "dense") if i % 2 == 0 else ("dense", "streaming")):
            tr = s_trainer if label == "streaming" else dense_trainer
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_ms[label].append(host_ms(lambda tr=tr, b=batch: tr.step(b), reps=1))
            peak_gb[label] = max(peak_gb.get(label, 0.0), torch.cuda.max_memory_allocated() / 1e9)
    emit(info, phase="train_streaming",
         config="default (resnet50, 384x512, S=32, bf16, streaming, chunk 4, stratified)",
         batch_size=batch_size, steps=steps, loss=logged["loss"], grad_norm=logged["grad_norm"],
         checkpoints=saved, evals=[st for st, _ in s_trainer.evals],
         eval_psnr=s_trainer.evals[-1][1]["psnr_tgt"], launches=fit_launches,
         launches_by_size_class=fit_sizes, launches_per_step=per_step,
         peak_allocated_gb_fit=fit_peak,
         train_step_ms={k: statistics.median(v) for k, v in step_ms.items()},
         train_step_ms_runs=step_ms, peak_allocated_gb_step=peak_gb,
         images_per_s={k: batch_size / (statistics.median(v) / 1e3) for k, v in step_ms.items()})
    emit(info, phase="profile", path="train_step_streaming", batch_size=batch_size,
         **profile_breakdown(lambda: s_trainer.step(timed[0]), 1))
    out["launches"]["train_streaming"] = {"kernels": fit_launches, "sizes": fit_sizes}

    # a new Trainer on the same workspace resumes at the saved step, bit-equal
    r_trainer = Trainer(s_cfg, s_ws)
    r_trainer.fit(s_train_ds, max_steps=saved[-1])
    a, b = saved_state, r_trainer.state()
    same = {
        "global_step": a["global_step"] == b["global_step"] == saved[-1] == steps,
        "model_and_bn_buffers": all(torch.equal(a["model"][n], b["model"][n]) for n in a["model"]),
        "optimizer": all(torch.equal(x[n], y[n]) for x, y in zip(
            a["optimizer"]["state"].values(), b["optimizer"]["state"].values()) for n in x),
        "scheduler": a["scheduler"] == b["scheduler"],
        "generators": all(torch.equal(a["generators"][n], b["generators"][n])
                          for n in a["generators"]),
    }
    loss_after = eval_loss(r_trainer)
    same["eval_loss"] = bool(torch.equal(loss_before, loss_after))
    if not all(same.values()):
        raise AssertionError(f"train_resume is not bit-equal: {same}")
    emit(info, phase="train_resume", resumed_at=r_trainer.global_step, bit_equal=same,
         eval_loss=loss_after.item())
    del r_trainer, saved_state

    # the eval pass over the synthetic val split, LPIPS at full width
    lpips_path = os.path.join(scratch, "lpips_seeded.npz")
    write_seeded_lpips(lpips_path)
    e_cfg = s_cfg.replace(**{"training.lpips_weights_path": lpips_path})
    lpips_params = load_lpips_params(lpips_path, dev)
    # its val/ scalars and image grids to an event file (tensorboardX), or,
    # where tensorboardX does not import, to a recording stand-in
    events_dir = os.path.join(scratch, "eval_events")
    writer = MetricWriter(events_dir)
    try:
        import tensorboardX  # noqa: F401

        recorder = None
    except ImportError:
        recorder = writer._tb = GridRecorder()
    kw.reset_launches()
    t0 = time.perf_counter()
    result = run_evaluation(e_cfg, s_trainer.model, s_val_ds, dev, lpips_params,
                            s_trainer.global_step, writer=writer)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    writer.close()
    eval_launches = dict(kw.launches)
    s_trainer.model.train()
    want = {"warp_composite": 4 * len(s_val_ds), "warp_bilinear": 0, "warp_bilinear_grad": 0}
    if eval_launches != want or result["eval_examples"] != s_val_ds.num_eval_examples \
            or not result["lpips_tgt"] > 0 or not all(map(math.isfinite, result.values())):
        raise AssertionError(f"eval_path: launches {eval_launches} (want {want}), {result}")
    grid_hw = (h, min(4, batch_size) * w)
    tags = ("val/tgt_syn", "val/src_syn", "val/tgt_disparity")
    if recorder is None:
        found = event_summaries(events_dir)
        grids = {t: found.get(t) for t in tags}
        if not all(g and g["kind"] == "image" and g["hw"] == grid_hw for g in grids.values()):
            raise AssertionError(f"eval_path: image grids in the event file {grids}")
    else:
        grids = {t: [list(a.shape), float(a.min()), float(a.max())]
                 for t, a in recorder.images.items()}
        if set(grids) != set(tags) or not all(
                a.shape[:2] == grid_hw and np.isfinite(a).all() and 0 <= a.min() <= a.max() <= 1
                for a in recorder.images.values()):
            raise AssertionError(f"eval_path: image grid arrays {grids}")
    emit(info, phase="eval_path", metrics=result, eval_examples=result["eval_examples"],
         seconds=eval_s, launches=eval_launches,
         image_grids=grids if recorder is None else {
             "tensorboardX": "did not import; the arrays were checked", **grids})
    out["launches"]["eval"] = {"kernels": eval_launches}
    del s_trainer
    torch.cuda.empty_cache()

    # the 768x1024, S=128, B=1 recipe with remat (mine_tpu/configs/llff_highres.yaml)
    hr_cfg = load_config(os.path.join(root, "mine_tpu", "configs", "llff_highres.yaml"),
                         overrides={"data.name": "synthetic", "mpi.compositor": "streaming"})
    hh, hw, hs, _ = HIGHRES
    if (hr_cfg.data.img_h, hr_cfg.data.img_w, hs, hr_cfg.data.per_gpu_batch_size) \
            != HIGHRES or not hr_cfg.model.remat_decoder:
        raise AssertionError(f"llff_highres.yaml is not the {HIGHRES} (H, W, S, B) remat recipe")
    hr_trainer = Trainer(hr_cfg)
    hr_ds = build_dataset(hr_cfg, "train", 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hr_trainer.fit(hr_ds, max_steps=1)  # warm-up
    kw.reset_launches()
    tally.reset()
    hr_ms = [host_ms(lambda b=b: hr_trainer.step(b), reps=1)
             for b in itertools.islice(hr_ds.epoch(1), 1, 3)]
    torch.cuda.synchronize()
    hr_launches, hr_sizes = dict(kw.launches), tally.read()
    hr_peak = torch.cuda.max_memory_allocated() / 1e9
    hr_chunks = hs // hr_cfg.mpi.stream_chunk_planes
    hr_per_step = {"warp_composite": 4, "warp_bilinear": 4 * (2 * hr_chunks - 1),
                   "warp_bilinear_grad": 4 * hr_chunks}
    if hr_launches != {n: 2 * v for n, v in hr_per_step.items()}:
        raise AssertionError(f"train_highres launched {hr_launches} in 2 steps, "
                             f"expected {hr_per_step} a step")
    if hr_sizes["warp_bilinear"]["banded"] != 2 * (2 * hr_chunks - 1) \
            or hr_sizes["warp_bilinear_grad"]["banded"] != 2 * hr_chunks:
        raise AssertionError(f"train_highres: scale 0 is not the banded size class {hr_sizes}")
    emit(info, phase="train_highres",
         config="llff_highres.yaml (resnet50, 768x1024, S=128, B=1, bf16, remat) + synthetic, "
                "streaming", train_step_ms=statistics.median(hr_ms), train_step_ms_runs=hr_ms,
         peak_allocated_gb=hr_peak, launches=hr_launches, launches_by_size_class=hr_sizes,
         launches_per_step=hr_per_step)
    out["launches"]["train_highres"] = {"kernels": hr_launches, "sizes": hr_sizes}
    del hr_trainer
    tally.close()
    torch.cuda.empty_cache()

    # K5 at the recipe's size, for the timing phase
    kh = torch.from_numpy(fov_intrinsics(hh, hw))[None].to(dev)
    hr_mpi = (torch.rand((1, hs, hh, hw, 3), generator=gen, device=dev),
              torch.rand((1, hs, hh, hw, 1), generator=gen, device=dev) * 4.0)
    out["k5_highres"] = (*hr_mpi, *mr.streaming_matrices(
        torch.linspace(1.0, 0.001, hs, device=dev)[None],
        torch.from_numpy(pose(0.08, -0.04, 0.15))[None].to(dev), inverse_3x3(kh), kh))
    return out


# the stored size of real LLFF images_8 (4032x3024 / 8), which the default
# recipe resizes bicubically to 384x512
LLFF_STORED_HW = (378, 504)
# the feed timing: rounds of the three feeds in turn, steps per feed and
# round, and how many of those first steps are not counted (the pipeline
# fills: 4 workers build up to 4 batches ahead)
FEED_ROUNDS, FEED_STEPS, FEED_SKIP = 1, 6, 2
# recipe yaml -> fixture writer arguments near the recipe's own size, with
# at least one batch of train views (DTU's B=8 needs 8); flowers' writer
# needs square views, so its 384x384 tiles are resized to 384x512
RECIPE_FIXTURES = {
    "realestate": {"hw": (256, 384)},
    "kitti_raw": {"hw": (128, 384)},
    "dtu": {"hw": (256, 384), "n_views": 8},
    "flowers": {"hw": (384, 384)},
    "objectron": {"hw": (384, 640)},
    "nocs_llff": {},  # always stored at 384x640, the loader's crop
}
# the sparse points each sparse-depth fixture holds, against the recipe's
# data.visible_point_count (drawn with replacement from fewer)
RECIPE_POINTS = {
    "realestate10k": "a 64-point sequence cloud; 256 drawn with replacement",
    "objectron": "a 64-point scene cloud; 250 drawn with replacement",
    "nocs_llff": "80 points tracked a view; data.visible_point_count 256 -> 64",
}


def run_cli(argv: list[str], timeout_s: float = 300.0) -> subprocess.CompletedProcess:
    """`python -m <argv>` from the checkout's root on the card; raises with its
    stderr if it exits non-zero."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=root, capture_output=True,
                          text=True, timeout=timeout_s)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {argv[0]} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return proc


def data_phases(info, dev, train_state) -> dict:
    """Training from the datasets' own on-disk formats: the default recipe
    (ResNet-50, 384x512, S=32, B=4, bf16, dense) from an LLFF fixture stored
    at 378x504, through Trainer.fit with a checkpoint and an eval and through
    the train and evaluate CLIs; the loader's costs (construction, batch
    build, the copy to the card from pageable and pinned memory); the step
    fed three ways (the loader with 4 workers and with 0, synthetic batches),
    alternated, for both compositors; then the six other recipes at their own
    shapes from their fixtures, contract-checked, 2 steps each. Returns the
    launches of each path (by kernel and TPU size class) and the workspace
    Trainer.fit wrote."""
    import shutil

    from mine_tpu_torch.config import load_config
    from mine_tpu_torch.data.conformance import check_contract, contract_for_config
    from mine_tpu_torch.data.conformance.fixtures import write_fixture
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.loop import Trainer, staged_batches
    from mine_tpu_torch.training.step import batch_to_device, pin_batch

    root = os.path.dirname(os.path.abspath(__file__))
    configs = os.path.join(root, "mine_tpu", "configs")
    scratch = os.path.join(root, "build", "chip_smoke", "data")
    shutil.rmtree(scratch, ignore_errors=True)
    out = {}
    tally = SizeTally(kw)

    def counted(path: str, fn):
        """fn() with the launch counts read around it alone."""
        torch.cuda.synchronize()
        kw.reset_launches()
        tally.reset()
        result = fn()
        torch.cuda.synchronize()
        out[path] = {"kernels": dict(kw.launches), "sizes": tally.read()}
        return result

    # the default recipe from its own format: the LLFF fixture at the stored
    # size of real images_8, 8 train + 3 val views
    t0 = time.perf_counter()
    path = write_fixture("llff", os.path.join(scratch, "llff"), hw=LLFF_STORED_HW,
                         n_views=8, n_val_views=3)
    write_s = time.perf_counter() - t0
    reduced = {"data.img_pre_downsample_ratio": 1.0,  # the camera sits at stored size
               "data.visible_point_count": 64}  # the fixture tracks 80 points a view
    overrides = {"data.training_set_path": path, **reduced, "training.log_interval": 1,
                 "training.checkpoint_interval": 3, "training.eval_interval": 3}
    cfg = load_config(os.path.join(configs, "default.yaml"), overrides=overrides)
    b = cfg.data.per_gpu_batch_size
    if (cfg.data.name, cfg.data.img_h, cfg.data.img_w, cfg.mpi.num_bins_coarse, b,
            cfg.model.num_layers, cfg.model.dtype, cfg.mpi.compositor) != \
            ("llff", 384, 512, 32, 4, 50, "bfloat16", "dense"):
        raise AssertionError(f"default.yaml is not the LLFF recipe this phase drives: {cfg}")
    t0 = time.perf_counter()
    train_ds = build_dataset(cfg, "train", b)
    val_ds = build_dataset(cfg, "val", b)
    construct_s = time.perf_counter() - t0
    n_images = len(train_ds.frames) + len(val_ds.frames)
    build_ms = []
    for e in range(1, 6):  # epoch() alone: each batch stacked and its points drawn
        t0 = time.perf_counter()
        n = sum(1 for _ in train_ds.epoch(e))
        build_ms.append((time.perf_counter() - t0) * 1e3 / n)
    syn_ds = build_dataset(cfg.replace(**{"data.name": "synthetic"}), "train", b)
    syn_build_ms = []
    for e in range(3):  # epoch() alone: the first batch, rendered by numpy
        t0 = time.perf_counter()
        next(iter(syn_ds.epoch(e)))
        syn_build_ms.append((time.perf_counter() - t0) * 1e3)
    batch = next(iter(train_ds.epoch(0)))
    batch_bytes = sum(v.nbytes for v in batch.values())
    image_bytes = batch["src_img"].nbytes + batch["tgt_img"].nbytes
    h2d = {"pageable": [], "pinned": [], "pin": []}
    for rep in range(12):
        for kind in ("pageable", "pinned") if rep % 2 == 0 else ("pinned", "pageable"):
            src = batch
            if kind == "pinned":
                t0 = time.perf_counter()
                src = pin_batch(batch)
                h2d["pin"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_to_device(src, dev)
            torch.cuda.synchronize()
            h2d[kind].append((time.perf_counter() - t0) * 1e3)
    emit(info, phase="data_loader", recipe="default.yaml (llff)", fixture={
        "stored_hw": list(LLFF_STORED_HW), "train_views": len(train_ds.frames),
        "val_views": len(val_ds.frames), "points_per_view": 80, "write_s": write_s},
         reduced=reduced, construct_s=construct_s, images=n_images,
         images_per_s=n_images / construct_s, batch_build_ms=statistics.median(build_ms),
         batch_build_ms_runs=build_ms, synthetic_batch_build_ms=statistics.median(syn_build_ms),
         synthetic_batch_build_ms_runs=syn_build_ms, batch_bytes=batch_bytes,
         image_bytes=image_bytes,
         h2d_ms={k: statistics.median(v) for k, v in h2d.items()}, h2d_ms_runs=h2d)

    # Trainer.fit: 3 steps, a checkpoint and the eval at step 3
    ws = os.path.join(scratch, "ws_fit")
    trainer = Trainer(cfg, ws, state_dict=train_state)
    steps = 3
    logged = counted("data_llff", lambda: trainer.fit(train_ds, val_ds, max_steps=steps))
    with open(os.path.join(ws, "train_log.jsonl")) as fh:
        log = [json.loads(ln) for ln in fh]
    (val_batch,) = list(val_ds.epoch(0))
    want = {"warp_bilinear": 4 * steps + 4 * len(val_ds), "warp_bilinear_grad": 4 * steps,
            "warp_composite": 0}
    result = trainer.evals[-1][1]
    if out["data_llff"]["kernels"] != want or ckpt.all_steps(ws) != [steps] \
            or [ln["global_step"] for ln in log] != [1, 2, 3] \
            or not all(math.isfinite(ln["loss"]) and math.isfinite(ln["grad_norm"])
                       for ln in log) \
            or list(val_batch["eval_weight"]) != [1.0, 1.0, 1.0, 0.0] \
            or result["eval_examples"] != 3 or val_ds.num_eval_examples != 3 \
            or not all(map(math.isfinite, result.values())):
        raise AssertionError(f"data_llff: launches {out['data_llff']}, want {want}; "
                             f"checkpoints {ckpt.all_steps(ws)}; log {log}; eval {result}")
    del trainer
    torch.cuda.empty_cache()  # the subprocesses need the memory this process caches

    # the same steps through the CLIs, as subprocesses on the card
    cli_ws = os.path.join(scratch, "ws_cli")
    t0 = time.perf_counter()
    run_cli(["mine_tpu_torch.train", "--config", os.path.join(configs, "default.yaml"),
             "--workspace", cli_ws, "--max_steps", str(steps),
             "--extra_config", json.dumps(overrides)])
    train_cli_s = time.perf_counter() - t0
    with open(os.path.join(cli_ws, "train_log.jsonl")) as fh:
        cli_log = [json.loads(ln) for ln in fh]
    t0 = time.perf_counter()
    lines = run_cli(["mine_tpu_torch.evaluate", "--checkpoint", cli_ws]).stdout.strip()
    eval_cli_s = time.perf_counter() - t0
    cli_eval = json.loads(lines.splitlines()[-1])
    if len(lines.splitlines()) != 1 or cli_eval["eval_examples"] != 3 \
            or not all(map(math.isfinite, cli_eval.values())) \
            or [ln["global_step"] for ln in cli_log] != [1, 2, 3] \
            or not all(math.isfinite(ln["loss"]) for ln in cli_log):
        raise AssertionError(f"data_llff CLIs: log {cli_log}, eval {lines}")
    emit(info, phase="data_llff",
         config="default.yaml (llff, resnet50, 384x512, S=32, B=4, bf16, dense, stratified)",
         reduced=reduced, steps=steps, losses=[ln["loss"] for ln in log],
         grad_norms=[ln["grad_norm"] for ln in log], checkpoints=[steps],
         eval={"eval_examples": result["eval_examples"], "val_batches": len(val_ds),
               "eval_weight": val_batch["eval_weight"].tolist(), "loss": result["loss"],
               "psnr_tgt": result["psnr_tgt"]},
         launches=out["data_llff"], launches_per_step={"warp_bilinear": 4,
                                                       "warp_bilinear_grad": 4},
         cli={"train_s": train_cli_s, "losses": [ln["loss"] for ln in cli_log],
              "eval_s": eval_cli_s, "eval": cli_eval})

    # train_step_ms fed three ways, alternated on one trainer per compositor:
    # the loop's own staging (staged_batches), one host sync a step (the
    # loss read, as the loop's logging does at log_interval 1)
    feeds = {"llff_workers4": (train_ds, 4), "llff_workers0": (train_ds, 0),
             "synthetic_workers4": (syn_ds, 4)}

    def quiesce(timeout_s: float = 10.0) -> None:
        """Wait until every abandoned pipeline's producer threads have gone,
        so that one feed's threads do not run into the next one's steps."""
        deadline = time.perf_counter() + timeout_s
        while any(t.name == "batch-prefetch" for t in threading.enumerate()):
            if time.perf_counter() > deadline:
                raise AssertionError("a closed pipeline's producer threads are still alive")
            time.sleep(0.01)

    def feed(tr, ds, workers) -> dict[str, list[float]]:
        """FEED_STEPS steps through the loop's staging: per step the wait for
        the batch and the step itself (to its loss on the host)."""
        epochs = itertools.chain.from_iterable(ds.epoch(e) for e in itertools.count(1))
        batches = staged_batches(epochs, dev, workers)
        times = {"wait_ms": [], "step_ms": [], "total_ms": []}
        try:
            for _ in range(FEED_STEPS):
                t0 = time.perf_counter()
                batch_ = next(batches)
                t1 = time.perf_counter()
                tr.step(batch_)["loss"].item()
                t2 = time.perf_counter()
                for key, v in (("wait_ms", t1 - t0), ("step_ms", t2 - t1), ("total_ms", t2 - t0)):
                    times[key].append(v * 1e3)
        finally:
            batches.close()
            quiesce()
        # the first steps wait for the pipeline to fill
        return {k: v[FEED_SKIP:] for k, v in times.items()}

    def feed_rounds():
        step_ms = {}
        for compositor in ("dense", "streaming"):
            tr = Trainer(cfg.replace(**{"mpi.compositor": compositor}), state_dict=train_state)
            tr.fit(train_ds, max_steps=1)  # the optimizer, and a warm-up step
            quiesce()
            runs = {name: {"wait_ms": [], "step_ms": [], "total_ms": []} for name in feeds}
            names = list(feeds)
            for r in range(FEED_ROUNDS):
                for name in names[r:] + names[:r]:
                    for key, v in feed(tr, *feeds[name]).items():
                        runs[name][key] += v
            step_ms[compositor] = runs
            del tr
            torch.cuda.empty_cache()
        return step_ms

    step_ms = counted("data_feed", feed_rounds)
    n_fed = 1 + FEED_ROUNDS * len(feeds) * FEED_STEPS  # with each compositor's warm-up
    n_chunks = cfg.mpi.num_bins_coarse // cfg.mpi.stream_chunk_planes
    # a step renders 4 scales: dense K1 + K2 each, streaming K5 + its scan's
    # 2 S/chunk - 1 K1 and S/chunk K2
    want = {"warp_bilinear": n_fed * 4 * (1 + 2 * n_chunks - 1),
            "warp_bilinear_grad": n_fed * 4 * (1 + n_chunks), "warp_composite": n_fed * 4}
    if out["data_feed"]["kernels"] != want:
        raise AssertionError(f"data_feed launched {out['data_feed']}, want {want}")
    emit(info, phase="data_feed", config="default.yaml (llff) from the fixture, B=4",
         feeds={k: {"dataset": ds.__class__.__name__, "num_workers": nw}
                for k, (ds, nw) in feeds.items()},
         train_step_ms={c: {k: statistics.median(v["total_ms"]) for k, v in runs.items()}
                        for c, runs in step_ms.items()},
         median={c: {k: {m: statistics.median(x) for m, x in v.items()} for k, v in runs.items()}
                 for c, runs in step_ms.items()},
         runs=step_ms, counted_per_segment=FEED_STEPS - FEED_SKIP, steps_per_compositor=n_fed,
         launches=out["data_feed"])

    # the six other recipes at their own shapes, from their own formats
    rows = {}

    def recipes():
        for name, fixture_kwargs in RECIPE_FIXTURES.items():
            family = contract_for_config(name).family
            rcfg = load_config(os.path.join(configs, "default.yaml"),
                               os.path.join(configs, name + ".yaml"))
            shape = {"data.img_h": rcfg.data.img_h, "data.img_w": rcfg.data.img_w}
            t0 = time.perf_counter()
            verdict = check_contract(name, os.path.join(scratch, name), overrides=shape,
                                     fixture_kwargs=fixture_kwargs)
            if not verdict["ok"]:
                raise AssertionError(f"data_recipes {name}: contract {verdict['checks']}")
            cut = {"data.visible_point_count": 64} if family == "nocs_llff" else {}
            rcfg = rcfg.replace(**{"data.training_set_path": verdict["fixture"], **cut})
            rb = rcfg.data.per_gpu_batch_size
            rds = build_dataset(rcfg, "train", rb)
            before = dict(kw.launches)
            tr = Trainer(rcfg, state_dict=train_state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rlogged = tr.fit(rds, max_steps=2)
            torch.cuda.synchronize()
            launched = {k: kw.launches[k] - before[k] for k in before}
            if launched != {"warp_bilinear": 8, "warp_bilinear_grad": 8, "warp_composite": 0} \
                    or not (math.isfinite(rlogged["loss"])
                            and math.isfinite(rlogged["grad_norm"])):
                raise AssertionError(f"data_recipes {name}: launches {launched}, {rlogged}")
            rows[name] = dict(
                family=family,
                shape={"img_hw": [rcfg.data.img_h, rcfg.data.img_w],
                       "planes": rcfg.mpi.num_bins_coarse, "batch": rb},
                mpi={"disparity_start": rcfg.mpi.disparity_start,
                     "disparity_end": rcfg.mpi.disparity_end,
                     "is_bg_depth_inf": rcfg.mpi.is_bg_depth_inf,
                     "valid_mask_threshold": rcfg.mpi.valid_mask_threshold},
                fixture={"writer_args": fixture_kwargs, "train_views": len(rds.frames)},
                reduced={"scenes": 1, "train_views": len(rds.frames),
                         "points": RECIPE_POINTS.get(family), **cut},
                contract=verdict["checks"], loss=rlogged["loss"],
                grad_norm=rlogged["grad_norm"], launches=launched,
                peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                seconds=time.perf_counter() - t0)
            emit(info, phase="data_recipe", recipe=name + ".yaml", **rows[name])
            del tr
            torch.cuda.empty_cache()

    counted("data_recipes", recipes)
    tally.close()
    return out, ws


def decode_png(b64: str) -> np.ndarray:
    import base64
    import io

    from PIL import Image

    with Image.open(io.BytesIO(base64.b64decode(b64))) as im:
        return np.asarray(im)


# the /render rounds: offsets per request, and the concurrent clients
SERVE_RENDERS = (1, 8, 64)
SERVE_CLIENTS, SERVE_ROUNDS = 8, 10


def serve_phases(info, dev, ws: str, images: list[np.ndarray]) -> dict:
    """The HTTP server over a trained workspace (the data_llff phase's):
    first the real entry point, `python -m mine_tpu_torch.serving` as a
    subprocess through the conformance runner's serve stage; then a
    ServingApp behind make_server in this process: /predict of one image
    twice (a miss and a hit) and of another (a second miss), /render of 1, 8
    and 64 offsets (frames equal to the engine's
    own render after the same uint8 rounding), 8 concurrent clients
    rendering one pose each of one MPI, /healthz, /metrics, /debug/trace,
    GET /mpi/<key> parsed by from_wire, and hot swaps through /admin/swap (a
    new step, then a shape-mismatched one, refused with 422); then the same
    round at the int8 tier with pruning; then one app per pruned plane
    bucket, its threshold chosen from the served MPI's own plane
    contributions so that the predict keeps just enough planes for that
    bucket. K5 is held against its plain version at every plane count it
    ran at, on the inputs of the last launch of a real /render at that count
    (a served MPI and a moved pose). The launch counts are the server's
    own: its warm-ups and its traffic, not the renders this script makes to
    check the frames. Returns the phase's launches and K5's inputs per plane
    count, for the timing phase."""
    import contextlib
    import io

    from PIL import Image

    from mine_tpu_torch.data.conformance.runner import http_request, serve_stage
    from mine_tpu_torch.inference.video import to_uint8
    from mine_tpu_torch.inference.trajectory import poses_from_offsets
    from mine_tpu_torch.ops import mpi_render
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.serving.cache import MPIEntry, key_from_str
    from mine_tpu_torch.serving.compress import from_wire, keep_mask
    from mine_tpu_torch.serving.server import ServingApp, make_server
    from mine_tpu_torch.training import checkpoint as ckpt

    # the real entry point first, while the workspace holds its trained step
    torch.cuda.empty_cache()
    cli = serve_stage(ws, timeout_s=600.0)
    if not cli["ok"] or cli["checkpoint_step"] != ckpt.latest_step(ws) \
            or cli["backend"] != "cuda":
        raise AssertionError(f"serve_cli: {cli}")
    emit(info, phase="serve_cli", command="python -m mine_tpu_torch.serving --workspace "
         "<data_llff workspace> --port 0", **{k: v for k, v in cli.items() if k != "ok"})

    # every K5 launch of the server by plane count; while `recording` is
    # set, the inputs of the latest launch at each plane count
    k5_inputs: dict[int, tuple] = {}
    k5_by_planes: dict[int, int] = {}
    k5_mode = {"counting": True, "recording": None}
    excluded = dict.fromkeys(kw.launches, 0)  # the check renders' launches
    real_composite = mpi_render.warp_composite

    def tally(*ops):
        before = kw.launches["warp_composite"]
        out = real_composite(*ops)
        if kw.launches["warp_composite"] > before:
            s_planes = ops[0].shape[1]
            if k5_mode["counting"]:
                k5_by_planes[s_planes] = k5_by_planes.get(s_planes, 0) + 1
            if k5_mode["recording"] is not None:
                k5_mode["recording"][s_planes] = ops
        return out

    @contextlib.contextmanager
    def uncounted():
        """This script's own reference renders: left out of the counts."""
        before = dict(kw.launches)
        k5_mode["counting"] = False
        try:
            yield
        finally:
            k5_mode["counting"] = True
            for name in excluded:
                excluded[name] += kw.launches[name] - before[name]

    @contextlib.contextmanager
    def recorded():
        """Keep K5's inputs of the last launch in the block at each plane
        count not yet held: a served MPI at a pose the request moved to."""
        k5_mode["recording"] = seen = {}
        try:
            yield
        finally:
            k5_mode["recording"] = None
        for s_planes, ops in seen.items():
            eye = torch.eye(3, device=ops[2].device)
            if ops[1].abs().max().item() == 0.0 or (ops[2] - eye).abs().max().item() < 1e-4:
                raise AssertionError(f"K5's recorded S={s_planes} inputs are an empty MPI "
                                     "or an identity pose")
            k5_inputs.setdefault(s_planes, tuple(t.clone() for t in ops))

    def png_of(img: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return buf.getvalue()

    png, png2 = png_of(images[0]), png_of(images[1])

    def check_frames(app, entry, body: bytes, offsets: list, what: str) -> np.ndarray:
        """/render's frames, decoded; they must equal the engine's own
        render of the entry after the same uint8 rounding."""
        frames = np.stack([decode_png(f) for f in json.loads(body)["frames_png_b64"]])
        with uncounted():
            want = to_uint8(np.clip(app.engine.render(
                entry, poses_from_offsets(np.asarray(offsets)))[0], 0.0, 1.0))
        if frames.shape != want.shape or not np.array_equal(frames, want):
            raise AssertionError(f"{what} differs from the engine's own frames, max |diff| "
                                 f"{np.abs(frames.astype(int) - want).max()}")
        return frames

    @contextlib.contextmanager
    def http_server(app):
        """app behind make_server on a free localhost port; yields its URL."""
        server = make_server(app, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            yield "http://%s:%d" % server.server_address[:2]
        finally:
            server.shutdown()
            server.server_close()

    def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
        mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
        return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)

    def drive(app, label: str) -> dict:
        """One HTTP round against app; returns what it measured."""
        m = app.metrics
        row: dict = {}
        with http_server(app) as base:
            # a miss, a hit of the same image, then a miss of another image;
            # the spans say where each one's time went
            predict_ms, predict_spans, preds = {}, {}, {}
            for name, data in (("miss", png), ("hit", png), ("second_miss", png2)):
                app.tracer.phase_summary(reset=True)
                t = time.perf_counter()
                code, body = http_request(base, "/predict", data, {"Content-Type": "image/png"})
                predict_ms[name] = (time.perf_counter() - t) * 1e3
                predict_spans[name] = {k: v["total_ms"]
                                       for k, v in app.tracer.phase_summary(reset=True).items()}
                if code != 200:
                    raise AssertionError(f"{label} /predict {code}: {body[:300]!r}")
                preds[name] = json.loads(body)
            pred = preds["hit"]
            if not pred["cached"] or preds["second_miss"]["cached"] \
                    or m.encoder_invocations.value() != 2:
                raise AssertionError(f"{label}: the second predict was not a cache hit "
                                     f"({preds}, encoder {m.encoder_invocations.value()})")
            key = pred["mpi_key"]
            row.update(predict_ms=predict_ms, predict_spans_ms=predict_spans, predict=pred,
                       png_bytes=len(png))
            entry = app.cache.get(key_from_str(key), record=False)
            bucket = app.engine.bucket(entry.bucket)
            row["plane_bucket"] = bucket.plane_bucket(pred["planes_kept"])
            renders = {}
            for n in SERVE_RENDERS:
                offsets = [[0.02 * math.sin(i / 5.0), 0.01 * math.cos(i / 7.0), 0.05 * i / n]
                           for i in range(n)]
                app.tracer.phase_summary(reset=True)
                t = time.perf_counter()
                with recorded() if n == max(SERVE_RENDERS) else contextlib.nullcontext():
                    code, body = http_request(base, "/render", json.dumps(
                        {"mpi_key": key, "offsets": offsets}).encode(),
                        {"Content-Type": "application/json"})
                wall = (time.perf_counter() - t) * 1e3
                spans = app.tracer.phase_summary(reset=True)
                if code != 200:
                    raise AssertionError(f"{label} /render {n} {code}: {body[:300]!r}")
                frames = check_frames(app, entry, body, offsets, f"{label} /render of {n}")
                renders[n] = {
                    "wall_ms": wall, "ms_per_frame": wall / n,
                    "dispatch_ms_per_frame": spans["serve.dispatch"]["total_ms"] / n,
                    "png_encode_ms_per_frame": spans["serve.encode"]["total_ms"] / n,
                    "frames_equal_engine_render": True,
                }
                row.setdefault("frames", {})[n] = frames
            row["render"] = renders

            # concurrent clients, one pose each of the same MPI
            reqs0, disp0 = m.batch_requests.value(), m.batch_dispatches.value()
            barrier = threading.Barrier(SERVE_CLIENTS)
            codes, latency_ms, errors = [], [], []

            def client(i):
                try:
                    for r in range(SERVE_ROUNDS):
                        barrier.wait(timeout=120)
                        t0 = time.perf_counter()
                        c, _ = http_request(base, "/render", json.dumps(
                            {"mpi_key": key, "offsets": [[0.01 * i, 0.0, 0.01 * r]]}).encode(),
                            {"Content-Type": "application/json"})
                        latency_ms.append((time.perf_counter() - t0) * 1e3)
                        codes.append(c)
                except Exception as exc:  # noqa: BLE001 - reported below, the others freed
                    errors.append(f"client {i}: {type(exc).__name__}: {exc}")
                    barrier.abort()

            app.tracer.phase_summary(reset=True)
            t = time.perf_counter()
            workers = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
            for wkr in workers:
                wkr.start()
            for wkr in workers:
                wkr.join(timeout=600)
            if errors or any(wkr.is_alive() for wkr in workers):
                raise AssertionError(f"{label}: concurrent clients failed or hung: {errors}")
            wall = time.perf_counter() - t
            spans = app.tracer.phase_summary(reset=True)
            n_req = m.batch_requests.value() - reqs0
            n_disp = m.batch_dispatches.value() - disp0
            if codes.count(200) != SERVE_CLIENTS * SERVE_ROUNDS:
                raise AssertionError(f"{label}: concurrent renders answered {sorted(set(codes))}")
            row["concurrent"] = {
                "clients": SERVE_CLIENTS, "rounds": SERVE_ROUNDS, "requests": n_req,
                "dispatches": n_disp, "coalescing_ratio": n_req / n_disp,
                "requests_per_s": n_req / wall, "wall_s": wall,
                "latency_ms": {"p50": float(np.percentile(latency_ms, 50)),
                               "p95": float(np.percentile(latency_ms, 95)),
                               "max": max(latency_ms)},
                # host spans over the block: where a request's time went
                "spans_total_ms": {k: v["total_ms"] for k, v in spans.items()},
                "spans_count": {k: v["count"] for k, v in spans.items()},
            }

            code, body = http_request(base, "/healthz")
            health = json.loads(body)
            code_m, metrics_text = http_request(base, "/metrics")
            families = sorted({ln.split()[2] for ln in metrics_text.decode().splitlines()
                               if ln.startswith("# TYPE")})
            code_t, trace = http_request(base, "/debug/trace")
            events = json.loads(trace)["traceEvents"]
            if code != 200 or code_m != 200 or code_t != 200 or health["status"] != "ok" \
                    or "mine_serve_encoder_invocations_total" not in families \
                    or "mine_build_info" not in families \
                    or not any(e.get("name") == "dispatch" for e in events):
                raise AssertionError(f"{label}: healthz {code} {health}, metrics {code_m}, "
                                     f"trace {code_t}")
            row.update(healthz=health, metric_families=len(families),
                       trace_events=len(events))

            code, blob = http_request(base, "/mpi/" + key)
            wire = from_wire(blob)
            pairs = ([(wire.mpi_rgb, entry.mpi_rgb), (wire.mpi_sigma, entry.mpi_sigma)]
                     if isinstance(entry, MPIEntry) else
                     [(wire.rgb, entry.rgb), (wire.sigma, entry.sigma)])
            if code != 200 or not all(torch.equal(a, b.cpu()) for a, b in pairs):
                raise AssertionError(f"{label}: GET /mpi/<key> {code} does not round-trip")
            row["wire_bytes"] = len(blob)
            row["key"] = key
            row["entry"] = entry
            return row

    cfg, state, step = ckpt.load_for_serving(ws)
    mpi_render.warp_composite = tally
    tallies = SizeTally(kw)
    try:
        torch.cuda.synchronize()
        kw.reset_launches()
        tallies.reset()
        t = time.perf_counter()
        app = ServingApp(cfg, state, checkpoint_step=step, swap_source=ws)
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        warm = app.engine.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        fp32 = drive(app, "fp32")

        # hot swap: a new step (the trained weights, perturbed) into the workspace
        path = os.path.join(ckpt.checkpoint_path(ws), str(step), ckpt.STATE_FILE)
        raw = torch.load(path, map_location="cpu", weights_only=True)
        gen = torch.Generator().manual_seed(7)
        raw["model"] = {k: (v + 1e-3 * torch.randn(v.shape, generator=gen) if v.dim() == 4
                            else v) for k, v in raw["model"].items()}  # the conv kernels
        ckpt.save(ws, raw, step + 1)
        with http_server(app) as base:
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            code, body = http_request(base, "/admin/swap", json.dumps({"wait": True}).encode())
            swap_s = time.perf_counter() - t
            torch.cuda.synchronize()
            mem_after = torch.cuda.memory_allocated()
            swapped = json.loads(body)
            old_code, _ = http_request(base, "/render", json.dumps(
                {"mpi_key": fp32["key"], "offsets": [[0.01, 0.0, 0.0]]}).encode())
            code_p, body_p = http_request(base, "/predict", png, {"Content-Type": "image/png"})
            new_key = json.loads(body_p)["mpi_key"]
            if code != 200 or swapped["state"] != "ok" or swapped["generation"] != 1 \
                    or app.engine.generation != 1 or old_code != 200 or code_p != 200 \
                    or new_key.split(":")[1] != str(step + 1):
                raise AssertionError(f"swap: {code} {swapped}, old key render {old_code}, "
                                     f"new predict {code_p} {new_key}")
            # a candidate whose shapes do not match: 422, generation 1 serves on
            bad = dict(raw)
            name = next(k for k, v in raw["model"].items() if v.dim() == 4)
            bad["model"] = {**raw["model"], name: torch.zeros(
                (raw["model"][name].shape[0] + 1, *raw["model"][name].shape[1:]))}
            ckpt.save(ws, bad, step + 2)
            code_bad, body_bad = http_request(base, "/admin/swap",
                                              json.dumps({"wait": True}).encode())
            refused = json.loads(body_bad)
            still_code, _ = http_request(base, "/render", json.dumps(
                {"mpi_key": new_key, "offsets": [[0.0, 0.01, 0.0]]}).encode())
            if code_bad != 422 or refused["state"] != "failed" \
                    or refused["reason"] != "rejected" or app.engine.generation != 1 \
                    or still_code != 200:
                raise AssertionError(f"mismatched swap: {code_bad} {refused}, "
                                     f"render {still_code}")
        app.close()
        swap = {"swap_s": swap_s, "status": swapped, "memory_before_bytes": mem_before,
                "memory_after_bytes": mem_after, "old_key_render": old_code,
                "new_key": new_key, "mismatched": {"code": code_bad, "reason":
                                                   refused["reason"],
                                                   "error": refused["error"][:200]}}
        emit(info, phase="serve_http",
             config="default.yaml (llff, resnet50, 384x512, S=32, bf16)",
             workspace_step=step, app_build_s=build_s,
             warmup={"first_dispatches": warm, "seconds": warm_s},
             predict_ms=fp32["predict_ms"], predict_spans_ms=fp32["predict_spans_ms"],
             png_bytes=fp32["png_bytes"], render=fp32["render"],
             concurrent=fp32["concurrent"], healthz=fp32["healthz"],
             metric_families=fp32["metric_families"], trace_events=fp32["trace_events"],
             wire_bytes=fp32["wire_bytes"], swap=swap)
        del app
        torch.cuda.empty_cache()

        # the compressed tier: int8 with pruning, the same image and offsets
        cfg8 = cfg.replace(**{"serving.cache_tier": "int8",
                              "serving.prune_transmittance_eps": 1e-3})
        app8 = ServingApp(cfg8, state, checkpoint_step=step)
        warm8 = app8.engine.warmup()
        int8 = drive(app8, "int8")
        plane_buckets = app8.engine.bucket().plane_buckets
        app8.close()
        del app8

        # the pruned plane buckets, each reached by a real predict: the
        # threshold sits between two of the served MPI's plane contributions,
        # where the keep set (the last plane always kept) just fits the bucket
        fe = fp32["entry"]
        contrib = mpi_render.plane_contributions(
            fe.mpi_sigma, fe.disparity, inverse_3x3(fe.k)).cpu().numpy()
        levels = np.unique(contrib)
        eps_by_count: dict[int, float] = {}
        for eps in [(a + b) / 2 for a, b in zip(levels[:-1], levels[1:])] \
                + [(levels[-1] + 1.0) / 2]:
            keep = keep_mask(contrib, eps)
            keep[-1] = True
            eps_by_count.setdefault(int(keep.sum()), float(eps))
        offsets8 = [[0.02 * math.sin(i / 5.0), 0.01 * math.cos(i / 7.0), 0.05 * i / 8]
                    for i in range(8)]
        pruned = {}
        for lower, b in zip((0,) + plane_buckets, plane_buckets[:-1]):
            counts = sorted(c for c in eps_by_count if lower < c <= b)
            if not counts:
                raise AssertionError(f"no threshold keeps {lower + 1}..{b} planes: "
                                     f"contributions {contrib.tolist()}")
            eps = eps_by_count[counts[0]]  # the fewest planes: the most padding
            appb = ServingApp(cfg8.replace(**{"serving.prune_transmittance_eps": eps}), state,
                              checkpoint_step=step)
            with http_server(appb) as base:
                t = time.perf_counter()
                code, body = http_request(base, "/predict", png, {"Content-Type": "image/png"})
                predict_ms = (time.perf_counter() - t) * 1e3
                pred = json.loads(body)
                entry = appb.cache.get(key_from_str(pred["mpi_key"]), record=False)
                got_bucket = appb.engine.bucket(entry.bucket).plane_bucket(pred["planes_kept"])
                if code != 200 or got_bucket != b:
                    raise AssertionError(f"pruned predict at eps {eps}: {code} {pred}, "
                                         f"plane bucket {got_bucket}, want {b}")
                t = time.perf_counter()
                with recorded():
                    code, body = http_request(base, "/render", json.dumps(
                        {"mpi_key": pred["mpi_key"], "offsets": offsets8}).encode(),
                        {"Content-Type": "application/json"})
                wall = (time.perf_counter() - t) * 1e3
                if code != 200 or b not in k5_inputs:
                    raise AssertionError(f"pruned /render at S={b}: {code} {body[:300]!r}")
                frames = check_frames(appb, entry, body, offsets8, f"pruned S={b} /render")
            appb.close()
            del appb, entry
            pruned[b] = {"prune_eps": eps, "planes_kept": pred["planes_kept"],
                         "mpi_bytes": pred["mpi_bytes"], "predict_ms": predict_ms,
                         "render_8_wall_ms": wall,
                         "psnr_vs_fp32_db": psnr_db(frames, fp32["frames"][8])}
        torch.cuda.synchronize()
        launches = {"kernels": {k: v - excluded[k] for k, v in kw.launches.items()},
                    "sizes": tallies.read()}
    finally:
        mpi_render.warp_composite = real_composite
        tallies.close()

    kept = int8["predict"]["planes_kept"]
    psnr = {n: psnr_db(int8["frames"][n], fp32["frames"][n]) for n in SERVE_RENDERS}
    emit(info, phase="serve_http_int8", tier="int8", prune_eps=1e-3,
         warmup_first_dispatches=warm8,
         mpi_bytes={"int8": int8["predict"]["mpi_bytes"], "fp32": fp32["predict"]["mpi_bytes"],
                    "ratio": int8["predict"]["mpi_bytes"] / fp32["predict"]["mpi_bytes"]},
         planes_kept=kept, planes=int8["predict"]["planes"],
         plane_bucket=int8["plane_bucket"], predict_ms=int8["predict_ms"],
         predict_spans_ms=int8["predict_spans_ms"], render=int8["render"],
         concurrent=int8["concurrent"], psnr_int8_vs_fp32_db=psnr,
         wire_bytes=int8["wire_bytes"])
    emit(info, phase="serve_http_pruned", tier="int8",
         plane_contributions=contrib.tolist(), by_plane_bucket=pruned,
         phase_launches=launches, k5_launches_by_planes=k5_by_planes,
         check_render_launches_excluded={k: v for k, v in excluded.items() if v})

    # K5 against its plain version at every plane count the phase launched
    errs = {}
    for s_planes, ops in sorted(k5_inputs.items()):
        errs[s_planes] = check_close(f"warp_composite serve_http S={s_planes}",
                                     kw.warp_composite(*ops),
                                     kw.warp_composite_matrix_plain(*ops), **TOL)
    emit(info, phase="kernel_check", kernel="warp_composite", case="serve_http",
         tolerance=TOL, max_abs_err_by_planes=errs, launches_by_planes=k5_by_planes)
    if not launches["kernels"]["warp_composite"]:
        raise AssertionError("serve_http launched no warp_composite")
    return {"launches": {"serve_http": launches}, "k5_inputs": k5_inputs,
            "k5_errs": errs, "k5_by_planes": k5_by_planes}


# the fleet phase: images shown to the router, client threads of the flood
FLEET_IMAGES, FLOOD_CLIENTS, FLOOD_ROUNDS = 6, 24, 3


def serve_fleet_phase(info, dev, ws: str, image: np.ndarray) -> dict:
    """The serving fleet over the data_llff workspace at full width:
    in-process replicas (ServingApp behind make_server, peers configured)
    behind a FleetApp router on the loopback. Affinity: /predict of
    FLEET_IMAGES images lands on the ring owner that the router and the
    replicas agree on, and a routed /render is byte-identical to the owner's
    direct answer (router overhead: routed minus direct, alternated). Peer
    fetch, at fp32 and at cache_tier int8: a replica joins, a /render of a
    key whose arc moved answers 404, the client's /predict makes the new
    owner adopt the old owner's entry over /mpi/<key>, and the next /render
    is served by the new owner through K5 with the old owner's frames.
    Swap fan-out through the router. The brownout ladder on the replica that
    runs it: a flood of concurrent /render clients, then a walk L0 -> L3 ->
    L0 with pressure samples (at L1 an int8, pruned /predict and its
    announced /render; at L3 the widened window). Autoscale over
    SubprocessPool replicas of the serving CLI: a join with pre-warm and a
    drain with handoff under client traffic, no 5xx. K5 is held against its
    plain version on the adopted entries and the L1 entry (a served MPI, a
    moved pose). The counts are the in-process replicas' own launches:
    warm-ups and traffic, not the check calls."""
    import contextlib
    import io
    import urllib.error
    import urllib.request

    from PIL import Image

    from mine_tpu_torch.obs.slo import _exposition_children, burn_rates_from_exposition
    from mine_tpu_torch.ops import mpi_render
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.serving.autoscale import AutoscaleController, SubprocessPool
    from mine_tpu_torch.serving.cache import MPIEntry, key_from_str
    from mine_tpu_torch.serving.degrade import PressureSample
    from mine_tpu_torch.serving.fleet import FleetApp, HashRing, make_fleet_server
    from mine_tpu_torch.serving.server import ServingApp, make_server
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.step import build_model

    t_phase = time.perf_counter()

    def http(base: str, path: str, data=None, headers=None, timeout=300):
        req = urllib.request.Request(base + path, data=data, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as err:
            return err.code, dict(err.headers), err.read()

    def png_of(img: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return buf.getvalue()

    def digest(data: bytes) -> str:
        import hashlib

        return hashlib.sha256(data).hexdigest()

    def render_body(key: str, n: int, shift: float = 0.0) -> bytes:
        return json.dumps({"mpi_key": key, "offsets": [
            [0.03 + shift, 0.02 * math.sin(i), 0.04 * i / n] for i in range(n)]}).encode()

    JSON = {"Content-Type": "application/json"}
    PNG = {"Content-Type": "image/png"}

    # K5's launches by plane count, and the inputs of the last launch inside
    # a recorded block; the check calls are left out of every count
    k5 = {"by_planes": {}, "counting": True, "recording": None}
    excluded = dict.fromkeys(kw.launches, 0)
    real_composite = mpi_render.warp_composite

    def tally(*ops):
        before = kw.launches["warp_composite"]
        out = real_composite(*ops)
        if kw.launches["warp_composite"] > before:
            if k5["counting"]:
                k5["by_planes"][ops[0].shape[1]] = k5["by_planes"].get(ops[0].shape[1], 0) + 1
            if k5["recording"] is not None:
                k5["recording"]["ops"] = ops
        return out

    @contextlib.contextmanager
    def uncounted():
        before = dict(kw.launches)
        k5["counting"] = False
        try:
            yield
        finally:
            k5["counting"] = True
            for name in excluded:
                excluded[name] += kw.launches[name] - before[name]

    @contextlib.contextmanager
    def recorded(into: dict, name: str):
        k5["recording"] = seen = {}
        try:
            yield
        finally:
            k5["recording"] = None
        if "ops" not in seen:
            raise AssertionError(f"{name}: no K5 launch to hold")
        into[name] = tuple(t.clone() for t in seen["ops"])

    held: dict[str, tuple] = {}
    servers: list = []

    def serve(app, make=make_server) -> str:
        srv = make(app, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return "http://%s:%d" % srv.server_address[:2]

    # the newest step whose tree fits the model (serve_http left a
    # shape-mismatched one on top), and a perturbed copy as the swap target
    expected = build_model(ckpt.load_paired_config(ws)).state_dict()
    for step in reversed(ckpt.all_steps(ws)):
        try:
            cfg, state, step = ckpt.load_for_serving(ws, step=step, expected_state=expected)
            break
        except ckpt.CheckpointTreeMismatch:
            continue
    else:
        raise AssertionError(f"no servable step under {ws}")
    gen = torch.Generator().manual_seed(11)
    swap_step = max(ckpt.all_steps(ws)) + 1
    ckpt.save(ws, {"model": {k: (v + 1e-3 * torch.randn(v.shape, generator=gen)
                                 if v.dim() == 4 else v) for k, v in state.items()}},
              swap_step)

    # candidate images; the shown ones are chosen so that arcs do move
    rng = np.random.default_rng(17)
    pngs = [png_of(np.clip(image.astype(np.int16) + rng.integers(-12, 13, image.shape),
                           0, 255).astype(np.uint8)) for _ in range(24)]
    ring3 = HashRing(["r0", "r1", "r2"])
    moving = [p for p in pngs if ring3.candidates(digest(p))[0] == "r2"]
    if not moving:
        raise AssertionError("no candidate image lands on the third replica")
    shown = [moving[0]] + [p for p in pngs if p is not moving[0]][:FLEET_IMAGES - 1]
    int8_png, fresh = [p for p in pngs if p not in shown][-2:]

    def replica(cfg_r, name: str) -> tuple[ServingApp, str]:
        app = ServingApp(cfg_r, state, checkpoint_step=step, swap_source=ws, device=dev)
        if app.engine.device.type != dev.type:
            raise AssertionError(f"replica {name} on {app.engine.device}")
        app.engine.warmup(pose_counts=(1, 8))
        return app, serve(app)

    def adopt_after_move(apps: dict, urls: dict, router: FleetApp, data: bytes,
                         label: str) -> dict:
        """A key's arc moves away from its owner, which stays up: the owner
        drains (POST /admin/drain; /mpi/<key> stays served) and two probes
        take it out of the router's ring. A routed /render then answers 404
        from the next candidate, the client's /predict makes that new owner
        adopt the entry over /mpi/<key>, and its /render (K5) gives the old
        owner's frames."""
        base = router_base[label]
        code, hdrs, body = http(base, "/predict", data, PNG)
        old_owner = hdrs.get("X-Mine-Replica")
        key = json.loads(body)["mpi_key"]
        code_o, _, old_frames = http(urls[old_owner], "/render", render_body(key, 8), JSON)
        if code != 200 or code_o != 200:
            raise AssertionError(f"{label}: /predict {code}, owner's /render {code_o}")
        http(urls[old_owner], "/admin/drain", json.dumps({"draining": True}).encode(), JSON)
        for _ in range(2):
            router.probe_once()
        new_owner = router.candidates_for(digest(data))[0].name
        code_404, hdrs_404, _ = http(base, "/render", render_body(key, 1), JSON)
        hits0 = apps[new_owner].metrics.peer_fetch.value(outcome="hit")
        t = time.perf_counter()
        code, hdrs, body = http(base, "/predict", data, PNG)
        fetch_ms = (time.perf_counter() - t) * 1e3
        got = json.loads(body)
        hits = apps[new_owner].metrics.peer_fetch.value(outcome="hit") - hits0
        entry = apps[new_owner].cache.get(key_from_str(key), record=False)
        fields = ([entry.mpi_rgb, entry.mpi_sigma] if isinstance(entry, MPIEntry)
                  else [entry.rgb, entry.sigma])
        if old_owner in router.ring_members() or code_404 != 404 \
                or hdrs_404.get("X-Mine-Replica") != new_owner or code != 200 \
                or hdrs.get("X-Mine-Replica") != new_owner or not got["cached"] or hits != 1 \
                or got["mpi_key"] != key or any(t.device.type != dev.type for t in fields):
            raise AssertionError(f"{label} peer fetch: ring {router.ring_members()}, render "
                                 f"{code_404}, predict {code} at {hdrs.get('X-Mine-Replica')}, "
                                 f"{got}, hits {hits}, on {[t.device.type for t in fields]}")
        with recorded(held, f"adopted_{label}"):
            code, hdrs, routed = http(base, "/render", render_body(key, 8), JSON)
        if code != 200 or hdrs.get("X-Mine-Replica") != new_owner \
                or json.loads(routed)["frames_png_b64"] != json.loads(old_frames)[
                    "frames_png_b64"]:
            raise AssertionError(f"{label}: the adopted entry's frames differ from the old "
                                 f"owner's ({code} at {hdrs.get('X-Mine-Replica')})")
        http(urls[old_owner], "/admin/drain", json.dumps({"draining": False}).encode(), JSON)
        for _ in range(2):
            router.probe_once()
        if old_owner not in router.ring_members():
            raise AssertionError(f"{label}: {old_owner} did not rejoin the ring")
        return {"peer_fetches": hits, "predict_with_peer_fetch_ms": fetch_ms,
                "old_owner": old_owner, "new_owner": new_owner, "render_before_adopt": code_404,
                "entry": type(entry).__name__, "mpi_bytes": entry.nbytes,
                "frames_equal_old_owner": True}

    torch.cuda.synchronize()
    kw.reset_launches()
    mpi_render.warp_composite = tally
    tallies = SizeTally(kw)
    router_base: dict[str, str] = {}
    apps: dict[str, ServingApp] = {}
    routers: list[FleetApp] = []
    try:
        # 1. two replicas behind the router; the third runs the ladder
        t = time.perf_counter()
        urls = {}
        for name in ("r0", "r1"):
            apps[name], urls[name] = replica(cfg, name)
        for name, app in apps.items():
            app.configure_peers(urls, name)
        router = FleetApp(urls, probe_interval_s=3600)
        routers.append(router)
        router_base["fp32"] = serve(router, make_fleet_server)
        build_s = time.perf_counter() - t

        # 2. affinity: owner = the router's ring = every replica's ring
        affinity, keys, predict_ms = [], {}, []
        for data in shown[1:]:
            t = time.perf_counter()
            code, hdrs, body = http(router_base["fp32"], "/predict", data, PNG)
            predict_ms.append((time.perf_counter() - t) * 1e3)
            owner = router.candidates_for(digest(data))[0].name
            peer_owners = {app._peer_ring.candidates(digest(data))[0] for app in apps.values()}
            key = json.loads(body)["mpi_key"]
            holders = [n for n, a in apps.items() if a.cache.get(key_from_str(key),
                                                                  record=False) is not None]
            if code != 200 or hdrs.get("X-Mine-Replica") != owner or peer_owners != {owner} \
                    or holders != [owner]:
                raise AssertionError(f"affinity: {code} at {hdrs.get('X-Mine-Replica')}, "
                                     f"ring owner {owner}, peers {peer_owners}, held by "
                                     f"{holders}")
            keys[key] = owner
            code, _, routed = http(router_base["fp32"], "/render", render_body(key, 1), JSON)
            code_d, _, direct = http(urls[owner], "/render", render_body(key, 1), JSON)
            if code != 200 or code_d != 200 or routed != direct:
                raise AssertionError(f"routed /render of {key[:12]} is not the owner's bytes")
            affinity.append(owner)
        # router overhead: the same request routed and direct, alternated
        key, owner = next(iter(keys.items()))
        overhead = {}
        for label, path, data, headers, reps in (
                ("predict_hit", "/predict", shown[1], PNG, 7),
                ("render_8", "/render", render_body(key, 8), JSON, 3)):
            times = {"routed": [], "direct": []}
            for _ in range(reps):
                for side, base in (("routed", router_base["fp32"]), ("direct", urls[owner])):
                    t = time.perf_counter()
                    code, _, _ = http(base, path, data, headers)
                    times[side].append((time.perf_counter() - t) * 1e3)
                    if code != 200:
                        raise AssertionError(f"overhead {label} {side}: {code}")
            med = {k: statistics.median(v) for k, v in times.items()}
            overhead[label] = {**med, "router_minus_direct_ms": med["routed"] - med["direct"],
                               "runs_ms": times}

        # 3. a third replica (it runs the ladder) joins the ring; a key of
        # the arc it took moves on when it drains, and is adopted at fp32
        cfg_l = cfg.replace(**{"serving.degrade_enabled": True,
                               "resilience.serve_max_queue_requests": 8})
        apps["r2"], urls["r2"] = replica(cfg_l, "r2")
        for name, app in apps.items():
            app.configure_peers(urls, name)
        router.add_replica("r2", urls["r2"])
        peer = {"fp32": adopt_after_move(apps, urls, router, shown[0], "fp32")}
        if peer["fp32"]["old_owner"] != "r2":
            raise AssertionError(f"the moved key was not on the joiner: {peer['fp32']}")

        # ... and at cache_tier int8, in a ring of two int8 replicas
        cfg8 = cfg.replace(**{"serving.cache_tier": "int8"})
        apps8, urls8 = {}, {}
        for name in ("r0", "r1"):
            apps8[name], urls8[name] = replica(cfg8, f"{name} int8")
        for name, app in apps8.items():
            app.configure_peers(urls8, name)
        router8 = FleetApp(urls8, probe_interval_s=3600)
        routers.append(router8)
        router_base["int8"] = serve(router8, make_fleet_server)
        peer["int8"] = adopt_after_move(apps8, urls8, router8, int8_png, "int8")
        for app in apps8.values():
            app.close()
        del apps8
        torch.cuda.empty_cache()

        # 4. swap fan-out through the router
        t = time.perf_counter()
        code, _, body = http(router_base["fp32"], "/admin/swap", json.dumps(
            {"wait": True}).encode(), JSON)
        swap_s = time.perf_counter() - t
        swapped = json.loads(body)["replicas"]
        if code != 200 or set(swapped) != set(apps) or any(
                r.get("state") != "ok" or r.get("checkpoint_step") != swap_step
                for r in swapped.values()) or {a.engine.checkpoint_step
                                               for a in apps.values()} != {swap_step}:
            raise AssertionError(f"swap fan-out: {code} {swapped}")

        # 5. brownout on r2: a flood of concurrent renders, then the walk
        ladder_app, ladder_url = apps["r2"], urls["r2"]
        flood_keys = []
        for data in (shown[0], shown[1]):
            code, _, body = http(ladder_url, "/predict", data, PNG)
            flood_keys.append(json.loads(body)["mpi_key"])
        barrier = threading.Barrier(FLOOD_CLIENTS)
        flood_codes, flood_errors = [], []

        def flood_client(i):
            try:
                for r in range(FLOOD_ROUNDS):
                    barrier.wait(timeout=300)
                    code, hdrs, _ = http(ladder_url, "/render", render_body(
                        flood_keys[i % 2], 1, 0.001 * (i + r)), JSON)
                    flood_codes.append((code, hdrs.get("X-Degraded")))
            except Exception as exc:  # noqa: BLE001 - reported below, the others freed
                flood_errors.append(f"{type(exc).__name__}: {exc}")
                barrier.abort()

        t = time.perf_counter()
        workers = [threading.Thread(target=flood_client, args=(i,))
                   for i in range(FLOOD_CLIENTS)]
        for wkr in workers:
            wkr.start()
        for wkr in workers:
            wkr.join(timeout=600)
        flood_s = time.perf_counter() - t
        if flood_errors or any(wkr.is_alive() for wkr in workers) \
                or {c for c, _ in flood_codes} - {200, 503}:
            raise AssertionError(f"flood: {flood_errors}, codes {sorted(set(flood_codes))}")
        flood_levels = sorted({lvl for _, lvl in ladder_app.degrade.transitions()})
        flood = {"clients": FLOOD_CLIENTS, "rounds": FLOOD_ROUNDS, "seconds": flood_s,
                 "codes": {str(c): [x for x, _ in flood_codes].count(c) for c in (200, 503)},
                 "announced_200s": sum(1 for c, h in flood_codes if c == 200 and h),
                 "levels_reached": flood_levels, "queue_bound": 8,
                 "queue_high": cfg_l.serving.degrade_queue_high}
        ctl = ladder_app.degrade
        normal_delay = ladder_app._normal_delay_s
        ctl.relax_after, ctl.dwell_s = 1, 0.0
        while ctl.level > 0:
            ctl.tick(PressureSample())
        ctl.relax_after = 10 ** 6  # the walk up: no request relaxes it
        walk_from = len(ctl.transitions())
        breach = PressureSample(queue_frac=1.0)
        walk = {}
        for level in (1, 2, 3):
            while ctl.level < level:
                ctl.tick(breach)
            if level == 1:
                code, hdrs, body = http(ladder_url, "/predict", fresh, PNG)
                pred = json.loads(body)
                with recorded(held, "l1_degraded"):
                    code_r, hdrs_r, _ = http(ladder_url, "/render",
                                             render_body(pred["mpi_key"], 8), JSON)
                entry = ladder_app.cache.get(key_from_str(pred["mpi_key"]), record=False)
                want = "level=1;tier=int8"
                if code != 200 or code_r != 200 or pred["tier"] != "int8" \
                        or hdrs.get("X-Degraded") != want or hdrs_r.get("X-Degraded") != want \
                        or entry.rgb.device.type != dev.type:
                    raise AssertionError(f"L1: predict {code} {pred} {hdrs.get('X-Degraded')}, "
                                         f"render {code_r} {hdrs_r.get('X-Degraded')}")
                walk["l1"] = {"predict": pred, "x_degraded": want,
                              "plane_bucket": ladder_app.engine.bucket(entry.bucket)
                              .plane_bucket(entry.planes_kept)}
            if level == 3 and ladder_app.batcher.max_delay_s != \
                    cfg_l.serving.degrade_coalesce_delay_ms / 1e3:
                raise AssertionError(f"L3 window {ladder_app.batcher.max_delay_s}")
        walk["l3_window_ms"] = ladder_app.batcher.max_delay_s * 1e3
        ctl.relax_after = 1
        while ctl.level > 0:
            ctl.tick(PressureSample())
        steps = [lvl for _, lvl in ctl.transitions()[walk_from - 1:]]
        walk.update(levels=steps, l0_window_ms=ladder_app.batcher.max_delay_s * 1e3)
        code, _, replica_page = http(ladder_url, "/metrics")
        code_f, _, router_page = http(router_base["fp32"], "/metrics")
        slo = {"replica": burn_rates_from_exposition(replica_page.decode()),
               "router": burn_rates_from_exposition(router_page.decode())}
        if steps != [0, 1, 2, 3, 2, 1, 0] or ladder_app.batcher.max_delay_s != normal_delay \
                or code != 200 or code_f != 200 \
                or any(set(v) != {"availability", "latency_p95"} for v in slo.values()):
            raise AssertionError(f"walk {steps}, window {ladder_app.batcher.max_delay_s}, "
                                 f"slo {slo}")
        requests = {name: int(sum(v for labels, v in
                                  app.metrics.requests.labeled_values().items()
                                  if dict(labels).get("endpoint") in ("predict", "render")))
                    for name, app in apps.items()}
        routed = {dict(k)["replica"]: int(v)
                  for k, v in router.metrics.routed.labeled_values().items()}
        torch.cuda.synchronize()
        launches = {"kernels": {k: v - excluded[k] for k, v in kw.launches.items()},
                    "sizes": tallies.read()}
    finally:
        mpi_render.warp_composite = real_composite
        tallies.close()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for r in routers:
            r.close()
        for app in apps.values():
            app.close()
    del apps
    torch.cuda.empty_cache()

    # K5 on the adopted and degraded entries' inputs, against its plain version;
    # each input named by its sums, and where its largest disagreement lies
    errs, held_at = {}, {}
    with uncounted():
        for name, ops in held.items():
            eye = torch.eye(3, device=ops[2].device)
            if ops[1].abs().max().item() == 0.0 or (ops[2] - eye).abs().max().item() < 1e-4:
                raise AssertionError(f"K5's {name} inputs are an empty MPI or an identity pose")
            got, want = kw.warp_composite(*ops), kw.warp_composite_matrix_plain(*ops)
            errs[name] = check_close(f"warp_composite {name}", got, want, **TOL)
            at = np.unravel_index(int((got - want).abs().argmax()), tuple(got.shape))
            held_at[name] = {"mpi_rgb_sum": float(ops[0].double().sum()),
                             "mpi_sigma_sum": float(ops[1].double().sum()),
                             "max_err_at_nchw": [int(v) for v in at],
                             "value_there": float(want[tuple(int(v) for v in at)])}
    if not max(errs.values()) > 0.0:
        raise AssertionError(f"K5 equals its plain version bit for bit on every held input "
                             f"({errs}): the check cannot tell them apart")
    if not launches["kernels"]["warp_composite"]:
        raise AssertionError("serve_fleet launched no warp_composite")

    # 6. autoscale over replica processes of the serving CLI, under traffic
    t = time.perf_counter()
    pool = SubprocessPool(ws, server_args=["--no-warmup", "--device", dev.type],
                          spawn_timeout_s=600.0, request_timeout_s=120.0)
    fleet_srv = fleet = ctl = None
    try:
        s0, s0_url = pool.spawn()
        spawn_s = time.perf_counter() - t
        pool.configure_peers(pool.urls())
        fleet = FleetApp(pool.urls(), probe_interval_s=3600, deadline_s=300.0)
        base = serve(fleet, make_fleet_server)
        fleet_srv = servers[-1]
        ctl = AutoscaleController(fleet, pool, scrape=f"{base}/metrics", min_replicas=1,
                                  max_replicas=2, up_after=10 ** 6, down_after=10 ** 6,
                                  cooldown_s=0.0, join_timeout_s=300.0, drain_timeout_s=300.0)
        ring_as = HashRing(["s0", "s1"])
        as_pngs = [p for p in pngs if ring_as.candidates(digest(p))[0] == "s1"][:2] \
            + [p for p in pngs if ring_as.candidates(digest(p))[0] == "s0"][:2]
        as_keys = {}
        for i, data in enumerate(as_pngs):
            code, _, body = http(base, "/predict", data, PNG)
            if code != 200:
                raise AssertionError(f"autoscale /predict {code}: {body[:200]!r}")
            as_keys[i] = json.loads(body)["mpi_key"]
        code, _, body = http(s0_url, "/healthz")
        if code != 200 or json.loads(body)["backend"] != dev.type:
            raise AssertionError(f"replica process s0: {code} {body[:200]!r}")

        def traffic(stop: threading.Event, codes: list):
            while not stop.is_set():
                for i, key in as_keys.items():
                    code, _, _ = http(base, "/render", render_body(key, 1), JSON)
                    codes.append(code)
                    if code == 404:  # the client contract: predict again
                        code, _, body = http(base, "/predict", as_pngs[i], PNG)
                        codes.append(code)

        def scale_under_traffic(n: int) -> tuple[float, list]:
            stop, codes = threading.Event(), []
            client = threading.Thread(target=traffic, args=(stop, codes))
            client.start()
            t0 = time.perf_counter()
            try:
                got = ctl.scale_to(n)
            finally:
                seconds = time.perf_counter() - t0
                stop.set()
                client.join(timeout=300)
            if got != n or client.is_alive() or not codes or any(c >= 500 for c in codes):
                raise AssertionError(f"scale_to({n}) -> {got}, client codes {codes}")
            return seconds, codes

        def metric(url: str, family: str, **labels) -> float:
            _, _, page = http(url, "/metrics")
            want = {k: str(v) for k, v in labels.items()}
            return sum(v for lab, v in _exposition_children(page.decode(), family)
                       if all(lab.get(k) == x for k, x in want.items()))

        join_s, join_codes = scale_under_traffic(2)
        s1_url = pool.urls()["s1"]
        prewarmed = metric(s1_url, "mine_serve_prewarm_keys_total", outcome="fetched")
        if prewarmed < 1 or fleet.ring_members() != ["s0", "s1"]:
            raise AssertionError(f"join: prewarmed {prewarmed}, ring {fleet.ring_members()}")
        s0_before = {o: metric(s0_url, "mine_serve_prewarm_keys_total", outcome=o)
                     for o in ("fetched", "resident")}
        drain_s, drain_codes = scale_under_traffic(1)
        handed = {o: metric(s0_url, "mine_serve_prewarm_keys_total", outcome=o) - s0_before[o]
                  for o in ("fetched", "resident")}
        events = {f"{d}_{o}": fleet.metrics.autoscale_events.value(direction=d, outcome=o)
                  for d in ("join", "drain") for o in ("ok", "aborted", "handoff_aborted")}
        if fleet.ring_members() != ["s0"] or pool.names() != ["s0"] \
                or events["join_ok"] != 1 or events["drain_ok"] != 1 or sum(handed.values()) < 1:
            raise AssertionError(f"drain: ring {fleet.ring_members()}, pool {pool.names()}, "
                                 f"events {events}, handed off {handed}")
        autoscale = {
            "replica_command": "python -m mine_tpu_torch.serving --workspace <ws> --port 0 "
                               f"--no-warmup --device {dev.type}",
            "first_spawn_s": spawn_s, "join_s": join_s, "prewarmed_keys": prewarmed,
            "drain_s": drain_s, "handed_off_keys": handed, "events": events,
            "client_codes": {"join": {str(c): join_codes.count(c) for c in set(join_codes)},
                             "drain": {str(c): drain_codes.count(c)
                                       for c in set(drain_codes)}},
        }
    finally:
        if ctl is not None:
            ctl.close()
        if fleet_srv is not None:
            fleet_srv.shutdown()
            fleet_srv.server_close()
        if fleet is not None:
            fleet.close()
        pool.close()

    emit(info, phase="serve_fleet",
         config="default.yaml (llff, resnet50, 384x512, S=32, bf16), data_llff workspace",
         workspace_step=step, swap_step=swap_step, replicas_build_s=build_s,
         requests_by_replica=requests, routed_by_replica=routed,
         affinity={"owners": affinity, "routed_render_bytes_equal_owner": True},
         predict_miss_through_router_ms=predict_ms, router_overhead_ms=overhead,
         peer_fetch=peer, swap_fanout={"seconds": swap_s, "replicas": len(swapped)},
         brownout={"flood": flood, "walk": walk, "slo_burn_rates": slo},
         autoscale=autoscale, k5_launches_by_planes=k5["by_planes"],
         k5_max_abs_err=errs, k5_held_inputs=held_at, tolerance=TOL, phase_launches=launches,
         check_launches_excluded={k: v for k, v in excluded.items() if v},
         phase_s=time.perf_counter() - t_phase)
    return {"launches": {"serve_fleet": launches}, "k5_errs": errs}


OBS_STEPS = 6  # the obs-enabled fits: a counted step, a 2-step profile window, timed steps
OBS_TIMING_FITS = ("off", "on", "on", "off", "off", "on")
OBS_TIMING_STEPS = 8  # steps a timing fit; its first interval is left out
DENSE_STEP_MS_PERF_MD = "399-427 ms (PERF.md section 5, earlier runs of this script)"
PREDICT_COST_TURNS = 12  # engine.predict with the cost gauges and without, in turns


def obs_resilience_phase(info, dev, train_cfg, train_state, llff_ws: str,
                         image: np.ndarray) -> dict:
    """Observability and resilience at full width (the default recipe,
    ResNet-50, 384x512, S=32, B=4, bf16 network):
      * Trainer.fit with obs on, dense then streaming, OBS_STEPS steps with a
        2-step torch.profiler window from step 2: the counted FLOPs of a
        step, MFU, the component table (coverage >= 0.9), K1 and K2 inside
        homography_warp and K5 inside composite, the host spans; the kernels
        still launch on the counted step; a SIGUSR1 from a timer thread
        during the dense fit leaves a flight dump with torch.cuda's memory
        statistics, and the run goes on;
      * the dense step with obs off and on, timed in turns in this call
        (intervals between step starts, log every step, batches made
        beforehand, both trainers with a workspace): obs on within 3 %;
      * `MINE_TPU_FAULTS=sigterm@step=3` on the train CLI: the process dies
        by SIGTERM after saving step 3 (sha256-checked) and a flight dump; a
        new Trainer restores it bit-equal and trains on to step 5;
      * `nan_loss@step=2,loader_raise@batch=2` on the data_llff workspace's
        recipe (its LLFF fixture) under the skip policy with one loader
        retry: step 2's update is dropped bitwise, step 3 is finite, the
        retry is counted once and the batches equal a clean run's;
      * the serving CLI with --peak-flops 989e12 and
        `predict_raise@predict=1,corrupt_ckpt@swap=1`: /metrics shows the
        predict's FLOPs and a finite MFU, the injected predict failure is a
        counted 5xx and the next predict succeeds, the corrupt swap is
        refused (reason corrupt) while the old weights serve, and SIGUSR1
        leaves a flight dump (the CLI started by autoscale's SubprocessPool);
      * engine.predict on that workspace with the cost gauges and without,
        in turns: what they add to a /predict miss (nothing waits for the
        predict's timing events), and the predict's MFU.
    Returns the launches of the two obs fits, read around each alone, with
    K1/K2's size classes counted (SizeTally)."""
    import glob
    import io
    import signal
    import tempfile

    from PIL import Image

    from mine_tpu_torch.data.conformance.runner import http_request
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.obs.attrib import attributed_items, load_trace_events
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.resilience import chaos
    from mine_tpu_torch.serving.autoscale import SubprocessPool
    from mine_tpu_torch.serving.engine import RenderEngine
    from mine_tpu_torch.serving.metrics import ServingMetrics
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.loop import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="obs_resilience_", dir=os.path.join(root, "build"))
    kernel_names = {"warp_bilinear_kernel": "K1", "warp_bilinear_grad_kernel": "K2",
                    "warp_composite_kernel": "K5"}
    out = {"launches": {}}
    t_phase = time.perf_counter()

    def flight_dumps(dump_dir: str) -> list[str]:
        return sorted(glob.glob(os.path.join(dump_dir, "*", "flight_*")))

    def obs_fit(compositor: str, poke: bool) -> dict:
        cfg = train_cfg.replace(**{
            "mpi.compositor": compositor, "obs.enabled": True, "obs.profile_start_offset": 2,
            "obs.profile_steps": 2, "training.log_interval": 2})
        ws = os.path.join(scratch, f"obs_{compositor}")
        trainer = Trainer(cfg, ws, state_dict=train_state)
        poker = None
        if poke:  # SIGUSR1 from another thread once step 3 is done
            def send():
                deadline = time.monotonic() + 300
                while trainer.global_step < 3 and time.monotonic() < deadline:
                    time.sleep(0.01)
                os.kill(os.getpid(), signal.SIGUSR1)

            poker = threading.Thread(target=send, daemon=True)
            poker.start()
        tally = SizeTally(kw)
        try:
            torch.cuda.synchronize()
            kw.reset_launches()
            t0 = time.perf_counter()
            logged = trainer.fit(build_dataset(cfg, "train", cfg.data.per_gpu_batch_size),
                                 max_steps=OBS_STEPS)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches, sizes = dict(kw.launches), tally.read()
        finally:
            tally.close()
        # 4x384x512 fp32 sources: every K1/K2 launch is of the resident class
        if any(sizes[name]["banded"] or sizes[name]["resident"] != launches[name]
               for name in sizes):
            raise AssertionError(f"obs {compositor}: size classes {sizes}, launches {launches}")
        if poker is not None:
            poker.join(timeout=60)
        table = trainer.attribution
        if table is None or not table["covered"] or table["basis"] != "device":
            raise AssertionError(f"obs {compositor}: attribution not covered: {table}")
        items, _ = attributed_items(load_trace_events(table["trace"]))
        kernels: dict[str, dict[str, int]] = {}
        for ev, comp in items:
            for prefix, label in kernel_names.items():
                if prefix in ev["name"]:
                    by = kernels.setdefault(label, {})
                    by[comp or "unattributed"] = by.get(comp or "unattributed", 0) + 1
        want = {"K1": "homography_warp", "K2": "homography_warp"}
        if compositor == "streaming":
            want["K5"] = "composite"
        for label, comp in want.items():
            if set(kernels.get(label, {})) != {comp}:
                raise AssertionError(f"obs {compositor}: {label} not (only) inside {comp}: "
                                     f"{kernels}")
        spans = json.load(open(os.path.join(ws, "profile", "host_spans.trace.json")))
        span_counts: dict[str, int] = {}
        for ev in spans["traceEvents"]:
            if ev.get("ph") == "X":
                span_counts[ev["name"]] = span_counts.get(ev["name"], 0) + 1
        if not {"data", "step", "sync", "log", "ckpt"} <= set(span_counts):
            raise AssertionError(f"obs {compositor}: spans {span_counts}")
        m = trainer.obs_metrics
        mfu = m.mfu.value()
        if not (trainer.train_cost and trainer.train_cost.flops) or not 0 < mfu < 1:
            raise AssertionError(f"obs {compositor}: flops {trainer.train_cost}, mfu {mfu}")
        per_step = 4 if compositor == "dense" else None
        if per_step is not None and (launches["warp_bilinear"] != per_step * OBS_STEPS
                                     or launches["warp_bilinear_grad"] != per_step * OBS_STEPS):
            raise AssertionError(f"obs dense: the counted step did not launch the kernels "
                                 f"{launches}")
        row = dict(
            compositor=compositor, steps=OBS_STEPS, fit_s=fit_s, loss=logged["loss"],
            step_flops=trainer.train_cost.flops,
            counted_step_peak_allocated_gb=(None if trainer.train_cost.peak_memory_bytes is None
                                            else trainer.train_cost.peak_memory_bytes / 1e9),
            peak_flops=trainer.peak_flops, mfu=mfu, tflops_per_s=m.tflops_per_sec.value(),
            attribution={r["component"]: {"ms": r["time_ms"], "pct": r["pct"],
                                          "calls": r["calls"]} for r in table["rows"]},
            coverage=table["coverage"], profiled_ms=table["total_ms"],
            kernels_by_component=kernels, host_spans=span_counts, launches=launches)
        if poke:
            dumps = flight_dumps(os.path.join(ws, "flight"))
            if len(dumps) != 1 or not dumps[0].endswith("signal_sigusr1"):
                raise AssertionError(f"obs dense: SIGUSR1 dumps {dumps}")
            meta = json.load(open(os.path.join(dumps[0], "meta.json")))
            memory = meta["device_memory"]
            if not isinstance(memory, list) or "allocated_bytes.all.current" not in \
                    memory[0]["memory_stats"]:
                raise AssertionError(f"obs dense: flight meta without memory stats: {memory}")
            row["flight_sigusr1"] = {
                "dump": os.path.relpath(dumps[0], ws), "last_step": meta["last_step"],
                "allocated_gb": memory[0]["memory_stats"]["allocated_bytes.all.current"] / 1e9,
                "steps_after_it": trainer.global_step - meta["last_step"]}
        out["launches"][f"obs_train_{compositor}"] = {
            "kernels": launches,
            "sizes": sizes}
        del trainer
        torch.cuda.empty_cache()
        return row

    for compositor in ("dense", "streaming"):
        emit(info, phase="obs_resilience", part=f"obs_train_{compositor}",
             **obs_fit(compositor, poke=compositor == "dense"))

    # the dense step with obs off and on, in turns: intervals between step
    # starts with a sync every step, the first interval of each fit left out;
    # the batches are made once, in memory, so that the synthetic scene's
    # numpy (~405 ms a batch) does not set the pace
    class Batches:
        def __init__(self, batches):
            self.batches = batches

        def __len__(self):
            return len(self.batches)

        def epoch(self, epoch):
            return iter(self.batches)

    made = list(itertools.islice(build_dataset(
        train_cfg, "train", train_cfg.data.per_gpu_batch_size).epoch(1), OBS_TIMING_STEPS))
    timing_trainers = {}
    intervals: dict[str, list[float]] = {"off": [], "on": []}
    for mode in OBS_TIMING_FITS:
        if mode not in timing_trainers:
            # both with a workspace (its logs and checkpoints): obs alone differs
            cfg = train_cfg.replace(**{"training.log_interval": 1,
                                       "obs.enabled": mode == "on"})
            ws = os.path.join(scratch, f"timing_{mode}")
            timing_trainers[mode] = (cfg, Trainer(cfg, ws, state_dict=train_state))
        cfg, trainer = timing_trainers[mode]
        starts: list[float] = []
        step = Trainer.step

        def timed_step(batch, trainer=trainer, starts=starts, step=step):
            starts.append(time.perf_counter())
            return step(trainer, batch)

        trainer.step = timed_step
        trainer.fit(Batches(made), max_steps=trainer.global_step + OBS_TIMING_STEPS)
        intervals[mode].extend(1e3 * (b - a) for a, b in zip(starts[1:], starts[2:]))
    median = {k: statistics.median(v) for k, v in intervals.items()}
    overhead = median["on"] / median["off"] - 1.0
    del timing_trainers
    torch.cuda.empty_cache()
    if overhead > 0.03:
        raise AssertionError(f"obs on costs {overhead:.1%} of the dense step: {median}")
    emit(info, phase="obs_resilience", part="obs_overhead", order=list(OBS_TIMING_FITS),
         step_ms_median=median, step_ms_runs=intervals, obs_on_over_off=overhead,
         dense_step_ms_earlier=DENSE_STEP_MS_PERF_MD)

    # a preempted CLI run: SIGTERM after step 3 saves it, dumps, terminates
    ws = os.path.join(scratch, "preempted")
    extra = {"data.name": "synthetic", "obs.enabled": True, "training.log_interval": 1}
    env = dict(os.environ, MINE_TPU_FAULTS="sigterm@step=3")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mine_tpu_torch.train", "--workspace", ws,
                           "--max_steps", "5", "--extra_config", json.dumps(extra)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    dumps = flight_dumps(os.path.join(ws, "flight"))
    if proc.returncode != -signal.SIGTERM or ckpt.all_steps(ws) != [3] \
            or not any(d.endswith("signal_sigterm") for d in dumps):
        raise AssertionError(f"sigterm@step=3: exit {proc.returncode}, steps "
                             f"{ckpt.all_steps(ws)}, dumps {dumps}\n{proc.stderr[-3000:]}")
    ckpt.verify_checkpoint_integrity(ws, 3)
    saved = ckpt.load(ws, 3)
    p_cfg = ckpt.load_paired_config(ws)
    resumed = Trainer(p_cfg, ws, state_dict=train_state)
    ds = build_dataset(p_cfg, "train", p_cfg.data.per_gpu_batch_size)
    resumed._start(len(ds))
    state = resumed.state()
    same = {
        "global_step": state["global_step"] == saved["global_step"] == 3,
        "model_and_bn_buffers": all(torch.equal(state["model"][n].cpu(), saved["model"][n])
                                    for n in saved["model"]),
        "optimizer": all(torch.equal(x[n].cpu(), y[n].cpu()) for x, y in zip(
            state["optimizer"]["state"].values(), saved["optimizer"]["state"].values())
            for n in x),
        "scheduler": state["scheduler"] == saved["scheduler"],
        "generators": all(torch.equal(state["generators"][n], saved["generators"][n])
                          for n in saved["generators"]),
    }
    if not all(same.values()):
        raise AssertionError(f"the preempted step does not restore bit-equal: {same}")
    logged = resumed.fit(ds, max_steps=5)
    if resumed.global_step != 5 or not math.isfinite(logged["loss"]):
        raise AssertionError(f"the resumed run: step {resumed.global_step}, {logged}")
    emit(info, phase="obs_resilience", part="preempt_sigterm",
         command="MINE_TPU_FAULTS=sigterm@step=3 python -m mine_tpu_torch.train --max_steps 5",
         exit_code=proc.returncode, cli_s=cli_s, checkpoints=[3], sha256_ok=True,
         flight_dumps=[os.path.relpath(d, ws) for d in dumps], restored_bit_equal=same,
         resumed_to=resumed.global_step, loss=logged["loss"])
    del resumed, saved, state
    torch.cuda.empty_cache()

    # the sentinel's skip and the loader's retry on the LLFF fixture's recipe
    l_cfg = ckpt.load_paired_config(llff_ws).replace(**{
        "resilience.sentinel_policy": "skip", "data.loader_retries": 1,
        "training.log_interval": 1})
    l_ds = build_dataset(l_cfg, "train", l_cfg.data.per_gpu_batch_size)
    # the first 3 batches of a clean run, across epochs (2 steps an epoch)
    clean = list(itertools.islice(itertools.chain.from_iterable(
        l_ds.epoch(e) for e in itertools.count(1)), 3))
    trainer = Trainer(l_cfg, state_dict=train_state)
    seen, params, losses = [], {}, {}
    step = Trainer.step

    def record(batch):
        seen.append({k: np.asarray(v).copy() for k, v in batch.items()})
        result = step(trainer, batch)
        params[trainer.global_step] = {k: v.detach().clone()
                                       for k, v in trainer.model.state_dict().items()}
        losses[trainer.global_step] = float(result["loss"])
        return result

    trainer.step = record
    chaos.install("nan_loss@step=2,loader_raise@batch=2")
    kw.reset_launches()
    try:
        trainer.fit(l_ds, max_steps=3)
    finally:
        pending = chaos.active().pending()
        chaos.uninstall()
    retries = trainer.obs_metrics.data_retries.value(process_index="0")
    kept = all(torch.equal(params[2][k], params[1][k]) for k in params[1])
    equal = [all(np.array_equal(s[k], c[k]) for k in c if not (i == 1 and k == "src_img"))
             for i, (s, c) in enumerate(zip(seen, clean))]
    poisoned = bool(np.isnan(seen[1]["src_img"]).all())
    if pending or retries != 1 or not kept or len(equal) != 3 or not all(equal) or not poisoned \
            or math.isfinite(losses[2]) or not math.isfinite(losses[3]) \
            or trainer.sentinel.skipped_updates != 1:
        raise AssertionError(f"nan_loss/loader_raise: pending {pending}, retries {retries}, "
                             f"params kept {kept}, batches equal {equal}, losses {losses}")
    emit(info, phase="obs_resilience", part="sentinel_and_loader",
         faults="nan_loss@step=2,loader_raise@batch=2", data="data_llff fixture",
         losses=losses, step2_params_equal_step1=kept, skipped_updates=1,
         data_retries_total=retries, batches_equal_clean_run=equal,
         launches=dict(kw.launches))
    del trainer, params
    torch.cuda.empty_cache()

    # the serving CLI: cost gauges, an injected predict failure, a corrupt
    # swap refused, a SIGUSR1 flight dump
    t0 = time.perf_counter()
    pool = SubprocessPool(
        llff_ws, server_args=["--device", dev.type, "--peak-flops", "989e12"],
        env=dict(os.environ, MINE_TPU_FAULTS="predict_raise@predict=1,corrupt_ckpt@swap=1"),
        spawn_timeout_s=300.0)
    replica, base = pool.spawn()
    pid = pool.pid(replica)
    try:
        bind_s = time.perf_counter() - t0
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        png = {"data": buf.getvalue(), "headers": {"Content-Type": "image/png"}}

        def metric(text: str, name: str) -> float | None:
            for ln in text.splitlines():
                if ln.startswith(name + " ") or ln.startswith(name + "{"):
                    return float(ln.rsplit(" ", 1)[1])
            return None

        code1, body1 = http_request(base, "/predict", timeout=300, **png)
        code2, body2 = http_request(base, "/predict", timeout=300, **png)
        deadline = time.monotonic() + 30
        while True:  # a scrape sets the rate gauges once the predict's events are done
            _, text = http_request(base, "/metrics")
            text = text.decode()
            if metric(text, "mine_serve_mfu") is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        flops = metric(text, 'mine_serve_step_flops{kind="predict"}')
        mfu = metric(text, "mine_serve_mfu")
        failures = metric(text, 'mine_serve_engine_failures_total{kind="predict"}')
        _, health0 = http_request(base, "/healthz")
        code_swap, body_swap = http_request(base, "/admin/swap", data=b'{"wait": true}',
                                            headers={"Content-Type": "application/json"},
                                            timeout=300)
        swap = json.loads(body_swap)
        code_hit, body_hit = http_request(base, "/predict", timeout=300, **png)
        _, health1 = http_request(base, "/healthz")
        health0, health1 = json.loads(health0), json.loads(health1)
        os.kill(pid, signal.SIGUSR1)
        deadline = time.monotonic() + 60
        while not [d for d in flight_dumps(os.path.join(llff_ws, "flight"))
                   if f"pid{pid}" in d and d.endswith("signal_sigusr1")]:
            if time.monotonic() > deadline:
                raise AssertionError("the serving CLI left no SIGUSR1 flight dump")
            time.sleep(0.1)
        dump = [d for d in flight_dumps(os.path.join(llff_ws, "flight"))
                if f"pid{pid}" in d][0]
        code_after, _ = http_request(base, "/healthz")
    finally:
        pool.retire(replica)
    meta = json.load(open(os.path.join(dump, "meta.json")))
    checks = {
        "predict_raise_5xx": code1 >= 500 and "predict_raise" in body1.decode(),
        "breaker_counted_it": failures == 1.0,
        "next_predict_ok": code2 == 200 and not json.loads(body2)["cached"],
        "step_flops": bool(flops and flops > 1e11),
        "mfu_finite": mfu is not None and 0 < mfu < 1,
        "swap_refused_corrupt": code_swap == 422 and swap.get("reason") == "corrupt",
        "old_weights_serve": (code_hit == 200 and json.loads(body_hit)["cached"]
                              and health1["weight_generation"] == health0["weight_generation"]
                              and health1["checkpoint_step"] == health0["checkpoint_step"]),
        "flight_dump_memory_stats": isinstance(meta["device_memory"], list),
        "alive_after_sigusr1": code_after == 200,
    }
    if not all(checks.values()):
        raise AssertionError(f"serving CLI faults: {checks}, swap {swap}, "
                             f"flops {flops}, mfu {mfu}")
    emit(info, phase="obs_resilience", part="serve_cli",
         command="MINE_TPU_FAULTS=predict_raise@predict=1,corrupt_ckpt@swap=1 python -m "
                 "mine_tpu_torch.serving --workspace <data_llff> --port 0 --peak-flops 989e12",
         bind_s=bind_s, checks=checks, predict_step_flops=flops, predict_mfu=mfu,
         predict_tflops_per_s=metric(text, "mine_serve_achieved_tflops_per_sec"),
         swap=swap, flight_dump=os.path.relpath(dump, llff_ws))

    # what the cost gauges add to a /predict miss: engine.predict on the
    # served workspace with metrics (two timing events, read later) and
    # without, in turns, the card idle before each call; each call's time
    # to return and, after a synchronize, to completion on the card
    s_cfg, s_state, s_step = ckpt.load_for_serving(llff_ws)
    metrics = ServingMetrics()
    engine = RenderEngine(s_cfg, s_state, checkpoint_step=s_step, metrics=metrics,
                          device=dev, peak_flops_override=989e12)
    for _ in range(2):  # the first predict is the counted one
        engine.predict(image)
    predict_ms: dict[str, dict[str, list[float]]] = {
        mode: {"return": [], "done": []} for mode in ("metrics", "no_metrics")}
    for i in range(2 * PREDICT_COST_TURNS):
        mode = ("metrics", "no_metrics")[i % 2]
        engine.metrics = metrics if mode == "metrics" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(image)
        t_return = time.perf_counter()
        torch.cuda.synchronize()
        predict_ms[mode]["return"].append(1e3 * (t_return - t0))
        predict_ms[mode]["done"].append(1e3 * (time.perf_counter() - t0))
    engine.metrics = metrics
    engine.publish_cost()
    median = {mode: {k: statistics.median(v) for k, v in runs.items()}
              for mode, runs in predict_ms.items()}
    engine_mfu = metrics.mfu.value()
    if not 0 < engine_mfu < 1:
        raise AssertionError(f"engine predict MFU {engine_mfu}")
    emit(info, phase="obs_resilience", part="predict_cost_gauges", tier=engine.cache_tier,
         prune_eps=engine.prune_eps, predict_ms_median=median, predict_ms_runs=predict_ms,
         return_metrics_over_no_metrics=(median["metrics"]["return"]
                                         / median["no_metrics"]["return"] - 1.0),
         predict_step_flops=engine.bucket().predict_cost.flops, predict_mfu=engine_mfu,
         predict_tflops_per_s=metrics.achieved_tflops.value(),
         phase_s=time.perf_counter() - t_phase)
    del engine, s_state
    torch.cuda.empty_cache()
    return out



# -- 10. the parallel path: ranks of one job sharing the card -------------------------

PARALLEL_STEPS = 2
# the watchdog window of the host_stall drill, seconds
STALL_WINDOW_S = 15.0


def train_rank_main(spec_path: str) -> int:
    """One rank of a torchrun job (`chip_smoke.py --train-rank SPEC`): SPEC
    is a JSON list of [OUT, train CLI args(, options)] segments, run one
    after the other in this process on one process group (the launch, the
    imports and the group's bring-up are paid once; the group is destroyed
    after the last segment). Each segment is the train CLI's main with TF32
    off, then what the rank saw into OUT.r<rank>.json: its kernel launches
    (K1/K2 by size class), the process group's backend, the mesh, each
    step's time, the host time of each step boundary's preemption-flag
    all-reduce, the segment's seconds, its peak memory, a digest of its
    parameters (replicas must hold the same ones) and what the chaos
    schedule left pending; rank 0 saves its first step's gradients (the
    mesh's, all-reduced) to OUT.grads.pt. Under a sharded state layout the
    gradients are saved full, before the sharded update slices them, and
    the rank records its parameter and moment bytes (resident, by the
    table, replicated).

    Options: "faults" {rank: MINE_TPU_FAULTS spec} installs a chaos schedule
    on that rank for the segment. "ends": "sigterm" takes the SIGTERM's
    disposition (termination) as SystemExit(143), the code a shell reports
    for a process that SIGTERM ended, where the preemption guard chains to
    it, and goes on with the next segment; each rank records that it ended
    so, the seconds of its preemption save, and rank 0 whether the saved
    step equals the state the ranks hold, bit for bit. "ends": "exception"
    (the last segment) records the error that ended the rank's run and
    whether its emergency shard file holds what the rank holds, then ends
    the process (exit 0), which also fails a peer blocked in a collective."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gc
    import signal

    import torch.distributed as dist

    from mine_tpu_torch import train
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.parallel import data_parallel as dp
    from mine_tpu_torch.parallel.mesh import mesh_shape_str
    from mine_tpu_torch.resilience import chaos
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as fh:
        segments = json.load(fh)
    seen: dict = {}
    out_prefix = ""
    step, fit = loop.Trainer.step, loop.Trainer.fit
    preempt_save, flag_all_reduce = loop.Trainer._preempt_save, loop.all_reduce_max_int
    sharded_step = dp.sharded_optimizer_step
    destroy = dist.destroy_process_group

    def saving_sharded_step(optimizer, scheduler, model, layout, mesh):
        if not seen["step_ms"] and dist.get_rank() == 0:  # the first step's full gradients
            save_grads(model, f"{out_prefix}.grads.pt")
        return sharded_step(optimizer, scheduler, model, layout, mesh)

    def timed_step(self, batch):
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        out = step(self, batch)
        torch.cuda.synchronize(self.device)
        seen["step_ms"].append((time.perf_counter() - t) * 1e3)
        if len(seen["step_ms"]) == 1 and self.is_main and self.layout is None:
            save_grads(self.model, f"{out_prefix}.grads.pt")
        return out

    def timed_flag(*args, **kwargs):
        t = time.perf_counter()
        out = flag_all_reduce(*args, **kwargs)
        seen["flag_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def timed_preempt_save(self, reason):
        t = time.perf_counter()
        preempt_save(self, reason)
        seen["preempt_save_s"] = time.perf_counter() - t

    def recorded_fit(self, *args, **kwargs):
        seen.update(backend=dist.get_backend() if dist.is_initialized() else None,
                    world=dist.get_world_size() if dist.is_initialized() else 1,
                    mesh=mesh_shape_str(self.mesh), plan=self.plan is not None,
                    host_slice=self.host_slice, device=str(self.device))
        torch.cuda.reset_peak_memory_stats(self.device)
        try:
            return fit(self, *args, **kwargs)
        except SystemExit:
            # every rank took the agreed SIGTERM at the same boundary: the
            # saved step against the state they hold (a collective gather)
            seen.update(terminated="SIGTERM", step=self.global_step)
            live = self.state()
            if self.is_main:
                saved = ckpt.load(self.workspace, self.global_step)
                seen["saved_vs_live"] = [k for k, v in live["model"].items()
                                         if not torch.equal(saved["model"][k], v.cpu())] + [
                    (i, m) for i, entry in live["optimizer"]["state"].items()
                    for m in ("exp_avg", "exp_avg_sq", "step")
                    if not torch.equal(saved["optimizer"]["state"][i][m], entry[m].cpu())]
            raise
        except Exception as exc:  # noqa: BLE001 - recorded, then re-raised
            seen.update(exception=f"{type(exc).__name__}: {str(exc)[:300]}",
                        step=self.global_step)
            name = ckpt.shard_dir_name(self.global_step, self.rank, dist.get_world_size())
            path = os.path.join(self.workspace, "checkpoints", name, ckpt.SHARD_FILE)
            if os.path.exists(path):
                saved, live = torch.load(path, weights_only=True), self.rank_shard()
                seen["shard_vs_live"] = [k for k, v in live["model"].items()
                                         if not torch.equal(saved["model"][k], v)]
                seen["shard_bytes"] = os.path.getsize(path)
            raise
        finally:
            with torch.no_grad():
                params = [p.double() for p in self.model.parameters()]
                seen["digest"] = [sum(float(p.sum()) for p in params),
                                  sum(float(p.abs().sum()) for p in params)]
            seen["peak_allocated_gb"] = torch.cuda.max_memory_allocated(self.device) / 1e9
            if self.layout is not None:
                seen["state_bytes"] = dp.state_bytes(self.model, self.optimizer, self.layout,
                                                     self.mesh)

    loop.Trainer.step, loop.Trainer.fit = timed_step, recorded_fit
    loop.Trainer._preempt_save, loop.all_reduce_max_int = timed_preempt_save, timed_flag
    dp.sharded_optimizer_step = saving_sharded_step
    # the group outlives each segment's CLI run (its main destroys it)
    dist.destroy_process_group = lambda *a, **k: None
    rank = int(os.environ.get("RANK", "0"))

    def sigterm_ends(signum, frame):
        raise SystemExit(128 + signum)

    try:
        for out_prefix, argv, *more in segments:
            opts = more[0] if more else {}
            seen.clear()
            seen.update(step_ms=[], flag_ms=[])
            t_segment = time.perf_counter()
            kw.reset_launches()
            tally = SizeTally(kw)
            fault = opts.get("faults", {}).get(str(rank))
            if fault:
                chaos.install(fault)
            prev = (signal.signal(signal.SIGTERM, sigterm_ends)
                    if opts.get("ends") == "sigterm" else None)
            logged, ended = None, None
            try:
                logged = train.main(argv)
            except SystemExit as exc:
                if opts.get("ends") != "sigterm":
                    raise
                ended = exc.code
            except Exception:  # noqa: BLE001 - the run's own error, recorded
                if opts.get("ends") != "exception":
                    raise
                ended = "exception"
            finally:
                if prev is not None:
                    signal.signal(signal.SIGTERM, prev)
            torch.cuda.synchronize()
            schedule = chaos.active()
            seen.update(logged=logged, ended=ended, launches=dict(kw.launches),
                        sizes=tally.read(),
                        chaos_pending=schedule.pending() if schedule is not None else None,
                        seconds=time.perf_counter() - t_segment)
            chaos.uninstall()
            tally.close()
            with open(f"{out_prefix}.r{rank}.json", "w") as fh:
                json.dump(seen, fh)
            if ended == "exception":
                # the last segment: this exit also releases a peer blocked in
                # a collective (its gloo pair closes)
                sys.stdout.flush()
                os._exit(0)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group = destroy
        if dist.is_initialized():
            destroy()
    return 0


def save_grads(model: torch.nn.Module, path: str) -> None:
    """The gradients a train step left in .grad, by parameter name, on the
    host."""
    torch.save({n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
                if p.grad is not None}, path)


def grad_gap(a: dict, b: dict, top: int = 0) -> dict:
    """How far gradient a lies from gradient b (dicts by parameter name):
    the relative L2 of a - b, both norms and, with `top`, the parameters
    holding most of the difference (their share of |a - b|^2 and their own
    relative gap)."""
    diff2 = {n: float(((a[n].double() - g.double()) ** 2).sum()) for n, g in b.items()}
    norm2 = {n: float((g.double() ** 2).sum()) for n, g in b.items()}
    total = sum(diff2.values())
    out = {"rel_l2": math.sqrt(total / max(sum(norm2.values()), 1e-30)),
           "norm": math.sqrt(sum(float((a[n].double() ** 2).sum()) for n in b)),
           "ref_norm": math.sqrt(sum(norm2.values()))}
    if top:
        worst = sorted(diff2, key=diff2.get, reverse=True)[:top]
        out["top"] = [{"param": n, "share": diff2[n] / max(total, 1e-30),
                       "rel_l2": math.sqrt(diff2[n] / max(norm2[n], 1e-30))} for n in worst]
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_rank_segments(out_dir: str, label: str, nproc: int, segments: dict,
                      env: dict | None = None,
                      timeout_s: float = 600.0) -> tuple[dict[str, list[dict]], float]:
    """One `python -m torch.distributed.run --nproc-per-node nproc` launch of
    this script's rank mode over `segments` ({segment label: train CLI args,
    or (args, the rank mode's options)}, run in order); each segment's
    ranks' records, and the wall time of the launch (its log: <label>.log)."""
    prefix = os.path.join(out_dir, label)
    spec = [[os.path.join(out_dir, seg), *(args if isinstance(args, tuple) else (args,))]
            for seg, args in segments.items()]
    with open(f"{prefix}.spec.json", "w") as fh:
        json.dump(spec, fh)
    # two ranks' caching allocators share the card: segments that grow
    # instead of new blocks keep each rank's reserve near its use
    env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True", **(env or {})}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           os.path.abspath(__file__), "--train-rank", f"{prefix}.spec.json"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                          env={**os.environ, **env})
    seconds = time.perf_counter() - t
    with open(f"{prefix}.log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: torchrun exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    records = {}
    for seg in segments:
        records[seg] = []
        for r in range(nproc):
            with open(os.path.join(out_dir, f"{seg}.r{r}.json")) as fh:
                records[seg].append(json.load(fh))
    return records, seconds


def run_ranks(out_dir: str, label: str, nproc: int, train_args: list[str],
              env: dict | None = None, timeout_s: float = 300.0) -> tuple[list[dict], float]:
    """One launch of one training run: its ranks' records and the launch's
    wall time."""
    records, seconds = run_rank_segments(out_dir, label, nproc, {label: train_args}, env,
                                         timeout_s)
    return records[label], seconds


def train_log(ws: str) -> list[dict]:
    with open(os.path.join(ws, "train_log.jsonl")) as fh:
        return [json.loads(ln) for ln in fh]


def final_state(ws: str) -> dict:
    from mine_tpu_torch.training import checkpoint as ckpt

    step = ckpt.latest_step(ws)
    return ckpt.load(ws, step)["model"]


def state_gap(a: dict, b: dict, init: dict) -> dict:
    """How far two runs' weights lie apart: the relative L2 of their
    difference over the L2 of b's update from `init`, the largest element
    gap, and the share of elements within rtol 1e-4, atol 1e-5."""
    diff2 = upd2 = 0.0
    worst, n_in, n_all = 0.0, 0, 0
    for key, want in b.items():
        if not want.dtype.is_floating_point:
            continue
        got, w0 = a[key].double(), init[key].double().cpu()
        want = want.double()
        diff2 += float(((got - want) ** 2).sum())
        upd2 += float(((want - w0) ** 2).sum())
        worst = max(worst, float((got - want).abs().max()))
        n_in += int(torch.isclose(got, want, rtol=1e-4, atol=1e-5).sum())
        n_all += want.numel()
    return {"update_rel_l2": math.sqrt(diff2 / max(upd2, 1e-30)), "max_abs": worst,
            "share_within_1e-4": n_in / n_all}


LOSS_TERMS = ("loss", "loss_rgb_src", "loss_ssim_src", "loss_disp_pt3dsrc", "loss_rgb_tgt",
              "loss_ssim_tgt", "loss_disp_pt3dtgt", "loss_smooth_src_v2", "loss_smooth_tgt_v2",
              "psnr_tgt")


def loss_gaps(a: list[dict], b: list[dict], keys=LOSS_TERMS) -> list[float]:
    """The largest relative gap of each logged step's loss dict."""
    return [max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for k in keys) for x, y in zip(a, b)]


ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG = os.path.join(ROOT, "mine_tpu", "configs", "default.yaml")
# the rank runs' common overrides: synthetic batches, every step logged
RANK_BASE = {"data.name": "synthetic", "training.log_interval": 1, "data.num_workers": 0,
             "training.checkpoint_interval": 1000}
RANK_FP32 = {**RANK_BASE, "model.dtype": "float32"}


def release_card() -> None:
    """This process's cached blocks back to the card, for the ranks (a
    Trainer's bound methods hold it in cycles: collect first)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def rank_cli_args(ws: str, over: dict, steps: int, config: str = DEFAULT_CONFIG) -> list[str]:
    """The train CLI's arguments of a two-rank gloo run sharing cuda:0."""
    return ["--config", config, "--workspace", ws, "--max_steps", str(steps),
            "--extra_config", json.dumps(over), "--dist-backend", "gloo",
            "--device", "cuda:0"]


def one_process_run(out_dir: str, label: str, over: dict, steps: int,
                    config: str = DEFAULT_CONFIG) -> str:
    """The one-process run in this process, as the CLI builds it; its first
    step's gradients to <label>.grads.pt. Returns its workspace."""
    from mine_tpu_torch.config import load_config
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.training.loop import Trainer

    ws = os.path.join(out_dir, label)
    cfg = load_config(config, overrides=over)
    tr = Trainer(cfg, ws)
    step = tr.step

    def recorded_step(batch):
        out = step(batch)
        if tr.global_step == 1:
            save_grads(tr.model, os.path.join(out_dir, f"{label}.grads.pt"))
        return out

    tr.step = recorded_step
    tr.fit(build_dataset(cfg, "train", tr.global_batch),
           build_dataset(cfg, "val", tr.global_batch), max_steps=steps)
    del tr, step, recorded_step
    release_card()
    return ws


PARALLEL_DIR = os.path.join(ROOT, "build", "chip_smoke", "parallel")


def parallel_phase(info, dev, entry, g1, extra_segments: dict[str, list[str]]) -> dict:
    """The parallel path (parallel/, resilience/multihost.py) through the
    train CLI under torchrun, two ranks sharing this card over gloo (NCCL
    puts one rank on a device, and the machine has one): data=2 and
    plane=2, dense and streaming, each held against a one-process run of
    the same seed in this process; the 768x1024, S=128 recipe at plane=2;
    a one-rank NCCL job whose bring-up survives coord_down@init=1; a
    host_stall@step=2 drill ending in the named abort within the watchdog
    window. K5 with a halo plane is held against its plain version on a
    plane shard's real inputs. Every gloo training run, `extra_segments`
    (later phases' runs) with them, goes through one torchrun launch after
    the one-process references (the rank mode's segments). Returns each
    path's launches (summed over ranks), the K5 halo row's inputs and
    launches, and the extra segments' records."""
    import shutil

    from mine_tpu_torch.config import load_config
    from mine_tpu_torch.models.mpi import init_weights
    from mine_tpu_torch.ops import mpi_render as mr
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.resilience import multihost
    from mine_tpu_torch.training.step import build_model

    root = ROOT
    out_dir = PARALLEL_DIR
    os.makedirs(out_dir, exist_ok=True)
    release_card()
    t_phase = time.perf_counter()
    out = {"launches": {}, "out_dir": out_dir}
    default = DEFAULT_CONFIG
    base = RANK_BASE
    cli_args = rank_cli_args

    def reference(label: str, over: dict, steps: int, config: str = default):
        return one_process_run(out_dir, label, over, steps, config)

    def first_grads(label: str) -> dict:
        return torch.load(os.path.join(out_dir, f"{label}.grads.pt"))

    # the one-process runs, twice for fp32: how far two identical runs lie
    # apart (the backward kernel adds in a run-dependent order)
    fp32 = RANK_FP32
    refs = {}
    for label, over in (("ref_dense_fp32", fp32), ("ref_dense_fp32_again", fp32),
                        ("ref_streaming_fp32", {**fp32, "mpi.compositor": "streaming"}),
                        ("ref_dense_bf16", base), ("ref_dense_bf16_again", base)):
        refs[label] = reference(label, {**over, "data.per_gpu_batch_size": 4}, PARALLEL_STEPS)
    init = init_weights(build_model(load_config(default, overrides=fp32)),
                        torch.Generator().manual_seed(0)).state_dict()
    spread = state_gap(final_state(refs["ref_dense_fp32_again"]),
                       final_state(refs["ref_dense_fp32"]), init)
    repeat = {dt: {"loss_gaps": loss_gaps(train_log(refs[f"ref_dense_{dt}_again"]),
                                          train_log(refs[f"ref_dense_{dt}"])),
                   "grad_norm_gaps": loss_gaps(train_log(refs[f"ref_dense_{dt}_again"]),
                                               train_log(refs[f"ref_dense_{dt}"]), ("grad_norm",)),
                   "grad_norms": [ln["grad_norm"] for ln in train_log(refs[f"ref_dense_{dt}"])]}
              for dt in ("fp32", "bf16")}
    # the bf16 recipe's rounding: how far its first gradient lies from fp32's
    bf16_rounding = grad_gap(first_grads("ref_dense_bf16"), first_grads("ref_dense_fp32"))
    emit(info, phase="parallel_reference", steps=PARALLEL_STEPS,
         config="default (resnet50, 384x512, S=32) + synthetic, B=4, fp32 and bf16",
         fp32_repeat_weights_gap=spread, repeat=repeat,
         fp32_repeat_grad_gap=grad_gap(first_grads("ref_dense_fp32_again"),
                                       first_grads("ref_dense_fp32")),
         bf16_vs_fp32_grad_gap=bf16_rounding,
         parent_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         parent_reserved_gb=torch.cuda.memory_reserved() / 1e9,
         seconds=time.perf_counter() - t_phase)

    runs = {
        # label: (overrides, reference, fp32)
        "data2_dense_fp32": ({**fp32, "data.per_gpu_batch_size": 2, "mesh.data_parallel": 2},
                             "ref_dense_fp32", True),
        "plane2_dense_fp32": ({**fp32, "data.per_gpu_batch_size": 4, "mesh.plane_parallel": 2,
                               "mesh.data_parallel": 1}, "ref_dense_fp32", True),
        "plane2_streaming_fp32": ({**fp32, "data.per_gpu_batch_size": 4,
                                   "mesh.plane_parallel": 2, "mesh.data_parallel": 1,
                                   "mpi.compositor": "streaming"}, "ref_streaming_fp32", True),
        "data2_dense_bf16": ({**base, "data.per_gpu_batch_size": 2, "mesh.data_parallel": 2},
                             "ref_dense_bf16", False),
    }
    # the 768x1024, S=128 recipe with remat at plane=2, 2 steps, against one
    # process's first loss (bf16: 2 %)
    highres = os.path.join(root, "mine_tpu", "configs", "llff_highres.yaml")
    hr_over = {**base, "mpi.compositor": "streaming"}
    hr_ref = reference("ref_highres", hr_over, 2, highres)
    hr_ws = os.path.join(out_dir, "plane2_highres")
    segments = {label: cli_args(os.path.join(out_dir, label), over, PARALLEL_STEPS)
                for label, (over, _, _) in runs.items()}
    segments["plane2_highres"] = cli_args(
        hr_ws, {**hr_over, "mesh.plane_parallel": 2, "mesh.data_parallel": 1}, 2, highres)
    segments.update(extra_segments)
    records, launch_s = run_rank_segments(out_dir, "gloo_runs", 2, segments, timeout_s=1000.0)
    out["records"] = {k: records[k] for k in extra_segments}
    emit(info, phase="parallel", path="gloo_launch", segments=list(segments),
         seconds=launch_s, segment_seconds={k: [r["seconds"] for r in v]
                                            for k, v in records.items()})
    results = {}
    for label, (over, ref, is_fp32) in runs.items():
        ws = os.path.join(out_dir, label)
        ranks = records[label]
        seconds = ranks[0]["seconds"]
        if not all(r["backend"] == "gloo" and r["world"] == 2 and r["plan"] for r in ranks):
            raise AssertionError(f"{label}: not a 2-rank gloo job on a mesh {ranks}")
        if ranks[0]["digest"] != ranks[1]["digest"]:
            raise AssertionError(f"{label}: the replicas' weights differ {ranks}")
        losses = loss_gaps(train_log(ws), train_log(refs[ref]))
        # the gradient norm, a value of the loss dict: a gradient summed once
        # too often over the ranks shows there (Adam's update hides it)
        norms = loss_gaps(train_log(ws), train_log(refs[ref]), ("grad_norm",))
        row = {"seconds": seconds, "mesh": ranks[0]["mesh"], "loss_gaps": losses,
               "grad_norm_gaps": norms, "grad_norms": [ln["grad_norm"] for ln in train_log(ws)],
               "step_ms": [r["step_ms"] for r in ranks],
               "peak_allocated_gb": [r["peak_allocated_gb"] for r in ranks],
               "launches": [r["launches"] for r in ranks],
               "host_slices": [r["host_slice"] for r in ranks],
               # the first step's gradient against the one-process run's
               "grad_gap": grad_gap(torch.load(os.path.join(out_dir, f"{label}.grads.pt")),
                                    first_grads(ref), top=5)}
        if is_fp32:
            gap = state_gap(final_state(ws), final_state(refs[ref]), init)
            row["weights_gap"] = gap
            # the first step's losses at rtol 1e-4; its gradient norm within
            # the 5 % that the JAX package's own equivalence tests allow for
            # discrete selections (edge masks, point gathers, the valid-mask
            # threshold) flipping on reassociation noise; a double sum is
            # 100 % off. Later steps and the weights after the Adam steps are
            # reported beside two one-process runs' own gaps: Adam's first
            # update, lr * sign(g), turns any gradient noise into +-lr.
            # The gradient vector is held at the same 5 % (relative L2):
            # data=2 splits the encoder's batch, and its early layers, which
            # hold most of the norm, move ~2 % evenly (plane=2 ~1e-4); in
            # float64 on the CPU data=2 equals one process, and its fp32
            # gradient lies closer to the exact one than one process's.
            if losses[0] > 1e-4 or norms[0] > 0.05 or row["grad_gap"]["rel_l2"] > 0.05:
                raise AssertionError(f"{label}: first step's loss dict {losses[0]} (rtol 1e-4), "
                                     f"gradient norm {norms[0]} or gradient "
                                     f"{row['grad_gap']['rel_l2']} (5 %) from the one-process "
                                     "run's")
        else:
            # bf16: the first step's loss dict within 2 %. Its gradient is
            # held by the recipe's own rounding: the bf16 one-process
            # gradient lies bf16_rounding away from the fp32 one, and
            # data=2's, which splits the batch's bf16 reductions differently,
            # may lie no farther (x1.5), in the vector and in its norm. A
            # gradient summed twice or a statistic synced wrongly lands far
            # outside (tests/test_torch_parallel.py holds the same witness
            # against float64 on the CPU).
            fp32_grads = first_grads("ref_dense_fp32")
            witness = grad_gap(torch.load(os.path.join(out_dir, f"{label}.grads.pt")),
                               fp32_grads)
            norm_gap = abs(witness["norm"] - bf16_rounding["norm"])
            norm_band = abs(bf16_rounding["norm"] - bf16_rounding["ref_norm"])
            row["vs_fp32"] = dict(witness, one_process_rel_l2=bf16_rounding["rel_l2"],
                                  norm_gap=norm_gap, one_process_norm_gap=norm_band)
            if losses[0] > 0.02 or witness["rel_l2"] > 1.5 * bf16_rounding["rel_l2"] \
                    or norm_gap > 1.5 * norm_band:
                raise AssertionError(
                    f"{label}: bf16 first step's loss dict {losses[0]} from the one-process "
                    f"run's (2 %); gradient {witness['rel_l2']} from the fp32 gradient against "
                    f"the one-process bf16 run's {bf16_rounding['rel_l2']} (x1.5); norm "
                    f"{witness['norm']} against {bf16_rounding['norm']}, the one-process bf16 "
                    f"norm's gap to fp32 {norm_band} (x1.5)")
        results[label] = row
        emit(info, phase="parallel", path=label, **row)
        out["launches"][f"parallel_{label}"] = {
            "kernels": {k: sum(r["launches"][k] for r in ranks) for k in kw.launches},
            "sizes": {k: {c: sum(r["sizes"][k][c] for r in ranks) for c in ("resident", "banded")}
                      for k in ("warp_bilinear", "warp_bilinear_grad")}}
        if label == "plane2_streaming_fp32":
            # rank 0 holds the front planes: each of its K5 launches has a halo
            out["k5_halo_launches"] = ranks[0]["launches"]["warp_composite"]

    ranks = records["plane2_highres"]
    seconds = ranks[0]["seconds"]
    hr_gap = loss_gaps(train_log(hr_ws)[:1], train_log(hr_ref)[:1])
    banded = [r["sizes"]["warp_bilinear"]["banded"] for r in ranks]
    if hr_gap[0] > 0.02 or not all(banded):
        raise AssertionError(f"plane2_highres: first loss gap {hr_gap}, banded K1 {banded}")
    emit(info, phase="parallel", path="plane2_highres",
         config="llff_highres.yaml + synthetic, streaming, plane=2 (S=64 a rank)",
         seconds=seconds, first_loss_gap=hr_gap[0],
         step_ms=[r["step_ms"] for r in ranks],
         peak_allocated_gb=[r["peak_allocated_gb"] for r in ranks],
         launches=[r["launches"] for r in ranks], sizes=[r["sizes"] for r in ranks])
    out["launches"]["parallel_plane2_highres"] = {
        "kernels": {k: sum(r["launches"][k] for r in ranks) for k in kw.launches},
        "sizes": {k: {c: sum(r["sizes"][k][c] for r in ranks) for c in ("resident", "banded")}
                  for k in ("warp_bilinear", "warp_bilinear_grad")}}
    shutil.rmtree(hr_ref, ignore_errors=True)
    shutil.rmtree(hr_ws, ignore_errors=True)

    # one rank over NCCL through the parallel path, its bring-up failing once
    # at the coord_down seam and retried
    nccl_ws = os.path.join(out_dir, "nccl1")
    args = cli_args(nccl_ws, {**base, "resilience.multihost_bringup_backoff_s": 0.5}, 2)
    args[args.index("gloo")] = "nccl"
    ranks, seconds = run_ranks(out_dir, "nccl1", 1, args,
                               env={"MINE_TPU_FAULTS": "coord_down@init=1"})
    with open(os.path.join(out_dir, "nccl1.log")) as fh:
        retried = "bring-up attempt 1/3 failed" in fh.read()
    if ranks[0]["backend"] != "nccl" or not ranks[0]["plan"] or ranks[0]["chaos_pending"] != [] \
            or not retried or not math.isfinite(ranks[0]["logged"]["loss"]):
        raise AssertionError(f"nccl1: {ranks[0]}, retried {retried}")
    emit(info, phase="parallel", path="nccl1_coord_down", backend=ranks[0]["backend"],
         mesh=ranks[0]["mesh"], retried=retried, seconds=seconds,
         loss=ranks[0]["logged"]["loss"], launches=ranks[0]["launches"])
    out["launches"]["parallel_nccl1"] = {
        "kernels": dict(ranks[0]["launches"]), "sizes": ranks[0]["sizes"]}

    # host_stall@step=2 on rank 1: both ranks must take the named abort
    # (exit 83) within the watchdog window of their last heartbeat
    stall_ws = os.path.join(out_dir, "stall")
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        if rank == 1:
            env["MINE_TPU_FAULTS"] = "host_stall@step=2"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mine_tpu_torch.train", *cli_args(stall_ws, {
                **base, "data.per_gpu_batch_size": 2, "mesh.data_parallel": 2,
                "resilience.multihost_watchdog_s": STALL_WINDOW_S}, 6)],
            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    t = time.perf_counter()
    codes = [p.wait(timeout=300) for p in procs]
    stall_s = time.perf_counter() - t
    hb = os.path.join(stall_ws, "heartbeats")
    markers = multihost.abort_markers(hb)
    beats = {r: multihost.read_beat(multihost.beat_path(hb, r)) for r in range(2)}
    late = {r: os.path.getmtime(os.path.join(hb, f"multihost_abort_p{r}.json")) - beats[r]["ts"]
            for r in markers}
    if codes != [multihost.EXIT_HOST_STALL] * 2 or set(markers) != {0, 1} \
            or "host_stall" not in {m["reason"] for m in markers.values()} \
            or max(late.values()) > STALL_WINDOW_S + 5.0:
        raise AssertionError(f"host_stall drill: exit codes {codes}, markers {markers}, "
                             f"beats {beats}, marker after last beat {late}:\n"
                             + "\n".join(p.stderr.read()[-2000:] for p in procs))
    emit(info, phase="parallel", path="host_stall", exit_codes=codes,
         reasons={r: m["reason"] for r, m in markers.items()},
         suspect=[m.get("suspect") for m in markers.values()],
         last_beat_steps={r: b["step"] for r, b in beats.items()},
         abort_after_last_beat_s=late, window_s=STALL_WINDOW_S, seconds=stall_s,
         stragglers=multihost.straggler_table(hb))

    # K5 with the halo on a plane shard's real inputs: the served MPI's front
    # half, the back half's first plane as its halo
    s_half = entry.disparity.shape[1] // 2
    k_inv = inverse_3x3(entry.k)
    halo_in = (entry.mpi_rgb[:, :s_half].contiguous(), entry.mpi_sigma[:, :s_half].contiguous(),
               *mr.streaming_matrices(entry.disparity[:, :s_half], g1, k_inv, entry.k,
                                      halo_depth=1.0 / entry.disparity[:, s_half]))
    halo_out = kw.warp_composite(*halo_in)
    halo_err = check_close("warp_composite with a halo plane", halo_out,
                           kw.warp_composite_matrix_plain(*halo_in), **TOL)
    # the front half with its halo, then the back half, is the whole render
    back = kw.warp_composite(entry.mpi_rgb[:, s_half:].contiguous(),
                             entry.mpi_sigma[:, s_half:].contiguous(),
                             *mr.streaming_matrices(entry.disparity[:, s_half:], g1, k_inv,
                                                    entry.k))
    whole = kw.warp_composite(entry.mpi_rgb, entry.mpi_sigma,
                              *mr.streaming_matrices(entry.disparity, g1, k_inv, entry.k))
    t_front = halo_out[:, 6:7]
    combined = torch.cat([halo_out[:, :5] + t_front * back[:, :5],
                          halo_out[:, 5:6] + back[:, 5:6], t_front * back[:, 6:7]], dim=1)
    compose_err = check_close("two plane shards composed vs the whole", combined, whole,
                              rtol=1e-4, atol=1e-5)
    emit(info, phase="kernel_check", kernel="warp_composite", case="plane shard with halo",
         shape=list(halo_in[0].shape), max_abs_err=halo_err, composed_vs_whole_err=compose_err,
         tolerance=TOL)
    out.update(k5_halo=halo_in, k5_halo_err=halo_err, seconds=time.perf_counter() - t_phase)
    emit(info, phase="parallel", path="summary", seconds=out["seconds"],
         note="two ranks share one card over gloo: these step times are no scaling figure")
    return out


SHARDED_STEPS = 2
C2F_FINE = 32  # mpi.num_bins_fine of the coarse-to-fine phase: 32 + 32 = 64 planes


def rank_launches(ranks: list[dict]) -> dict:
    """A rank run's kernel launches and K1/K2 size classes, summed over its
    ranks."""
    from mine_tpu_torch.ops.kernels import warp as kw

    return {"kernels": {k: sum(r["launches"][k] for r in ranks) for k in kw.launches},
            "sizes": {k: {c: sum(r["sizes"][k][c] for r in ranks) for c in ("resident", "banded")}
                      for k in ("warp_bilinear", "warp_bilinear_grad")}}


def resident_launches(launches: dict) -> dict:
    """A one-process path's launches at 384x512 (K1/K2 all resident)."""
    return {"kernels": launches,
            "sizes": {k: {"resident": launches[k], "banded": 0}
                      for k in ("warp_bilinear", "warp_bilinear_grad")}}


SHARDED_RUNS = {"fsdp2_fp32": {"mesh.data_parallel": 1, "mesh.fsdp_parallel": 2},
                "zero1_data2_fp32": {"mesh.data_parallel": 2, "parallel.zero1": True}}
C2F_OVER = {**RANK_FP32, "data.per_gpu_batch_size": 2, "mpi.num_bins_fine": C2F_FINE}


# the emergency run (the launch's last segment): rank 1 raises after step
# SHARDED_STEPS under fsdp=2
EMERGENCY_RUN = "emergency_fsdp2_fp32"


def section12_segments() -> dict:
    """The two-rank training runs of the sharded_state, preemption and
    coarse_to_fine phases, launched with the parallel phase's
    (`parallel_phase` extra_segments). The sharded runs are the preemption
    runs too: each is to run SHARDED_STEPS + 1 steps, and rank 1 alone is
    SIGTERMed after step SHARDED_STEPS. The emergency run comes last, since
    it ends the ranks."""
    def args(label: str, over: dict, steps: int) -> list[str]:
        return rank_cli_args(os.path.join(PARALLEL_DIR, label),
                             {**RANK_FP32, "data.per_gpu_batch_size": 2, **over}, steps)

    segments = {label: (args(label, over, SHARDED_STEPS + 1),
                        {"faults": {"1": f"sigterm@step={SHARDED_STEPS}"}, "ends": "sigterm"})
                for label, over in SHARDED_RUNS.items()}
    segments["c2f_plane2_fp32"] = rank_cli_args(
        os.path.join(PARALLEL_DIR, "c2f_plane2_fp32"),
        {**C2F_OVER, "mesh.plane_parallel": 2, "mesh.data_parallel": 1}, 2)
    segments[EMERGENCY_RUN] = (
        args(EMERGENCY_RUN, SHARDED_RUNS["fsdp2_fp32"], SHARDED_STEPS + 1),
        {"faults": {"1": f"preempt_exit@step={SHARDED_STEPS}"}, "ends": "exception"})
    return segments


def resume_one_process(ws: str, steps: int, over: dict | None = None) -> dict:
    """One process (replicated) resuming `ws` to `steps`, the default
    recipe in fp32 at B=4: its last logged loss dict, launches and
    seconds."""
    from mine_tpu_torch.config import load_config
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.training.loop import Trainer

    cfg = load_config(DEFAULT_CONFIG, overrides={**RANK_FP32, "data.per_gpu_batch_size": 4,
                                                 **(over or {})})
    kw.reset_launches()
    t = time.perf_counter()
    tr = Trainer(cfg, ws)
    logged = tr.fit(build_dataset(cfg, "train", tr.global_batch), max_steps=steps)
    torch.cuda.synchronize()
    out = {"logged": logged, "global_step": tr.global_step, "launches": dict(kw.launches),
           "seconds": time.perf_counter() - t, "trainer": tr}
    return out


def preempt_phase(info, par: dict) -> dict:
    """The preemption save and the emergency checkpoint on two gloo ranks
    sharing the card (segments of the parallel phase's launch), the default
    recipe in fp32 at B=4. Preemption (the sharded_state runs, fsdp=2 and
    ZeRO-1 over data=2): rank 1 alone is SIGTERMed after step 2; both ranks
    must end with the SIGTERM's disposition at that boundary, step 2 must be
    on disk, vetted last-good and equal bit for bit to the state the ranks
    hold, and a one-process resume must run step 3 with finite losses (the
    ZeRO-1 run's here, the fsdp=2 run's in sharded_state_phase, which runs
    after this). Each rank's save seconds and the host time of the per-step
    flag all-reduce (over every two-rank segment of the launch) are
    reported. Emergency (fsdp=2): rank 1 raises after step 2, rank 0 then
    fails in step 3's gather; each must have written its own verified shard
    file of step 2 holding what it holds, step 2 must count, and one process
    (another layout) resumes it for step 3. Returns the launches of the
    resumes and the emergency run (the preempted runs' are sharded_state's)."""
    from mine_tpu_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    out_dir = par["out_dir"]
    # each boundary's flag all-reduce: the rank that arrives first waits for
    # the other there, so the later arrival's host time (the smaller of the
    # two) is the all-reduce's own cost
    launches, flag_ms, flag_wait_ms = {}, [], []
    for ranks in par["records"].values():
        calls = [r.get("flag_ms", []) for r in ranks]
        if len(ranks) == 2 and calls[0] and len(calls[0]) == len(calls[1]):
            flag_ms += [min(pair) for pair in zip(*calls)]
            flag_wait_ms += [max(pair) for pair in zip(*calls)]
    for label in SHARDED_RUNS:
        ws = os.path.join(out_dir, label)
        ranks = par["records"][label]
        log = train_log(ws)
        problems = []
        if [r.get("terminated") for r in ranks] != ["SIGTERM"] * 2 or \
                [r["ended"] for r in ranks] != [128 + 15] * 2:
            problems.append(f"ends {[(r.get('terminated'), r['ended']) for r in ranks]}")
        if ckpt.all_steps(ws) != [SHARDED_STEPS] or ckpt.last_good_step(ws) != SHARDED_STEPS:
            problems.append(f"steps {ckpt.all_steps(ws)}, last good {ckpt.last_good_step(ws)}")
        if ranks[0].get("saved_vs_live") != [] or [ln["global_step"] for ln in log] != [1, 2]:
            problems.append(f"saved vs live {ranks[0].get('saved_vs_live')}, log {log}")
        if ranks[1]["chaos_pending"] != []:
            problems.append(f"rank 1's fault did not fire: {ranks[1]['chaos_pending']}")
        resumed = {}
        if label != "fsdp2_fp32":  # sharded_state_phase resumes that one
            resumed = resume_one_process(ws, SHARDED_STEPS + 1)
            del resumed["trainer"]
            release_card()
            if resumed["global_step"] != SHARDED_STEPS + 1 or \
                    not math.isfinite(resumed["logged"]["loss"]):
                problems.append(f"resume {resumed}")
            launches[f"preempt_{label}_resume"] = resident_launches(resumed["launches"])
        if problems:
            raise AssertionError(f"preempt {label}: {problems}")
        emit(info, phase="preempt", path=label, mesh=ranks[0]["mesh"],
             ended=[r["ended"] for r in ranks], saved_step=SHARDED_STEPS,
             saved_equals_live_bitwise=True,
             preempt_save_s=[r.get("preempt_save_s") for r in ranks],
             flag_ms_median=[statistics.median(r["flag_ms"]) for r in ranks],
             step_ms=[r["step_ms"] for r in ranks], seconds=ranks[0]["seconds"],
             resume_loss=resumed.get("logged", {}).get("loss"),
             resume_seconds=resumed.get("seconds"))
    ws = os.path.join(out_dir, EMERGENCY_RUN)
    ranks = par["records"][EMERGENCY_RUN]
    names = [ckpt.shard_dir_name(SHARDED_STEPS, r, 2) for r in range(2)]
    for name in names:
        ckpt.verify_checkpoint_integrity(ws, name, require_sidecar=True)
    if [r["ended"] for r in ranks] != ["exception"] * 2 or \
            not ranks[1]["exception"].startswith("PreemptedError") or \
            [r.get("shard_vs_live") for r in ranks] != [[], []] or \
            ckpt.all_steps(ws) != [SHARDED_STEPS]:
        raise AssertionError(f"{EMERGENCY_RUN}: records {ranks}, steps {ckpt.all_steps(ws)}")
    state = ckpt.load(ws, SHARDED_STEPS)
    finite = all(bool(torch.isfinite(v).all()) for v in state["model"].values()
                 if v.is_floating_point())
    resumed = resume_one_process(ws, SHARDED_STEPS + 1)
    del resumed["trainer"]
    release_card()
    if not finite or resumed["global_step"] != SHARDED_STEPS + 1 \
            or not math.isfinite(resumed["logged"]["loss"]):
        raise AssertionError(f"{EMERGENCY_RUN}: reassembled finite {finite}, resume {resumed}")
    emit(info, phase="preempt", path=EMERGENCY_RUN, mesh=ranks[0]["mesh"],
         errors=[r["exception"][:160] for r in ranks], shard_files=names,
         shard_bytes=[r.get("shard_bytes") for r in ranks], shards_equal_live=True,
         reassembled_params=len(state["model"]), resume_loss=resumed["logged"]["loss"],
         resume_seconds=resumed["seconds"], seconds=ranks[0]["seconds"])
    launches[EMERGENCY_RUN] = rank_launches(ranks)
    launches[f"{EMERGENCY_RUN}_resume"] = resident_launches(resumed["launches"])
    emit(info, phase="preempt", path="flag_all_reduce", boundaries=len(flag_ms),
         later_rank_ms_median=statistics.median(flag_ms), later_rank_ms_max=max(flag_ms),
         earlier_rank_ms_median=statistics.median(flag_wait_ms),
         note="one int32 MAX over the two gloo ranks at each step boundary, host clock; the "
              "earlier rank's time includes waiting for the later one")
    emit(info, phase="preempt", path="summary", seconds=time.perf_counter() - t_phase)
    return {"launches": launches}


def warm_start_phase(info, source_ws: str) -> dict:
    """A warm start from a port workspace directory an earlier phase wrote
    (training.pretrained_checkpoint_path): one step in a fresh workspace at
    the default recipe in fp32, B=4, with K1 and K2 launched; the weights
    before the step must equal the source's newest checkpoint, the step
    count start at 0 and the schedule's count carry over."""
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.loop import Trainer

    source = ckpt.load(source_ws, ckpt.latest_step(source_ws))
    ws = os.path.join(PARALLEL_DIR, "warm_start")
    start = Trainer._start
    seen = {}

    def recorded_start(self, steps_per_epoch):
        out = start(self, steps_per_epoch)
        seen["equal"] = all(torch.equal(v.cpu(), source["model"][k])
                            for k, v in self.model.state_dict().items())
        seen["schedule_count"] = self.scheduler.last_epoch
        return out

    Trainer._start = recorded_start
    try:
        run = resume_one_process(ws, 1, {"training.pretrained_checkpoint_path": source_ws})
    finally:
        Trainer._start = start
    tr = run.pop("trainer")
    del tr
    release_card()
    k = run["launches"]
    if not seen.get("equal") or seen["schedule_count"] != source["scheduler"]["last_epoch"] \
            or run["global_step"] != 1 or not math.isfinite(run["logged"]["loss"]) \
            or k["warp_bilinear"] != 4 or k["warp_bilinear_grad"] != 4:
        raise AssertionError(f"warm start from {source_ws}: {seen}, {run}")
    emit(info, phase="warm_start", source=os.path.basename(source_ws),
         source_step=source["global_step"], schedule_count=seen["schedule_count"],
         weights_equal_source=True, loss=run["logged"]["loss"], launches=k,
         seconds=run["seconds"])
    return {"launches": {"warm_start": resident_launches(k)}}


def sharded_state_phase(info, par: dict) -> dict:
    """Sharded training state (parallel/rules.py) through the train CLI on
    two gloo ranks sharing the card (segments of the parallel phase's
    launch, `section12_segments`), the default recipe in fp32 at B=4:
    mesh.fsdp_parallel=2, and data=2 with parallel.zero1, SHARDED_STEPS
    steps each (then preempted: preempt_phase, which runs first). Each
    rank's resident parameter and Adam-moment bytes must
    equal the table's placement_bytes and lie below the replicated figure;
    the first step's loss terms and gradients are held against the
    parallel phase's data=2 run (the same batch split) at the tolerances
    the parallel phase holds data=2 to (1e-4, 5 %), and reported as
    relative gaps; the fsdp=2 checkpoint, gathered by the preemption save,
    resumes in one process for a step. Returns each run's launches."""
    from mine_tpu_torch.config import load_config
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.training.loop import Trainer

    t_phase = time.perf_counter()
    out_dir = par["out_dir"]
    data2_ws = os.path.join(out_dir, "data2_dense_fp32")
    data2_grads = torch.load(os.path.join(out_dir, "data2_dense_fp32.grads.pt"))
    launches, results = {}, {}
    for label in SHARDED_RUNS:
        ws = os.path.join(out_dir, label)
        ranks = par["records"][label]
        if not all(r["backend"] == "gloo" and r["world"] == 2 and r["plan"] for r in ranks):
            raise AssertionError(f"{label}: not a 2-rank gloo job on a mesh {ranks}")
        state = [r["state_bytes"] for r in ranks]
        if not all(b["resident"] == b["table"] < b["replicated"] for b in state):
            raise AssertionError(f"{label}: resident bytes {state} are not the table's "
                                 "placement_bytes below the replicated figure")
        losses = loss_gaps(train_log(ws), train_log(data2_ws))
        gap = grad_gap(torch.load(os.path.join(out_dir, f"{label}.grads.pt")), data2_grads,
                       top=3)
        if losses[0] > 1e-4 or gap["rel_l2"] > 0.05:
            raise AssertionError(f"{label}: first step's loss dict {losses[0]} (rtol 1e-4) or "
                                 f"gradient {gap['rel_l2']} (5 %) from the data=2 run's")
        row = {"seconds": ranks[0]["seconds"], "mesh": ranks[0]["mesh"], "state_bytes": state,
               "state_ratio": [b["resident"] / b["replicated"] for b in state],
               "loss_gaps_vs_data2": losses, "grad_gap_vs_data2": gap,
               "grad_norms": [ln["grad_norm"] for ln in train_log(ws)],
               "step_ms": [r["step_ms"] for r in ranks],
               "peak_allocated_gb": [r["peak_allocated_gb"] for r in ranks],
               "launches": [r["launches"] for r in ranks]}
        if not all(r["launches"]["warp_bilinear"] and r["launches"]["warp_bilinear_grad"]
                   for r in ranks):
            raise AssertionError(f"{label}: K1 or K2 never launched {row['launches']}")
        results[label] = row
        emit(info, phase="sharded_state", path=label, **row)
        launches[f"sharded_{label}"] = rank_launches(ranks)
    # the fsdp=2 run's step-2 checkpoint (gathered on save) resumes in one
    # process, replicated, for one step
    ws = os.path.join(out_dir, "fsdp2_fp32")
    cfg = load_config(DEFAULT_CONFIG, overrides={**RANK_FP32, "data.per_gpu_batch_size": 4})
    t = time.perf_counter()
    tr = Trainer(cfg, ws)
    logged = tr.fit(build_dataset(cfg, "train", tr.global_batch), max_steps=SHARDED_STEPS + 1)
    resumed = train_log(ws)[-1]
    if resumed["global_step"] != SHARDED_STEPS + 1 or not math.isfinite(logged["loss"]):
        raise AssertionError(f"fsdp=2 checkpoint resume: {resumed}")
    emit(info, phase="sharded_state", path="fsdp2_checkpoint_resume_one_process",
         resumed_step=resumed["global_step"], loss=logged["loss"],
         grad_norm=logged["grad_norm"], seconds=time.perf_counter() - t)
    del tr
    release_card()
    emit(info, phase="sharded_state", path="summary", seconds=time.perf_counter() - t_phase,
         note="the two runs' seconds are their segments of the parallel phase's launch")
    return {"launches": launches, "results": results}


def coarse_to_fine_reference(info) -> dict:
    """Coarse-to-fine training (mpi.num_bins_fine = C2F_FINE, 64 planes) in
    fp32 at B=2, two dense steps in one process, before the parallel
    phase's launch: their launches (4 K1 and 4 K2 a step: the coarse pass
    renders without the warp) and peak memory; the plane=2 run's
    reference."""
    from mine_tpu_torch.ops.kernels import warp as kw

    release_card()
    torch.cuda.reset_peak_memory_stats()
    kw.reset_launches()
    t = time.perf_counter()
    ws = one_process_run(PARALLEL_DIR, "c2f_dense_fp32", C2F_OVER, 2)
    launches = dict(kw.launches)
    log = train_log(ws)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(log) != 2 or not all(math.isfinite(ln["loss"]) for ln in log) \
            or launches["warp_bilinear"] != 8 or launches["warp_bilinear_grad"] != 8:
        raise AssertionError(f"coarse-to-fine dense steps: {log}, {launches}")
    emit(info, phase="coarse_to_fine", path="train_dense", planes=32 + C2F_FINE, batch_size=2,
         losses=[ln["loss"] for ln in log], grad_norms=[ln["grad_norm"] for ln in log],
         launches=launches, peak_allocated_gb=peak_gb, seconds=time.perf_counter() - t)
    return {"log": log, "launches": launches}


def coarse_to_fine_train(info, par: dict, ref: dict) -> dict:
    """The coarse-to-fine run at plane=2 on two gloo ranks sharing the card
    (a segment of the parallel phase's launch), 2 steps: the first step's
    loss terms held against the one-process run's at rtol 1e-4. Returns the
    launches of both runs."""
    ranks = par["records"]["c2f_plane2_fp32"]
    ws = os.path.join(par["out_dir"], "c2f_plane2_fp32")
    losses = loss_gaps(train_log(ws), ref["log"])
    norms = loss_gaps(train_log(ws), ref["log"], ("grad_norm",))
    if losses[0] > 1e-4 or not all(r["launches"]["warp_bilinear"] for r in ranks):
        raise AssertionError(f"coarse-to-fine plane=2: first step's loss dict {losses[0]} from "
                             f"the one-process run's (rtol 1e-4); launches "
                             f"{[r['launches'] for r in ranks]}")
    emit(info, phase="coarse_to_fine", path="train_plane2", mesh=ranks[0]["mesh"],
         loss_gaps=losses, grad_norm_gaps=norms, step_ms=[r["step_ms"] for r in ranks],
         peak_allocated_gb=[r["peak_allocated_gb"] for r in ranks],
         launches=[r["launches"] for r in ranks], seconds=ranks[0]["seconds"])
    return {"launches": {"c2f_train_dense": resident_launches(ref["launches"]),
                         "c2f_train_plane2": rank_launches(ranks)}}


def coarse_to_fine_serve(info, dev, state: dict, image: np.ndarray, g1: torch.Tensor,
                         poses: np.ndarray) -> dict:
    """A coarse-to-fine RenderEngine bucket (the default recipe with
    mpi.num_bins_fine = C2F_FINE) predicts once and renders `poses`
    (streaming, K5 at S=64); VideoGenerator renders them dense (K1). The
    served entry's own inputs at `g1` are K5's S=64 operands, held against
    its plain version at TOL. Returns the launches and K5's operands."""
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.inference.video import VideoGenerator
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.ops.mpi_render import streaming_matrices
    from mine_tpu_torch.serving.engine import RenderEngine

    t_phase = time.perf_counter()
    cfg = Config().replace(**{"mpi.num_bins_fine": C2F_FINE})
    planes = cfg.mpi.num_bins_coarse + C2F_FINE
    h, w = cfg.data.img_h, cfg.data.img_w
    kw.reset_launches()
    engine = RenderEngine(cfg, state)
    entry = engine.predict(image)
    rgb, disp = engine.render(entry, poses)
    video = VideoGenerator(cfg.replace(**{"mpi.compositor": "dense"}), state, image)
    v_rgb, v_disp = video.render_poses(poses)
    torch.cuda.synchronize()
    launches = dict(kw.launches)
    d = entry.disparity
    if entry.bucket != (h, w, cfg.mpi.num_bins_coarse) or tuple(entry.mpi_rgb.shape) != \
            (1, planes, h, w, 3) or not bool((d[:, 1:] < d[:, :-1]).all()) \
            or not np.isfinite(rgb).all() or not np.isfinite(v_rgb).all() \
            or rgb.shape != (len(poses), h, w, 3):
        raise AssertionError(f"coarse-to-fine serving: bucket {entry.bucket}, MPI "
                             f"{tuple(entry.mpi_rgb.shape)}, disparity {d.tolist()}")
    if launches["warp_composite"] == 0 or launches["warp_bilinear"] != len(poses):
        raise AssertionError(f"coarse-to-fine serving did not render through K5 and K1 "
                             f"{launches}")
    k5_in = (entry.mpi_rgb, entry.mpi_sigma,
             *streaming_matrices(entry.disparity, g1, inverse_3x3(entry.k), entry.k))
    k5_err = check_close(f"warp_composite (1,{planes},{h},{w}) coarse-to-fine",
                         kw.warp_composite(*k5_in), kw.warp_composite_matrix_plain(*k5_in), **TOL)
    emit(info, phase="coarse_to_fine", path="serve", bucket=list(entry.bucket), planes=planes,
         disparity_merged_vs_video_max_abs=float((entry.disparity - video.disparity).abs().max()),
         engine_vs_video_frames_max_abs={"rgb": float(np.abs(rgb - v_rgb).max()),
                                         "disparity": float(np.abs(disp - v_disp).max())},
         launches=launches, k5_s64_err=k5_err, tolerance=TOL,
         seconds=time.perf_counter() - t_phase)
    del engine, video
    return {"launches": {"c2f_serve": resident_launches(launches)}, "k5_in": k5_in,
            "k5_err": k5_err, "k5_launches": launches["warp_composite"]}


# 13. the quality harnesses (mine_tpu_torch/tools/), run as the CLIs a user runs
QUALITY_DIR = os.path.join(ROOT, "build", "chip_smoke", "quality")
QUALITY_STEPS = {"fp32": 2200, "bf16": 2200}  # the JAX long run's recipe (BASELINE.md:66)
QUALITY_EVAL_EVERY = 100
QUALITY_E2E_EPOCHS = 300  # 3 steps an epoch: 900 steps, as BASELINE.md:72's longer run
QUALITY_PLANES = (8, 16, 32)
QUALITY_DB = 1e-2  # the agreement the phase holds PSNRs to, dB
# the median novel-pose PSNR of the fp32 run's last QUALITY_TAIL evals must
# reach QUALITY_FP32_MIN_DB and gain QUALITY_GAIN_DB over the median of its
# first QUALITY_HEAD evals: one eval moves +-1.5 dB or more from the next as
# the weights do, a median of a few moves less; the end-to-end chain's val
# PSNR must reach QUALITY_E2E_MIN_DB
QUALITY_FP32_MIN_DB, QUALITY_GAIN_DB, QUALITY_E2E_MIN_DB = 16.0, 1.0, 12.0
QUALITY_HEAD, QUALITY_TAIL = 3, 5
# steps of each arm of the batch-feed comparison (inline, feed, feed, inline),
# timed in blocks of ARM_BLOCK
ARM_STEPS, ARM_BLOCK = 30, 10
# the JAX package's figures (fp32, on a 1-core CPU host), reported beside the card's
JAX_QUALITY = {
    "source": "JAX package, fp32, CPU (BASELINE.md)",
    "convergence": {"where": "BASELINE.md:64,66", "untrained": 13.2, "step_1000": 16.9,
                    "step_2200": 18.30, "curve_every_100": [
                        15.6, 15.9, 16.0, 16.5, 17.2, 17.4, 16.5, 15.6, 16.9, 17.1, 15.7,
                        16.9, 17.2, 18.0, 17.6, 17.8, 17.8, 17.2, 17.4, 18.5, 17.9, 18.3]},
    "oracle": {"where": "BASELINE.md:65", "S=8 soft": 20.4, "S=8 hard": 19.2, "S=16": 19.9,
               "S=32": 19.6, "psnr_src_pose": 119},
    "disocclusion": {"where": "BASELINE.md:99", "planes": "4 coarse + 4 fine, 400 steps",
                     "oracle_visible": 35.1, "oracle_disoccluded": 6.2,
                     "trained_disoccluded": 10.7, "inpainting_gain_db": 4.4},
    "e2e": {"where": "BASELINE.md:72", "val_psnr_360_steps": 12.38, "val_psnr_900_steps": 14.19},
}
BACKGROUND: list[subprocess.Popen] = []  # stopped when the script ends, however it ends


def background_cli(name: str, argv: list[str]) -> dict:
    """`python -m <argv>` from the checkout's root in the background, its
    stdout and stderr to files under QUALITY_DIR."""
    out_path, err_path = (os.path.join(QUALITY_DIR, f"{name}.{s}") for s in ("out", "err"))
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT, stdout=out,
                                stderr=err, text=True)
    BACKGROUND.append(proc)
    return {"name": name, "proc": proc, "t0": time.perf_counter(), "out": out_path,
            "err": err_path}


def finish_cli(run: dict, timeout_s: float = 900.0) -> tuple[dict, float]:
    """(verdict, seconds since its start) of a background CLI: its last stdout
    line. Raises unless it exits 0 with a verdict whose ok is true."""
    rc = run["proc"].wait(timeout=timeout_s)
    seconds = time.perf_counter() - run["t0"]
    with open(run["out"]) as fh:
        lines = fh.read().strip().splitlines()
    verdict = json.loads(lines[-1]) if lines else {}
    if rc != 0 or not verdict.get("ok"):
        with open(run["err"]) as fh:
            tail = fh.read()[-3000:]
        raise AssertionError(f"quality {run['name']}: exit {rc}, verdict {verdict}:\n{tail}")
    return verdict, seconds


def stop_background() -> None:
    for proc in BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_quality_runs() -> dict:
    """Start the quality phase's CLIs in the background: the fp32 and bf16
    convergence runs (2200 steps each), the end-to-end chain through the
    train and evaluate CLIs (900 steps) and the oracle ceiling, dense and
    streaming. Each harness step is bound by the host's launch rate (~120 ms
    at 128x128 on the H100's host), so the runs share the card with each
    other and with the sections that follow, whose ranks and drills leave
    the card and the host's cores partly idle. Every line emitted from here
    to the end of quality_phase's collection is tagged contended."""
    import shutil

    global CONTENDED
    CONTENDED = True
    shutil.rmtree(QUALITY_DIR, ignore_errors=True)
    os.makedirs(QUALITY_DIR)
    runs = {}
    for label, steps in QUALITY_STEPS.items():
        argv = ["mine_tpu_torch.tools.convergence_run", "--steps", str(steps),
                "--eval-every", str(QUALITY_EVAL_EVERY), "--eval-phases", "3",
                "--out", os.path.join(QUALITY_DIR, label),
                "--dtype", "float32" if label == "fp32" else "bfloat16"]
        if label == "fp32":
            argv += ["--save-final", os.path.join(QUALITY_DIR, "fp32_final.pt")]
        runs[label] = background_cli(label, argv)
    runs["e2e"] = background_cli("e2e", [
        "mine_tpu_torch.tools.e2e_quality_run", "--epochs", str(QUALITY_E2E_EPOCHS),
        "--out", os.path.join(QUALITY_DIR, "e2e")])
    for compositor in ("dense", "streaming"):
        runs[f"oracle_{compositor}"] = background_cli(f"oracle_{compositor}", [
            "mine_tpu_torch.tools.oracle_mpi_ceiling", "--compositor", compositor,
            "--planes", *map(str, QUALITY_PLANES)])
    return runs


def check_convergence(label: str, verdict: dict) -> list[dict]:
    """A convergence run's curve: an eval every QUALITY_EVAL_EVERY steps, a
    finite loss at each, K1 and K2 launched 4 times a step (one render per
    scale) and K1 once more per eval render (3 scenes x 3 poses), no K5."""
    steps = QUALITY_STEPS[label]
    with open(os.path.join(QUALITY_DIR, label, "curve.jsonl")) as fh:
        curve = [json.loads(ln) for ln in fh]
    if [r["step"] for r in curve] != list(range(QUALITY_EVAL_EVERY, steps + 1,
                                                QUALITY_EVAL_EVERY)) \
            or not all(math.isfinite(r["loss"]) and math.isfinite(r["psnr_novel"])
                       for r in curve):
        raise AssertionError(f"quality {label}: curve {curve}")
    want = {"warp_bilinear": 4 * steps + 9 * len(curve), "warp_bilinear_grad": 4 * steps,
            "warp_composite": 0}
    if verdict["launches"] != want:
        raise AssertionError(f"quality {label}: launches {verdict['launches']}, want {want}")
    return curve


def quality_phase(info, dev, runs: dict) -> dict:
    """The quality harnesses' results (their CLIs started by
    start_quality_runs), each held where the port must agree with itself or
    with the CPU, and reported beside the JAX package's figures:
      * the oracle ceiling at S = 8, 16, 32: every row equal to the same row
        computed in this process on the CPU (plain versions) and dense equal
        to streaming (the chunked K1 scan), to 1e-2 dB; the source-pose
        render >= 100 dB;
      * the fp32 convergence run: finite loss at every eval, its launches,
        the median novel-pose PSNR of its last 5 evals >= 16.0 dB and >= the
        median of its first 3 + 1.0 dB;
        its saved model scored again here under the streaming compositor (K5
        once a pose), equal to the run's final score to 1e-2 dB, and K5 on one
        of those poses held against its plain version;
      * the bf16 run: finite loss at every eval, its launches; its gap to the
        fp32 curve at equal steps reported;
      * disocclusion_analysis on the fp32 save: the oracle's keys equal to the
        CPU's (1e-2 dB), the disoccluded pixel share exactly;
      * the end-to-end chain: both CLIs exit 0, held-out val PSNR >= 12.0 dB;
    then, with the CLIs done, feed_vs_inline. Returns the launches of each
    path and K5's inputs for the timing."""
    from mine_tpu_torch.data.synthetic import _intrinsics, _render_view
    from mine_tpu_torch.inference.trajectory import poses_from_offsets
    from mine_tpu_torch.inference.video import predict_blended_mpi
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.ops.mpi_render import streaming_matrices
    from mine_tpu_torch.ops.sampling import fixed_disparity_linspace
    from mine_tpu_torch.tools import convergence_run as qc
    from mine_tpu_torch.tools.disocclusion_analysis import analyse
    from mine_tpu_torch.tools.oracle_mpi_ceiling import SRC_POSE_MIN_DB, oracle_rows

    global CONTENDED
    t_phase = time.perf_counter()
    out = {"launches": {}}
    h = w = 128

    # 1. the oracle ceiling, against the same rows on the CPU
    cpu_rows = oracle_rows(QUALITY_PLANES, h, w, 0.2, "cpu")
    oracle = {c: finish_cli(runs[f"oracle_{c}"]) for c in ("dense", "streaming")}
    gaps = {}
    for c, (verdict, _) in oracle.items():
        rows = verdict["rows"]
        if [(r["planes"], r["variant"]) for r in rows] != \
                [(r["planes"], r["variant"]) for r in cpu_rows]:
            raise AssertionError(f"quality oracle {c}: rows {rows}")
        gaps[f"{c}_vs_cpu"] = max(abs(r[k] - q[k]) for r, q in zip(rows, cpu_rows)
                                  for k in ("psnr_novel", "psnr_src_pose"))
        out["launches"][f"quality_oracle_{c}"] = resident_launches(verdict["launches"])
    gaps["dense_vs_streaming"] = max(
        abs(r[k] - q[k]) for r, q in zip(oracle["dense"][0]["rows"], oracle["streaming"][0]["rows"])
        for k in ("psnr_novel", "psnr_src_pose"))
    src_pose = min(r["psnr_src_pose"] for v, _ in oracle.values() for r in v["rows"])
    if max(gaps.values()) > QUALITY_DB or src_pose < SRC_POSE_MIN_DB:
        raise AssertionError(f"quality oracle: gaps {gaps} dB, source pose {src_pose} dB")
    emit(info, phase="quality", part="oracle_ceiling", planes=list(QUALITY_PLANES),
         rows={c: [{k: r[k] for k in ("planes", "variant", "psnr_novel", "psnr_src_pose")}
                   for r in v["rows"]] for c, (v, _) in oracle.items()},
         gaps_db=gaps, tolerance_db=QUALITY_DB, launches={c: v["launches"]
                                                         for c, (v, _) in oracle.items()},
         seconds={c: s for c, (_, s) in oracle.items()}, jax_reference=JAX_QUALITY["oracle"])

    # 2. the fp32 convergence run, then its save scored again under streaming
    fp32, fp32_s = finish_cli(runs["fp32"])
    curve = check_convergence("fp32", fp32)
    first = curve[0]["psnr_novel"]
    head = statistics.median(r["psnr_novel"] for r in curve[:QUALITY_HEAD])
    tail = statistics.median(r["psnr_novel"] for r in curve[-QUALITY_TAIL:])
    if not (tail >= QUALITY_FP32_MIN_DB and tail >= head + QUALITY_GAIN_DB):
        raise AssertionError(f"quality fp32: median of the last {QUALITY_TAIL} evals {tail} dB, "
                             f"of the first {QUALITY_HEAD} {head} dB: want >= "
                             f"{QUALITY_FP32_MIN_DB} and >= +{QUALITY_GAIN_DB}")
    out["launches"]["quality_fp32"] = resident_launches(fp32["launches"])
    save = os.path.join(QUALITY_DIR, "fp32_final.pt")
    scored = {}
    for compositor in ("dense", "streaming"):
        cfg = qc.build_cfg(h, w, 1, 8, compositor=compositor)
        model = qc.load_model(cfg, save, dev)
        torch.cuda.synchronize()
        kw.reset_launches()
        scored[compositor] = qc.eval_novel_pose_psnr(cfg, model, qc.HELDOUT_PHASES)
        torch.cuda.synchronize()
        scored[compositor]["launches"] = dict(kw.launches)
    n_renders = len(qc.HELDOUT_PHASES) * len(qc.NOVEL_OFFSETS)
    stream_gap = abs(scored["streaming"]["psnr_novel"] - fp32["psnr_novel"])
    if scored["streaming"]["launches"] != {"warp_bilinear": 0, "warp_bilinear_grad": 0,
                                           "warp_composite": n_renders} \
            or stream_gap > QUALITY_DB:
        raise AssertionError(f"quality fp32 under streaming: {scored}, the run's final "
                             f"{fp32['psnr_novel']} dB")
    out["launches"]["quality_eval_streaming"] = resident_launches(scored["streaming"]["launches"])
    out["k5_launches"] = n_renders
    # K5 on the first held-out scene's MPI at the first novel pose
    k_np = _intrinsics(h, w)
    k = torch.from_numpy(k_np)[None].to(dev)
    src, _ = _render_view(h, w, k_np, np.zeros(3), qc.HELDOUT_PHASES[0])
    disparity = fixed_disparity_linspace(1, 8, 1.0, 0.2, dev)
    mpi_rgb, mpi_sigma = predict_blended_mpi(cfg, model, torch.from_numpy(src)[None].to(dev),
                                             disparity, k)
    g = torch.from_numpy(poses_from_offsets(qc.NOVEL_OFFSETS[:1])).to(dev)
    out["k5_in"] = (mpi_rgb.contiguous(), mpi_sigma.contiguous(),
                    *streaming_matrices(disparity, g, inverse_3x3(k), k))
    out["k5_err"] = check_close("warp_composite (quality eval, S=8, 128x128)",
                                kw.warp_composite(*out["k5_in"]),
                                kw.warp_composite_matrix_plain(*out["k5_in"]), **TOL)
    del model
    emit(info, phase="quality", part="convergence_fp32", steps=fp32["steps"],
         final_psnr_novel=fp32["psnr_novel"], psnr_per_pose=fp32["psnr_per_pose"],
         final_loss=fp32["final_loss"], step_100_psnr_novel=first,
         head_median_db=head, tail_median_db=tail, head_evals=QUALITY_HEAD,
         tail_evals=QUALITY_TAIL,
         curve=[[r["step"], r["loss"], r["psnr_novel"]] for r in curve],
         step_ms_median=fp32["step_ms_median"], wall_s=fp32["wall_s"], cli_seconds=fp32_s,
         peak_gb=fp32["peak_gb"], launches=fp32["launches"],
         rescored={c: {"psnr_novel": v["psnr_novel"], "launches": v["launches"]}
                   for c, v in scored.items()},
         streaming_vs_run_db=stream_gap, k5_err=out["k5_err"], tolerance=TOL,
         jax_reference=JAX_QUALITY["convergence"])

    # 3. disocclusion on the fp32 save, its oracle keys against the CPU's
    t0 = time.perf_counter()
    lines = run_cli(["mine_tpu_torch.tools.disocclusion_analysis", "--params", save,
                     "--out", ""]).stdout.strip().splitlines()
    dis_s = time.perf_counter() - t0
    dis = json.loads(lines[-1])
    cpu = analyse(qc.load_model(qc.build_cfg(h, w, 1, 8), save, "cpu"), 8, 0, 18, h, w, 0.2)
    dis_gap = max(abs(dis[k] - cpu[k]) for k in ("oracle_visible", "oracle_disoccluded"))
    if not dis["ok"] or dis_gap > QUALITY_DB \
            or dis["disoccluded_px_frac"] != cpu["disoccluded_px_frac"]:
        raise AssertionError(f"quality disocclusion: card {dis}, cpu {cpu}")
    out["launches"]["quality_disocclusion"] = resident_launches(dis["launches"])
    emit(info, phase="quality", part="disocclusion", planes=8,
         card={k: v for k, v in dis.items() if k not in ("metric", "launches")},
         cpu={k: v for k, v in cpu.items() if k != "metric"}, oracle_gap_db=dis_gap,
         launches=dis["launches"], seconds=dis_s, jax_reference=JAX_QUALITY["disocclusion"])

    # 4. the bf16 run, against the fp32 curve at equal steps
    bf16, bf16_s = finish_cli(runs["bf16"])
    bf16_curve = check_convergence("bf16", bf16)
    out["launches"]["quality_bf16"] = resident_launches(bf16["launches"])
    by_step = {r["step"]: r["psnr_novel"] for r in curve}
    gap = [[r["step"], round(by_step[r["step"]] - r["psnr_novel"], 3)]
           for r in bf16_curve if r["step"] in by_step]
    emit(info, phase="quality", part="convergence_bf16", steps=bf16["steps"],
         final_psnr_novel=bf16["psnr_novel"], final_loss=bf16["final_loss"],
         curve=[[r["step"], r["loss"], r["psnr_novel"]] for r in bf16_curve],
         fp32_minus_bf16_db=gap, step_ms_median=bf16["step_ms_median"], wall_s=bf16["wall_s"],
         cli_seconds=bf16_s, peak_gb=bf16["peak_gb"], launches=bf16["launches"])

    # 5. the end-to-end chain through the train and evaluate CLIs
    e2e, e2e_s = finish_cli(runs["e2e"])
    if not (e2e["train_rc"] == 0 and e2e["eval_rc"] == 0 and e2e["val_psnr"] >= QUALITY_E2E_MIN_DB):
        raise AssertionError(f"quality e2e: {e2e}")
    emit(info, phase="quality", part="e2e", steps=e2e["steps"], val_psnr=e2e["val_psnr"],
         train_rc=e2e["train_rc"], eval_rc=e2e["eval_rc"], train_s=e2e["train_s"],
         eval_s=e2e["eval_s"], cli_seconds=e2e_s,
         eval_metrics={k: e2e["eval_metrics"].get(k) for k in ("psnr_tgt", "loss_ssim_tgt",
                                                               "eval_examples")},
         jax_reference=JAX_QUALITY["e2e"])
    emit(info, phase="quality", part="summary", foreground_seconds=time.perf_counter() - t_phase,
         background_seconds={name: round(time.perf_counter() - r["t0"], 1)
                             for name, r in runs.items()},
         note="the runs' CLIs started before section 4 and ran beside sections 4, 10 and 12")
    CONTENDED = False

    # 6. the harness's step with its batches built inline against batch_feed
    out["launches"]["quality_feed_vs_inline"] = resident_launches(feed_vs_inline(info))
    return out


def feed_vs_inline(info) -> dict:
    """The convergence harness's median step ms (blocks of ARM_BLOCK steps,
    fp32) with each batch built on this process's thread, as the JAX
    harness builds it, against batches from batch_feed's spawned process;
    arms in the order inline, feed, feed, inline, each from fresh weights.
    Returns the arms' launches together."""
    from mine_tpu_torch.tools import convergence_run as qc

    ms, launches = {"inline": [], "feed": []}, {}
    for i, arm in enumerate(("inline", "feed", "feed", "inline")):
        args = qc.parse_args(["--steps", str(ARM_STEPS), "--eval-every", str(ARM_BLOCK),
                              "--out", os.path.join(QUALITY_DIR, f"feed_{i}_{arm}")])
        batches = None if arm == "feed" else (
            qc.synthetic_batch(step, args.batch, args.height, args.width, args.seed)
            for step in range(1, ARM_STEPS + 1))
        verdict = qc.run(args, batches)
        if not verdict["ok"] or verdict["launches"]["warp_bilinear_grad"] != 4 * ARM_STEPS:
            raise AssertionError(f"feed_vs_inline {arm}: {verdict}")
        ms[arm].append(verdict["step_ms_median"])
        for k, n in verdict["launches"].items():
            launches[k] = launches.get(k, 0) + n
    emit(info, phase="quality", part="feed_vs_inline", steps_per_arm=ARM_STEPS,
         block_steps=ARM_BLOCK, step_ms_median=ms,
         inline_over_feed=statistics.mean(ms["inline"]) / statistics.mean(ms["feed"]),
         launches=launches)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.inference.trajectory import camera_trajectories
    from mine_tpu_torch.inference.video import VideoGenerator, render_many
    from mine_tpu_torch.models.mpi import init_weights
    from mine_tpu_torch.ops.geometry import inverse_3x3
    from mine_tpu_torch.ops.kernels import build
    from mine_tpu_torch.ops.kernels import warp as kw
    from mine_tpu_torch.ops.mpi_render import streaming_inputs, streaming_matrices
    from mine_tpu_torch.serving.engine import RenderEngine
    from mine_tpu_torch.training.step import build_model, render_novel_view

    # 1. the card, and no TF32 anywhere
    info = card()
    print(info["nvidia_smi"], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import PIL

    emit(info, phase="setup", torch=torch.__version__, cuda=torch.version.cuda,
         pillow=PIL.__version__, numpy=np.__version__,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # 2. build from the checkout's sources
    t0 = time.perf_counter()
    logs = build.build_all(force=True, ptxas_info=True)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(info, phase="build", seconds=time.perf_counter() - t0, sources=sorted(logs),
         ptxas=ptxas)

    # 3. each kernel against its plain version at the main path's shapes
    h, w, s = 384, 512, 32
    g_test = pose(0.08, -0.04, 0.15)
    k1_src = torch.rand((s, 4, h, w), generator=gen, device=dev)
    k1_cx, k1_cy = plane_coords(h, w, s, g_test, dev, gen)
    k1_err = check_close("warp_bilinear (32,4,384,512)", kw.warp_bilinear(k1_src, k1_cx, k1_cy),
                         kw.warp_bilinear_plain(k1_src, k1_cx, k1_cy), **TOL)
    hb, wb = 756, 1008
    k3_src = torch.rand((1, 4, hb, wb), generator=gen, device=dev)
    k3_cx, k3_cy = plane_coords(hb, wb, 1, g_test, dev, gen)
    k3_err = check_close("warp_bilinear (1,4,756,1008)", kw.warp_bilinear(k3_src, k3_cx, k3_cy),
                         kw.warp_bilinear_plain(k3_src, k3_cx, k3_cy), **TOL)
    # the shapes the streaming backward gives the warp: a chunk of B=4 x 4
    # planes at 384x512, and of B=1 x 4 planes at the 768x1024 recipe's scale
    # 0 (the banded size class)
    chunk_cases = {}
    for label, (nc, hc, wc) in {"stream_chunk": (16, h, w),
                                "highres_chunk": (4, 768, 1024)}.items():
        src_c = torch.rand((nc, 4, hc, wc), generator=gen, device=dev)
        cx_c, cy_c = plane_coords(hc, wc, nc, g_test, dev, gen)
        err = check_close(f"warp_bilinear {tuple(src_c.shape)}",
                          kw.warp_bilinear(src_c, cx_c, cy_c),
                          kw.warp_bilinear_plain(src_c, cx_c, cy_c), **TOL)
        chunk_cases[label] = (src_c, cx_c, cy_c, err)
    # a pose 1.5 units forward puts the planes nearer than that behind the
    # target camera (z < 0): their sigma must be masked
    k_cam = torch.from_numpy(np.array(
        [[w / 2, 0, w / 2], [0, w / 2, h / 2], [0, 0, 1]], np.float32))[None].to(dev)
    disparity = torch.linspace(1.0, 0.001, s, device=dev)[None]
    k5_mpi = (torch.rand((1, s, h, w, 3), generator=gen, device=dev),
              torch.rand((1, s, h, w, 1), generator=gen, device=dev) * 4.0)
    k5_pose = (disparity, torch.from_numpy(pose(0.1, -0.05, -1.5))[None].to(dev),
               inverse_3x3(k_cam), k_cam)
    k5_in = (*k5_mpi, *streaming_matrices(*k5_pose))
    n_behind = int((kw.composite_operands(*k5_in[2:], h, w)[3] < 0).any(dim=(2, 3)).sum())
    if n_behind == 0:
        raise AssertionError("warp_composite check has no plane behind the camera")
    k5_out = kw.warp_composite(*k5_in)
    k5_err = check_close("warp_composite (1,32,384,512)", k5_out,
                         kw.warp_composite_matrix_plain(*k5_in), **TOL)
    # the coordinate form: the dense path's torch prep, then the function the
    # Pallas kernel computes
    k5_coord_err = check_close("warp_composite vs the coordinate form", k5_out,
                               kw.warp_composite_plain(*streaming_inputs(*k5_mpi, *k5_pose)),
                               **TOL)
    emit(info, phase="kernel_check", tolerance=TOL, warp_bilinear_dense_err=k1_err,
         warp_bilinear_756x1008_err=k3_err,
         warp_bilinear_chunk_errs={k: v[3] for k, v in chunk_cases.items()},
         warp_composite_err=k5_err,
         warp_composite_vs_coordinate_form_err=k5_coord_err,
         warp_composite_planes_behind_camera=n_behind)

    # the warp's backward at the training path's scale-0 shape (B=4 x S=32
    # planes) and at the size class of the TPU's banded kernel, both modes
    k2_cases = {}
    for label, (n2, h2, w2) in {"train_scale0": (128, h, w), "756x1008": (1, hb, wb),
                                "stream_chunk": (16, h, w),
                                "highres_chunk": (4, 768, 1024)}.items():
        src2 = torch.rand((n2, 4, h2, w2), generator=gen, device=dev)
        cx2, cy2 = plane_coords(h2, w2, n2, g_test, dev, gen)
        g2 = torch.randn((n2, 4, h2, w2), generator=gen, device=dev)
        k2_cases[label] = (src2, cx2, cy2, g2)
    def path_share(fn) -> dict:
        """The backward kernel's blocks on each path during fn()."""
        before = kw.grad_path_blocks()
        fn()
        after = kw.grad_path_blocks()
        shared, direct = (after[k] - before[k] for k in ("shared", "direct"))
        return {"shared": shared, "direct": direct, "shared_share": shared / (shared + direct)}

    k2_errs = {}
    for label, (src2, cx2, cy2, g2) in k2_cases.items():
        n2, c2, h2, w2 = src2.shape
        for mode, src_arg in (("src_only", None), ("with_coords", src2)):
            got = kw.warp_bilinear_grad(g2, cx2, cy2, h2, w2, src_arg)
            paths = path_share(lambda: kw.warp_bilinear_grad(g2, cx2, cy2, h2, w2, src_arg))
            again = kw.warp_bilinear_grad(g2, cx2, cy2, h2, w2, src_arg)
            want = kw.warp_bilinear_grad_plain(g2, cx2, cy2, h2, w2, src_arg)
            tol = dict(rtol=1e-5, atol=1e-5 * want[0].abs().max().item())
            row = {"grad_src_err": check_close(f"warp_bilinear_grad {label} {mode} grad_src",
                                               got[0], want[0], **tol),
                   "grad_src_tolerance": tol, "blocks_by_path": paths,
                   "run_to_run_max_abs": (got[0] - again[0]).abs().max().item()}
            if src_arg is not None:
                for name, a, b in (("grad_x", got[1], want[1]), ("grad_y", got[2], want[2])):
                    ctol = dict(rtol=1e-5, atol=1e-5 * b.abs().max().item())
                    row[f"{name}_err"] = check_close(f"warp_bilinear_grad {label} {name}",
                                                     a, b, **ctol)
                    row[f"{name}_run_to_run_max_abs"] = (a - again[1 if name == "grad_x" else 2]
                                                         ).abs().max().item()
            k2_errs[f"{label}/{mode}"] = row
            del got, again, want
    emit(info, phase="kernel_check", kernel="warp_bilinear_grad",
         shapes={k: list(v[0].shape) for k, v in k2_cases.items()}, results=k2_errs)

    # 13 (begun). the quality harnesses' CLIs, in the background beside
    # sections 4, 9, 10 and 12
    quality_runs = start_quality_runs()

    # 4. the main path at full width, seeded random weights
    cfg = Config()  # the default configuration: ResNet-50, 384x512, S=32, bf16
    state = init_weights(build_model(cfg), torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    images = [
        np.clip(np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 255
                + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8),
        rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
    ]
    (zoom_name, zoom), (_, swing) = camera_trajectories(cfg.data.name)[0]

    kw.reset_launches()
    engine = RenderEngine(cfg, state)
    entries = [engine.predict(im) for im in images]
    for e in entries:
        if e.mpi_rgb.shape != (1, s, h, w, 3) or not bool(torch.isfinite(e.mpi_rgb).all()) \
                or not bool(torch.isfinite(e.mpi_sigma).all()):
            raise AssertionError(f"predict gave a bad MPI {tuple(e.mpi_rgb.shape)}")
    renders, padded_frames = [], 0
    for entry, poses, padded in ((entries[0], swing[:1], 1), (entries[1], swing[:5], 8),
                                 (entries[0], zoom, 96)):
        before = kw.launches["warp_composite"]
        rgb, disp = engine.render(entry, poses)
        launched = kw.launches["warp_composite"] - before
        if launched != padded:
            raise AssertionError(f"{len(poses)} poses launched warp_composite {launched} "
                                 f"times, expected the padded {padded}")
        if rgb.shape != (len(poses), h, w, 3) or disp.shape != (len(poses), h, w, 1) \
                or not np.isfinite(rgb).all() or not np.isfinite(disp).all():
            raise AssertionError(f"render of {len(poses)} poses: bad output {rgb.shape}")
        renders.append(len(poses))
        padded_frames += padded
    before = kw.launches["warp_bilinear"]
    video = VideoGenerator(cfg.replace(**{"mpi.compositor": "dense"}), state, images[0])
    v_rgb, v_disp = video.render_poses(zoom)
    if kw.launches["warp_bilinear"] - before != len(zoom) or not np.isfinite(v_rgb).all() \
            or not np.isfinite(v_disp).all() or v_rgb.shape != (len(zoom), h, w, 3):
        raise AssertionError("VideoGenerator (dense) did not render through warp_bilinear")
    torch.cuda.synchronize()
    main_launches = dict(kw.launches)
    serve_kernels = ("warp_bilinear", "warp_composite")
    if not all(main_launches[k] for k in serve_kernels):
        raise AssertionError(f"a kernel of the serving path never launched: {main_launches}")
    # launches per rendered frame, from the counts: streaming frames are the
    # padded pose buckets the engine ran, dense frames the video's poses
    launches_per_frame = {
        "warp_composite": main_launches["warp_composite"] / padded_frames,
        "warp_bilinear (dense)": main_launches["warp_bilinear"] / len(zoom),
    }
    emit(info, phase="main_path", config="default (resnet50, 384x512, S=32, bf16)",
         renders=renders, video_trajectory=zoom_name, launches=main_launches,
         launches_per_frame=launches_per_frame)

    # dense (warp_bilinear) and streaming (warp_composite) on one MPI and pose
    e = entries[0]
    k_inv = inverse_3x3(e.k)
    g1 = torch.from_numpy(zoom[20])[None].to(dev)
    outs = {
        name: render_novel_view(cfg.replace(**{"mpi.compositor": name}), e.mpi_rgb,
                                e.mpi_sigma, e.disparity, g1, k_inv, e.k)
        for name in ("dense", "streaming")
    }
    agree = {}
    for key in ("tgt_imgs_syn", "tgt_disparity_syn", "tgt_mask_syn"):
        agree[key] = check_close(f"dense vs streaming {key}", outs["streaming"][key],
                                 outs["dense"][key], rtol=1e-4, atol=1e-4)
    # a streaming frame allocates its (1, 7, H, W) accumulators and B*S tiny
    # matrices: far less than one (S, H, W) fp32 coordinate, dist or z array
    del outs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    frame = render_novel_view(cfg.replace(**{"mpi.compositor": "streaming"}), e.mpi_rgb,
                              e.mpi_sigma, e.disparity, g1, k_inv, e.k)
    torch.cuda.synchronize()
    frame_alloc = torch.cuda.max_memory_allocated() - base
    del frame
    if frame_alloc >= s * h * w * 4:
        raise AssertionError(f"a streaming frame allocated {frame_alloc} bytes, as much as "
                             f"an (S, H, W) fp32 array ({s * h * w * 4})")

    # the whole path on the card against the same path on the CPU, small
    small = Config().replace(**{"data.img_h": 128, "data.img_w": 128, "mpi.num_bins_coarse": 4,
                                "model.num_layers": 18, "model.dtype": "float32"})
    small_state = init_weights(build_model(small), torch.Generator().manual_seed(1)).state_dict()
    small_poses = swing[:3]
    small_out = {}
    for where in ("cuda", "cpu"):
        eng = RenderEngine(small, small_state, device=where)
        small_out[where] = eng.render(eng.predict(images[1]), small_poses)
    cpu_gap = {
        name: float(np.abs(small_out["cuda"][i] - small_out["cpu"][i]).max())
        for i, name in enumerate(("rgb", "disparity"))
    }
    if not (np.allclose(small_out["cuda"][0], small_out["cpu"][0], atol=1e-3)
            and np.allclose(small_out["cuda"][1], small_out["cpu"][1], rtol=1e-3, atol=1e-5)):
        raise AssertionError(f"small config: card and CPU disagree {cpu_gap}")
    emit(info, phase="agreement", dense_vs_streaming_max_abs=agree,
         card_vs_cpu_small_max_abs=cpu_gap, streaming_frame_peak_alloc_bytes=frame_alloc,
         one_shw_fp32_array_bytes=s * h * w * 4)

    # 10. the parallel path: two ranks of a torchrun job sharing the card, run
    # here, while this process holds little of the card's memory
    import shutil

    g1 = torch.from_numpy(zoom[20])[None].to(dev)
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    # 12. (with 10) the coarse-to-fine one-process reference, then the
    # parallel phase, whose one torchrun launch also runs section 12's
    # two-rank training runs; then their checks and coarse-to-fine serving
    c2f_ref = coarse_to_fine_reference(info)
    par = parallel_phase(info, dev, entries[0], g1, section12_segments())
    preempt = preempt_phase(info, par)
    sharded = sharded_state_phase(info, par)
    warm = warm_start_phase(info, os.path.join(PARALLEL_DIR, "zero1_data2_fp32"))
    c2f_train = coarse_to_fine_train(info, par, c2f_ref)
    c2f_serve = coarse_to_fine_serve(info, dev, state, images[0], g1, swing[:4])

    # 13. the quality harnesses' results; nothing runs in the background after it
    quality = quality_phase(info, dev, quality_runs)

    # 5. the training path at full width: Trainer.fit on synthetic batches
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.training.loop import Trainer

    train_cfg = Config().replace(**{"data.name": "synthetic"})  # the default, B=4
    train_state = init_weights(build_model(train_cfg),
                               torch.Generator().manual_seed(2)).state_dict()
    train_steps = 3
    for batch_size in (4, 2, 1):  # the largest batch that fits the card
        try:
            cfg_b = train_cfg.replace(**{"data.per_gpu_batch_size": batch_size})
            trainer = Trainer(cfg_b, state_dict=train_state)
            train_ds = build_dataset(cfg_b, "train", batch_size)
            before = {name: [p.detach().clone() for p in
                             getattr(trainer.model, name).parameters()][:4]
                      for name in ("backbone", "decoder")}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kw.reset_launches()
            logged = trainer.fit(train_ds, max_steps=train_steps)
            torch.cuda.synchronize()
            train_launches = dict(kw.launches)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            break
        except torch.cuda.OutOfMemoryError as exc:
            emit(info, phase="train_path", batch_size=batch_size, fits=False,
                 peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                 error=str(exc)[:300])
            trainer = None
            torch.cuda.empty_cache()
    else:
        raise AssertionError("train path: not even B=1 fits the card")
    moved = {name: max((p.detach() - q).abs().max().item() for p, q in
                       zip(getattr(trainer.model, name).parameters(), params))
             for name, params in before.items()}
    per_step = {k: v / train_steps for k, v in train_launches.items()}
    if not (math.isfinite(logged["loss"]) and math.isfinite(logged["grad_norm"])):
        raise AssertionError(f"train path: non-finite loss or grad_norm {logged}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train path: a parameter group did not move {moved}")
    if per_step["warp_bilinear"] != 4 or per_step["warp_bilinear_grad"] != 4:
        raise AssertionError(f"train path: expected 4 warp and 4 warp-backward launches "
                             f"a step (one render per scale), got {per_step}")
    emit(info, phase="train_path",
         config="default (resnet50, 384x512, S=32, bf16, dense, stratified)",
         batch_size=batch_size, fits=True, steps=train_steps, loss=logged["loss"],
         grad_norm=logged["grad_norm"], params_moved_max_abs=moved, launches=train_launches,
         launches_per_step=per_step, peak_allocated_gb=peak_gb)

    # the first step's gradient from the same weights, batch and disparity
    # draws, twice through the backward kernel and once through its plain
    # version (WarpBilinear's backward swapped for warp_bilinear_grad_plain):
    # the kernel must move the gradient no further from the plain scatter
    # than two of its own runs lie apart, which is the order of the atomics
    # (the kernel's, cuDNN's and torch's scatters)
    def first_step(cfg_run):
        tr = Trainer(cfg_run, state_dict=train_state)
        out = tr.fit(build_dataset(cfg_run, "train", batch_size), max_steps=1)
        return out["loss"], {n: p.grad.detach().clone()
                             for n, p in tr.model.named_parameters() if p.grad is not None}

    # the first run also keeps the scale-0 render's backward operands (the
    # cotangent and the sample coordinates of B*S planes at 384x512) for the
    # backward kernel's timing on the training path's own data
    kernel_grad, captured = kw.warp_bilinear_grad, {}

    def capture_scale0(g_, cx_, cy_, hh, ww, src_=None):
        if (hh, ww) == (h, w) and not captured:
            captured.update(g=g_.clone(), cx=cx_.clone(), cy=cy_.clone())
        return kernel_grad(g_, cx_, cy_, hh, ww, src_)

    kw.warp_bilinear_grad = capture_scale0
    try:
        first = {"kernel_a": first_step(cfg_b)}
    finally:
        kw.warp_bilinear_grad = kernel_grad
    if not captured:
        raise AssertionError("the first train step ran no scale-0 warp backward")
    first["kernel_b"] = first_step(cfg_b)
    before = kw.launches["warp_bilinear_grad"]
    kw.warp_bilinear_grad = kw.warp_bilinear_grad_plain
    try:
        first["plain"] = first_step(cfg_b)
    finally:
        kw.warp_bilinear_grad = kernel_grad
    if kw.launches["warp_bilinear_grad"] != before:
        raise AssertionError("the plain-backward step launched the backward kernel")

    def grad_gaps(a: dict, b: dict) -> dict:
        floor = 1e-4 * max(v.norm().item() for v in b.values())
        leaf = max((a[k] - b[k]).norm().item() / max(b[k].norm().item(), floor) for k in b)
        total = torch.nn.utils.get_total_norm(list(b.values())).item()
        diff = torch.nn.utils.get_total_norm([a[k] - b[k] for k in b]).item()
        return {"max_leaf_rel": leaf, "global_rel": diff / total}

    first_gaps = {f"{x}~{y}": grad_gaps(first[x][1], first[y][1])
                  for x, y in (("kernel_a", "kernel_b"), ("kernel_a", "plain"),
                               ("kernel_b", "plain"))}
    losses = [v[0] for v in first.values()]
    if max(losses) - min(losses) > 1e-6 * abs(losses[0]):
        raise AssertionError(f"first step: the forward does not repeat {losses}")
    # the gaps are norms over ~10^7 values, so two samples of the same noise
    # lie close together (within 2 % of each other on the H100); 3x is a fault
    for metric, own in first_gaps["kernel_a~kernel_b"].items():
        if first_gaps["kernel_a~plain"][metric] > 3.0 * own:
            raise AssertionError(f"first step: the kernel's gradient is further from the "
                                 f"plain backward's than its own runs lie apart {first_gaps}")
    emit(info, phase="train_first_step", batch_size=batch_size,
         loss={k: v[0] for k, v in first.items()},
         grad_norm={k: torch.nn.utils.get_total_norm(list(v[1].values())).item()
                    for k, v in first.items()}, gaps=first_gaps)
    del first

    # the same 3 steps again, twice with Adam and twice with sgd: how far
    # the gradient norm repeats once the order noise has passed through
    # updates (Adam's first ones are lr * sign(g) whatever |g|; sgd's lr * g)
    import tempfile

    repeats = {}
    for opt_name in ("adam", "sgd"):
        cfg_r = cfg_b.replace(**{"training.optimizer": opt_name, "training.log_interval": 1})
        runs = []
        for _ in range(2):
            with tempfile.TemporaryDirectory() as ws:
                Trainer(cfg_r, workspace=ws, state_dict=train_state).fit(
                    build_dataset(cfg_r, "train", batch_size), max_steps=train_steps)
                with open(os.path.join(ws, "train_log.jsonl")) as fh:
                    runs.append([json.loads(ln) for ln in fh])
        norms = [[ln["grad_norm"] for ln in run] for run in runs]
        repeats[opt_name] = {
            "grad_norm": norms, "loss": [[ln["loss"] for ln in run] for run in runs],
            "grad_norm_rel_diff_per_step": [abs(a / b - 1.0) for a, b in zip(*norms)],
        }
    emit(info, phase="train_repeat", batch_size=batch_size, steps=train_steps,
         main_path_grad_norm=logged["grad_norm"], runs=repeats)

    # one train step of a small configuration on the card against the CPU
    small_train = small.replace(**{"data.name": "synthetic", "data.per_gpu_batch_size": 2,
                                   "data.visible_point_count": 32})
    small_train_state = init_weights(build_model(small_train),
                                     torch.Generator().manual_seed(3)).state_dict()
    step_out = {}
    for where in ("cuda", "cpu"):  # the same first batch, weights and disparity draws
        tr = Trainer(small_train, device=where, state_dict=small_train_state)
        out = tr.fit(build_dataset(small_train, "train", 2), max_steps=1)
        norms = {name: torch.nn.utils.get_total_norm(
            [p.grad for p in getattr(tr.model, name).parameters()]).item()
            for name in ("backbone", "decoder")}
        step_out[where] = (out["loss"], norms)
    loss_gap = abs(step_out["cuda"][0] / step_out["cpu"][0] - 1.0)
    norm_gap = {name: abs(step_out["cuda"][1][name] / step_out["cpu"][1][name] - 1.0)
                for name in ("backbone", "decoder")}
    if loss_gap > 1e-4 or max(norm_gap.values()) > 1e-3:
        raise AssertionError(f"small train step: card and CPU disagree, loss rel {loss_gap}, "
                             f"gradient norms rel {norm_gap}")
    emit(info, phase="train_agreement", config="128x128, S=4, resnet18, fp32, TF32 off, B=2",
         loss={"cuda": step_out["cuda"][0], "cpu": step_out["cpu"][0], "rel": loss_gap},
         grad_norms={"cuda": step_out["cuda"][1], "cpu": step_out["cpu"][1], "rel": norm_gap})

    # 6. the streaming compositor's training path
    streaming = streaming_phases(info, dev, gen, h, w, s, train_cfg, train_state, batch_size,
                                 trainer, train_ds)

    # 7. training from the datasets' own formats
    data_launches, llff_ws = data_phases(info, dev, train_state)

    # 8. serving that workspace over HTTP, then a fleet of it
    serve = serve_phases(info, dev, llff_ws, images)
    fleet = serve_fleet_phase(info, dev, llff_ws, images[0])

    # 9. observability and resilience of training and serving
    obs = obs_resilience_phase(info, dev, train_cfg, train_state, llff_ws, images[0])

    # 11. timings
    def grid_of(cx, cy, hh, ww):
        return torch.stack([(cx + 0.5) / (0.5 * ww) - 1.0, (cy + 0.5) / (0.5 * hh) - 1.0], -1)

    def grid_sample(src, grid):
        return torch.nn.functional.grid_sample(
            src, grid, mode="bilinear", padding_mode="border", align_corners=False)

    kernels = []
    k1_grid = grid_of(k1_cx, k1_cy, h, w)
    k3_grid = grid_of(k3_cx, k3_cy, hb, wb)
    warp_rows = {}
    for label, (src, cx, cy, grid) in {
        "dense": (k1_src, k1_cx, k1_cy, k1_grid),
        "756x1008": (k3_src, k3_cx, k3_cy, k3_grid),
        **{label: (src_c, cx_c, cy_c, grid_of(cx_c, cy_c, *src_c.shape[2:]))
           for label, (src_c, cx_c, cy_c, _) in chunk_cases.items()},
    }.items():
        n, c = src.shape[:2]
        n_pix = cx.numel()
        b_ms, b_by = bound_ms(nbytes(src, cx, cy) + n_pix * c * 4, n_pix * (9 * c + 12))
        lib_gap = (grid_sample(src, grid) - kw.warp_bilinear(src, cx, cy)).abs().max().item()
        warp_rows[label] = dict(
            shape=list(src.shape), out=list(cx.shape),
            ms=time_cuda_ms(lambda: kw.warp_bilinear(src, cx, cy)),
            plain_ms=time_cuda_ms(lambda: kw.warp_bilinear_plain(src, cx, cy), reps=5, inner=1),
            library_ms=time_cuda_ms(lambda: grid_sample(src, grid)),
            bound_ms=b_ms, bound_by=b_by, library_max_abs_diff=lib_gap,
        )
        emit(info, phase="timing", kernel="warp_bilinear", case=label, **warp_rows[label])
    # K1 against grid_sample in turns, 5 windows each: the spread of the
    # reading behind the roofline share and the library comparison
    spread = {"ms": [], "library_ms": []}
    for _ in range(5):
        spread["ms"].append(time_cuda_ms(lambda: kw.warp_bilinear(k1_src, k1_cx, k1_cy)))
        spread["library_ms"].append(time_cuda_ms(lambda: grid_sample(k1_src, k1_grid)))
    emit(info, phase="timing", kernel="warp_bilinear", case="dense_in_turns",
         shape=list(k1_src.shape), bound_ms=warp_rows["dense"]["bound_ms"],
         median={k: statistics.median(v) for k, v in spread.items()}, runs=spread,
         share_of_bound=warp_rows["dense"]["bound_ms"] / statistics.median(spread["ms"]))
    paths = {**streaming["launches"], **data_launches, **serve["launches"],
             **fleet["launches"], **obs["launches"], **par["launches"],
             **sharded["launches"], **preempt["launches"], **warm["launches"],
             **c2f_train["launches"], **c2f_serve["launches"], **quality["launches"]}

    def launches_of(name: str, size_class: str) -> dict:
        """The launches of `name` at one TPU size class on each main path: the
        serving and dense-training paths run 384x512 sources only."""
        by_path = {}
        if size_class == "resident" or name == "warp_composite":
            by_path["serve"] = main_launches[name]
            by_path["train_dense"] = train_launches[name]
        for path, counts in paths.items():
            by_path[path] = (counts["kernels"][name] if name == "warp_composite"
                             else counts["sizes"][name][size_class] if "sizes" in counts
                             else counts["kernels"][name])
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    # K3's row is timed at the shape its main path (the 768x1024 recipe) gives it
    for label, replaces, err in (("dense", "mine_tpu/ops/pallas/warp.py:365", k1_err),
                                 ("highres_chunk", "mine_tpu/ops/pallas/warp.py:552",
                                  chunk_cases["highres_chunk"][3])):
        row = warp_rows[label]
        kernels.append(dict(
            name="warp_bilinear" if label == "dense" else "warp_bilinear (banded size class)",
            route="cuda", source="mine_tpu_torch/csrc/warp.cu", replaces=replaces,
            shape=row["shape"],
            **launches_of("warp_bilinear", "resident" if label == "dense" else "banded"),
            max_abs_err=err, ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
        ))

    # bytes: the MPI read once, the matrices, the (N, 7, H, W) output written
    # once; operations per plane pixel: the coordinates, xyz and distance
    # (~40), the 4-channel bilinear sample (36) and the composite (~20)
    n5, s5 = k5_in[0].shape[:2]
    plane_pix = n5 * s5 * h * w
    b_ms, b_by = bound_ms(nbytes(*k5_in) + nbytes(k5_out), plane_pix * 96)
    k5_row = dict(
        shape={"mpi_rgb": list(k5_in[0].shape), "mpi_sigma": list(k5_in[1].shape)},
        ms=time_cuda_ms(lambda: kw.warp_composite(*k5_in)),
        plain_ms=time_cuda_ms(lambda: kw.warp_composite_matrix_plain(*k5_in), reps=5, inner=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes(*k5_in, k5_out),
    )
    emit(info, phase="timing", kernel="warp_composite", case="streaming", **k5_row)
    kernels.append(dict(
        name="warp_composite", route="cuda", source="mine_tpu_torch/csrc/warp_composite.cu",
        replaces="mine_tpu/ops/pallas/warp.py:689", shape=k5_row["shape"],
        **launches_of("warp_composite", "all"),
        max_abs_err=k5_err, ms=k5_row["ms"], plain_ms=k5_row["plain_ms"],
        bound_ms=k5_row["bound_ms"], bound_by=k5_row["bound_by"], library_ms=None,
    ))
    # K5 with a halo plane, on a plane shard's real inputs (the front half of
    # the served MPI); its launches are rank 0's of the plane=2 streaming run
    kh_in = par["k5_halo"]
    kh_out = kw.warp_composite(*kh_in)
    plane_pix = kh_in[0][..., 0].numel()
    b_ms, b_by = bound_ms(nbytes(*kh_in) + nbytes(kh_out), plane_pix * 96)
    kh_row = dict(
        shape={"mpi_rgb": list(kh_in[0].shape), "h_src_tgt": list(kh_in[2].shape)},
        ms=time_cuda_ms(lambda: kw.warp_composite(*kh_in)),
        plain_ms=time_cuda_ms(lambda: kw.warp_composite_matrix_plain(*kh_in), reps=5, inner=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=par["k5_halo_err"],
    )
    emit(info, phase="timing", kernel="warp_composite", case="plane shard with halo", **kh_row)
    kernels.append(dict(
        name=f"warp_composite (plane shard with halo, S={kh_in[0].shape[1]})", route="cuda",
        source="mine_tpu_torch/csrc/warp_composite.cu",
        replaces="mine_tpu/ops/pallas/warp.py:689", shape=kh_row["shape"],
        launches=par["k5_halo_launches"],
        launches_by_path={"parallel_plane2_streaming_fp32 rank 0": par["k5_halo_launches"]},
        max_abs_err=kh_row["max_abs_err"], ms=kh_row["ms"], plain_ms=kh_row["plain_ms"],
        bound_ms=kh_row["bound_ms"], bound_by=kh_row["bound_by"], library_ms=None,
    ))
    del kh_in, kh_out
    # K5 at the 768x1024, S=128 recipe's size, held against its plain version
    k5h = streaming["k5_highres"]
    k5h_out = kw.warp_composite(*k5h)
    k5h_err = check_close(f"warp_composite {tuple(k5h[0].shape)}", k5h_out,
                          kw.warp_composite_matrix_plain(*k5h), **TOL)
    b_ms, b_by = bound_ms(nbytes(*k5h) + nbytes(k5h_out), k5h[0][..., 0].numel() * 96)
    k5h_row = dict(
        shape={"mpi_rgb": list(k5h[0].shape), "mpi_sigma": list(k5h[1].shape)},
        ms=time_cuda_ms(lambda: kw.warp_composite(*k5h)),
        plain_ms=time_cuda_ms(lambda: kw.warp_composite_matrix_plain(*k5h), reps=3, inner=1,
                              warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes(*k5h, k5h_out),
        max_abs_err=k5h_err,
    )
    emit(info, phase="timing", kernel="warp_composite", case="highres", **k5h_row)
    kernels.append(dict(
        name="warp_composite (S=128, 768x1024)", route="cuda",
        source="mine_tpu_torch/csrc/warp_composite.cu",
        replaces="mine_tpu/ops/pallas/warp.py:689", shape=k5h_row["shape"],
        launches=paths["train_highres"]["kernels"]["warp_composite"],
        launches_by_path={"train_highres": paths["train_highres"]["kernels"]["warp_composite"]},
        max_abs_err=k5h_err, ms=k5h_row["ms"], plain_ms=k5h_row["plain_ms"],
        bound_ms=k5h_row["bound_ms"], bound_by=k5h_row["bound_by"], library_ms=None,
    ))
    del k5h, k5h_out
    # K5 at S=64 on a coarse-to-fine served entry's inputs (32 + 32 planes)
    k5c = c2f_serve["k5_in"]
    k5c_out = kw.warp_composite(*k5c)
    b_ms, b_by = bound_ms(nbytes(*k5c) + nbytes(k5c_out), k5c[0][..., 0].numel() * 96)
    k5c_row = dict(
        shape={"mpi_rgb": list(k5c[0].shape), "mpi_sigma": list(k5c[1].shape)},
        ms=time_cuda_ms(lambda: kw.warp_composite(*k5c)),
        plain_ms=time_cuda_ms(lambda: kw.warp_composite_matrix_plain(*k5c), reps=5, inner=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes(*k5c, k5c_out),
        max_abs_err=c2f_serve["k5_err"],
    )
    emit(info, phase="timing", kernel="warp_composite", case="coarse_to_fine S=64", **k5c_row)
    kernels.append(dict(
        name=f"warp_composite (coarse-to-fine, S={k5c[0].shape[1]})", route="cuda",
        source="mine_tpu_torch/csrc/warp_composite.cu",
        replaces="mine_tpu/ops/pallas/warp.py:689", shape=k5c_row["shape"],
        launches=c2f_serve["k5_launches"],
        launches_by_path={"c2f_serve": c2f_serve["k5_launches"]},
        max_abs_err=k5c_row["max_abs_err"], ms=k5c_row["ms"], plain_ms=k5c_row["plain_ms"],
        bound_ms=k5c_row["bound_ms"], bound_by=k5c_row["bound_by"], library_ms=None,
    ))
    del k5c, k5c_out
    # K5 at S=8, 128x128 on a trained model's MPI (the quality phase's eval)
    k5q = quality["k5_in"]
    k5q_out = kw.warp_composite(*k5q)
    b_ms, b_by = bound_ms(nbytes(*k5q) + nbytes(k5q_out), k5q[0][..., 0].numel() * 96)
    k5q_row = dict(
        shape={"mpi_rgb": list(k5q[0].shape), "mpi_sigma": list(k5q[1].shape)},
        ms=time_cuda_ms(lambda: kw.warp_composite(*k5q)),
        plain_ms=time_cuda_ms(lambda: kw.warp_composite_matrix_plain(*k5q), reps=5, inner=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes(*k5q, k5q_out),
        max_abs_err=quality["k5_err"],
    )
    emit(info, phase="timing", kernel="warp_composite", case="quality eval S=8", **k5q_row)
    kernels.append(dict(
        name="warp_composite (quality eval, S=8, 128x128)", route="cuda",
        source="mine_tpu_torch/csrc/warp_composite.cu",
        replaces="mine_tpu/ops/pallas/warp.py:689", shape=k5q_row["shape"],
        launches=quality["k5_launches"],
        launches_by_path={"quality_eval_streaming": quality["k5_launches"]},
        max_abs_err=k5q_row["max_abs_err"], ms=k5q_row["ms"], plain_ms=k5q_row["plain_ms"],
        bound_ms=k5q_row["bound_ms"], bound_by=k5q_row["bound_by"], library_ms=None,
    ))
    del k5q, k5q_out
    # K5 at every plane count the HTTP server ran it at (the pruned plane
    # buckets among them), on the inputs of a real /render at that count
    for s_planes, ops in sorted(serve["k5_inputs"].items()):
        out5 = kw.warp_composite(*ops)
        b_ms, b_by = bound_ms(nbytes(*ops) + nbytes(out5), ops[0][..., 0].numel() * 96)
        row = dict(
            shape={"mpi_rgb": list(ops[0].shape), "mpi_sigma": list(ops[1].shape)},
            ms=time_cuda_ms(lambda: kw.warp_composite(*ops)),
            plain_ms=time_cuda_ms(lambda: kw.warp_composite_matrix_plain(*ops), reps=5,
                                  inner=1),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=serve["k5_errs"][s_planes],
        )
        emit(info, phase="timing", kernel="warp_composite", case=f"serve_http S={s_planes}",
             **row)
        kernels.append(dict(
            name=f"warp_composite (serve_http, S={s_planes})", route="cuda",
            source="mine_tpu_torch/csrc/warp_composite.cu",
            replaces="mine_tpu/ops/pallas/warp.py:689", shape=row["shape"],
            launches=serve["k5_by_planes"][s_planes],
            launches_by_path={"serve_http": serve["k5_by_planes"][s_planes]},
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
        ))
        del out5

    # the first train step's own scale-0 operands, checked like the others
    k2_cases["train_step_captured"] = (k2_cases["train_scale0"][0][:captured["g"].shape[0]],
                                       captured["cx"], captured["cy"], captured["g"])
    src2, cx2, cy2, g2 = k2_cases["train_step_captured"]
    want = kw.warp_bilinear_grad_plain(g2, cx2, cy2, h, w)[0]
    captured_err = check_close(
        "warp_bilinear_grad on the train step's operands", kw.warp_bilinear_grad(
            g2, cx2, cy2, h, w)[0], want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    del want
    emit(info, phase="kernel_check", kernel="warp_bilinear_grad", case="train_step_captured",
         shape=list(g2.shape), grad_src_err=captured_err,
         blocks_by_path=path_share(lambda: kw.warp_bilinear_grad(g2, cx2, cy2, h, w)))

    k2_rows = {}
    for label, mode in (("train_scale0", "src_only"), ("train_scale0", "with_coords"),
                        ("train_step_captured", "src_only"), ("756x1008", "src_only"),
                        ("stream_chunk", "src_only"), ("highres_chunk", "src_only")):
        src2, cx2, cy2, g2 = k2_cases[label]
        n2, c2, h2, w2 = src2.shape
        src_arg = src2 if mode == "with_coords" else None
        n_pix = cx2.numel()
        moved_bytes = nbytes(cx2, cy2, g2) + nbytes(src2)  # grad_src written once
        flops = n_pix * (20 + 8 * c2)
        if src_arg is not None:
            moved_bytes += nbytes(src2) + 2 * n_pix * 4  # src read, grad_x/grad_y written
            flops += n_pix * 12 * c2
        b_ms, b_by = bound_ms(moved_bytes, flops)
        lib_src = src2.clone().requires_grad_()
        lib_grid = grid_of(cx2, cy2, h2, w2).requires_grad_(src_arg is not None)
        lib_out = grid_sample(lib_src, lib_grid)
        lib_inputs = (lib_src,) if src_arg is None else (lib_src, lib_grid)
        row = dict(
            shape=list(src2.shape),
            ms=time_cuda_ms(lambda: kw.warp_bilinear_grad(g2, cx2, cy2, h2, w2, src_arg)),
            plain_ms=time_cuda_ms(
                lambda: kw.warp_bilinear_grad_plain(g2, cx2, cy2, h2, w2, src_arg),
                reps=5, inner=1),
            library_ms=time_cuda_ms(lambda: torch.autograd.grad(
                lib_out, lib_inputs, g2, retain_graph=True)),
            bound_ms=b_ms, bound_by=b_by,
            blocks_by_path=path_share(
                lambda: kw.warp_bilinear_grad(g2, cx2, cy2, h2, w2, src_arg)),
        )
        k2_rows[label, mode] = row
        del lib_out
        emit(info, phase="timing", kernel="warp_bilinear_grad", case=f"{label}/{mode}", **row)
    for label, replaces in (("train_scale0", "mine_tpu/ops/pallas/warp.py:741"),
                            ("highres_chunk", "mine_tpu/ops/pallas/warp.py:585")):
        row = k2_rows[label, "src_only"]
        kernels.append(dict(
            name="warp_bilinear_grad" if label == "train_scale0"
            else "warp_bilinear_grad (banded size class)",
            route="cuda", source="mine_tpu_torch/csrc/warp_grad.cu", replaces=replaces,
            shape=row["shape"],
            **launches_of("warp_bilinear_grad",
                          "resident" if label == "train_scale0" else "banded"),
            max_abs_err=k2_errs[f"{label}/src_only"]["grad_src_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            blocks_by_path=row["blocks_by_path"],
        ))

    predict_ms = host_ms(lambda: engine.predict(images[0]), reps=5)
    render_ms = host_ms(lambda: engine.render(entries[0], zoom[:64]), reps=3) / 64
    dense_ms = host_ms(lambda: video.render_poses(zoom[:16]), reps=3) / 16
    emit(info, phase="timing", engine="streaming", predict_ms=predict_ms,
         render_ms_per_frame=render_ms, dense_render_ms_per_frame=dense_ms,
         launches_per_frame=launches_per_frame)

    # the frames' copy to host: each compositor's own 8 stacked frames (the
    # tensors RenderEngine.render and VideoGenerator.render_poses copy), their
    # layout, and the copy timed alone, the two alternated, into fresh
    # pageable memory (as both entry points copy) and into one pinned buffer
    poses8 = torch.from_numpy(np.asarray(zoom[:8], np.float32)).to(dev)
    stacked = {
        name: render_many(cfg.replace(**{"mpi.compositor": name}), e.mpi_rgb,
                          e.mpi_sigma, e.disparity, e.k, poses8)
        for name in ("streaming", "dense")
    }
    pinned = {name: [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in frames]
              for name, frames in stacked.items()}
    copy_ms = {(name, kind): [] for name in stacked for kind in ("pageable", "pinned")}
    for rep in range(10):
        for name in ("streaming", "dense") if rep % 2 == 0 else ("dense", "streaming"):
            for kind in ("pageable", "pinned"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for src, buf in zip(stacked[name], pinned[name]):
                    if kind == "pageable":
                        src.cpu().numpy()
                    else:
                        buf.copy_(src)
                torch.cuda.synchronize()
                copy_ms[name, kind].append((time.perf_counter() - t) * 1e3 / 8)
    emit(info, phase="host_copy", frames=8, bytes_per_frame=sum(
        t[0].numel() * t.element_size() for t in stacked["streaming"]),
        layout={name: [{"shape": list(t.shape), "stride": list(t.stride()),
                        "contiguous": t.is_contiguous()} for t in frames]
                for name, frames in stacked.items()},
        ms_per_frame={f"{name}_{kind}": statistics.median(v)
                      for (name, kind), v in copy_ms.items()})

    timed_batches = list(itertools.islice(train_ds.epoch(2), 7))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in timed_batches[:2]:  # warm-up
        trainer.step(batch)
    step_ms = statistics.median(host_ms(lambda b=b: trainer.step(b), reps=1)
                                for b in timed_batches[2:])
    emit(info, phase="timing", path="train_step", batch_size=batch_size,
         train_step_ms=step_ms, images_per_s=batch_size / (step_ms / 1e3),
         peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(info, phase="profile", path="train_step", batch_size=batch_size,
         **profile_breakdown(lambda: trainer.step(timed_batches[0]), 1))

    def coordinate_form_prep():
        """Per pose, the coordinate-form operands (streaming_inputs): the
        (S, H, W) coordinate, dist and z arrays and the payload re-layout
        that the streaming render no longer makes."""
        for g8 in poses8:
            streaming_inputs(e.mpi_rgb, e.mpi_sigma, e.disparity, g8[None], k_inv, e.k)

    for label, fn, frames in (("predict", lambda: engine.predict(images[0]), 1),
                              ("render_streaming", lambda: engine.render(entries[0], zoom[:8]), 8),
                              ("render_dense", lambda: video.render_poses(zoom[:8]), 8),
                              ("coordinate_form_prep", coordinate_form_prep, 8)):
        emit(info, phase="profile", path=label, **profile_breakdown(fn, frames))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--train-rank":
        sys.exit(train_rank_main(sys.argv[2]))
    try:
        sys.exit(main())
    finally:
        stop_background()
