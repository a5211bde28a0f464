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
     width; the 768x1024, S=128, B=1 recipe with remat (llff_highres.yaml),
     whose scale-0 warps are the size class of the TPU's banded kernels;
  7. times every kernel (CUDA events), its plain version and, for the warp
     and its backward, torch's grid_sample, beside each kernel's memory
     bound (the backward also on the captured training operands; the
     warp-composite also at the 768x1024, S=128 size); times predict and
     render per frame, the frames' copy to host memory on its own, and the
     train step; profiles them, with the device events per frame, and the
     coordinate-form prep the streaming render no longer runs.
Every result line is JSON and carries the card's name and power limit; the
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
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 rate outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-5)
T_START = time.perf_counter()


def card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power = (p.strip() for p in out.split(","))
    return {"gpu": name, "power_limit": power, "nvidia_smi": out}


def emit(info: dict, **fields) -> None:
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


def profile_breakdown(fn, frames: int, top: int = 8) -> dict:
    """One profiled call of fn (after a warm one): wall and device time per
    frame, the device's busy share, and the kernels taking the most device
    time. The profiler's own overhead inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def device_us(evt) -> float:
        return float(getattr(evt, "self_device_time_total", 0.0)
                     or getattr(evt, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies): the aten ops that launched
    # them carry the same device time again
    on_device = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0),
        key=device_us, reverse=True,
    )
    device_ms = sum(device_us(e) for e in on_device) / 1e3
    return {
        "wall_ms_per_frame": wall_ms / frames,
        "device_ms_per_frame": device_ms / frames,
        "device_busy_share": device_ms / wall_ms,
        # kernels and copies the card ran, per frame
        "device_events_per_frame": sum(e.count for e in on_device) / frames,
        "top_kernels": [
            {"name": e.key[:100], "ms_per_frame": device_us(e) / 1e3 / frames,
             "calls_per_frame": e.count / frames}
            for e in on_device[:top]
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
    kw.reset_launches()
    t0 = time.perf_counter()
    result = run_evaluation(e_cfg, s_trainer.model, s_val_ds, dev, lpips_params,
                            s_trainer.global_step)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = dict(kw.launches)
    s_trainer.model.train()
    want = {"warp_composite": 4 * len(s_val_ds), "warp_bilinear": 0, "warp_bilinear_grad": 0}
    if eval_launches != want or result["eval_examples"] != s_val_ds.num_eval_examples \
            or not result["lpips_tgt"] > 0 or not all(map(math.isfinite, result.values())):
        raise AssertionError(f"eval_path: launches {eval_launches} (want {want}), {result}")
    emit(info, phase="eval_path", metrics=result, eval_examples=result["eval_examples"],
         seconds=eval_s, launches=eval_launches)
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
    emit(info, phase="setup", torch=torch.__version__, cuda=torch.version.cuda,
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

    # 7. timings
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
    paths = streaming["launches"]

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
    sys.exit(main())
