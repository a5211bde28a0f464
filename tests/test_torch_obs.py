"""The port's observability against mine_tpu/obs (cost.py, attrib.py,
flight.py) and its trainer's obs contract: step FLOPs and MFU, the component
table, the flight recorder, and an obs-enabled Trainer.fit on the CPU.

FLOPs: both packages give exactly 2*M*N*K for a matmul and the same count
for an unpadded convolution; on a zero-padded one XLA counts only the
non-padded taps, so the port's count is higher by exactly the padded taps
(stated below); the ResNet-18 forward at 128x128, S=3 holds port/JAX in
[1.0, 1.05]. The MFU math, the peak table's None propagation, component_of
and attach_cost_estimates are compared exactly.
"""

from __future__ import annotations

import glob
import json
import math
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mine_tpu.models import MPINetwork as JaxMPINetwork
from mine_tpu.obs import attrib as jattrib
from mine_tpu.obs import cost as jcost
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.obs import attrib, cost
from mine_tpu_torch.obs.flight import FlightRecorder
from mine_tpu_torch.obs.trace import Tracer
from mine_tpu_torch.training.loop import Trainer
from tests.test_torch_model import random_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

# -- cost ------------------------------------------------------------------------------


def test_matmul_flops_are_2mnk_in_both_packages():
    m, k, n = 128, 256, 64
    a, b = np.ones((m, k), np.float32), np.ones((k, n), np.float32)
    jax_cost = jcost.compiled_cost(jax.jit(lambda x, y: x @ y).lower(a, b).compile())
    out, port_cost = cost.counted_cost(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (m, n)
    assert jax_cost.flops == port_cost.flops == 2 * m * n * k
    # 2*M*N*K flops in 1 ms against a 1 TFLOP/s peak: MFU exactly known
    assert cost.compute_mfu(port_cost.flops, 1e-3, 1e12) == pytest.approx(
        2 * m * n * k / 1e-3 / 1e12)
    assert port_cost.bytes_accessed is None  # not counted, never fabricated


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv_flops_agree_unpadded_and_differ_by_the_padded_taps(padding):
    """A bias-free 3x3 convolution, N=2, Cin=8, Cout=16, 12x10. Unpadded:
    both count 2*N*Cout*Cin*9*(H-2)*(W-2) = 368,640. Zero-padded ("SAME"):
    the port counts every tap, 2*N*Cout*Cin*9*H*W = 552,960; XLA only the
    taps inside the image, 2*N*Cout*Cin*(3H-2)*(3W-2) = 487,424."""
    n, c, o, h, w = 2, 8, 16, 12, 10
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    kern = rng.normal(size=(3, 3, c, o)).astype(np.float32)
    conv = jax.jit(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (1, 1), padding, dimension_numbers=("NHWC", "HWIO", "NHWC")))
    jax_flops = jcost.compiled_cost(conv.lower(x, kern).compile()).flops
    _, port = cost.counted_cost(
        torch.nn.functional.conv2d, torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(kern).permute(3, 2, 0, 1), None, 1, 1 if padding == "SAME" else 0)
    if padding == "VALID":
        assert jax_flops == port.flops == 2 * n * o * c * 9 * (h - 2) * (w - 2) == 368_640
    else:
        assert port.flops == 2 * n * o * c * 9 * h * w == 552_960
        assert jax_flops == 2 * n * o * c * (3 * h - 2) * (3 * w - 2) == 487_424


def test_resnet18_forward_flops_port_over_jax():
    """The same seeded weights at 128x128, S=3, B=1, eval mode: the port's
    FlopCounterMode count over XLA's cost analysis in [1.0, 1.05] (1.030
    measured when this slice was written; the gap is the padded taps of
    the 3x3 and 7x7 convolutions)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    disparity = np.linspace(1.0, 0.05, 3, dtype=np.float32)[None]
    jax_model = JaxMPINetwork(num_layers=18, multires=10, dtype=jnp.float32)
    variables = random_jax_variables(jax_model, jnp.asarray(x), jnp.asarray(disparity), 7)
    compiled = jax.jit(jax_model.apply, static_argnums=3).lower(
        variables, jnp.asarray(x), jnp.asarray(disparity), False).compile()
    jax_flops = jcost.compiled_cost(compiled).flops
    model = MPINetwork(num_layers=18, multires=10).eval()
    model.load_state_dict(jax_variables_to_torch(flatten_variables(variables), 18))
    with torch.no_grad():
        out, port = cost.counted_cost(model, torch.from_numpy(x), torch.from_numpy(disparity))
    assert sorted(out) == [0, 1, 2, 3]
    assert 1.0 <= port.flops / jax_flops <= 1.05, (port.flops, jax_flops)


@pytest.mark.parametrize("args", [
    (None, 1.0, 1e12), (1e9, 1.0, None), (1e9, 0.0, 1e12), (1e12, 1.0, 1e12),
    (3.5e11, 0.25, 989e12), (0.0, 1.0, 1e12),
])
def test_mfu_math_matches_jax(args):
    assert cost.compute_mfu(*args) == jcost.compute_mfu(*args)
    assert cost.achieved_fraction(*args) == jcost.achieved_fraction(*args)


def test_mfu_math_none_propagation_and_peak_table():
    assert cost.compute_mfu(None, 1.0, 1e12) is None
    assert cost.compute_mfu(1e9, 1.0, None) is None
    assert cost.compute_mfu(1e9, 0.0, 1e12) is None
    assert cost.compute_mfu(1e12, 1.0, 1e12) == pytest.approx(1.0)
    # the table holds the H100 SXM's datasheet rates; prefix match; CPU None
    assert cost.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert cost.chip_peak_hbm_bytes("NVIDIA H100 80GB HBM3") == 3.35e12
    assert cost.chip_peak_flops("NVIDIA H100 80GB HBM3 (MIG 1g.10gb)") == 989e12
    assert cost.chip_peak_flops("cpu") is None
    assert not any(k.startswith("TPU") for k in cost.CHIP_PEAK_FLOPS)
    # override beats the table; 0 means the table, which a CPU lacks
    assert cost.resolve_peak_flops(object(), override=5e9) == 5e9
    assert cost.resolve_peak_flops("cpu") is None
    assert cost.resolve_peak_hbm_bytes("cpu") is None


# -- attribution -----------------------------------------------------------------------

_SCOPE_PATHS = [
    "jit(train_step)/losses/composite/reduce_sum", "jit(train_step)/losses/sub/add",
    "jit(train_step)/transpose(jvp(encoder))/conv", "jit(train_step)/jvp(decoder)/dot_general",
    "jit(f)/backbone/conv", "jit(f)/zero1_gather/all-gather",
    "jit(f)/jit(main)/convert_element_type", None, "", "optimizer", "homography_warp",
]


@pytest.mark.parametrize("path", _SCOPE_PATHS)
def test_component_of_matches_jax(path):
    assert attrib.component_of(path) == jattrib.component_of(path)
    assert attrib.COMPONENTS == jattrib.COMPONENTS
    assert attrib.COVERAGE_TARGET == jattrib.COVERAGE_TARGET == 0.9


def test_attach_cost_estimates_matches_jax():
    rows = [{"component": "encoder", "time_ms": 7.5, "pct": 75.0, "calls": 3},
            {"component": "losses", "time_ms": 2.0, "pct": 20.0, "calls": 2},
            {"component": "unattributed", "time_ms": 0.5, "pct": 5.0, "calls": 1}]
    ours = attrib.attach_cost_estimates(
        {"rows": [dict(r) for r in rows], "total_ms": 10.0}, flops=1000.0, bytes_accessed=None)
    theirs = jattrib.attach_cost_estimates(
        {"rows": [dict(r) for r in rows], "total_ms": 10.0}, flops=1000.0, bytes_accessed=None)
    assert ours["rows"] == theirs["rows"]
    assert [r["flops_est"] for r in ours["rows"]] == [750, 200, 50]
    assert all(r["bytes_est"] is None for r in ours["rows"])
    assert "estimates" in ours["cost_note"]


class _Tiny(torch.nn.Module):
    """An encoder conv and a decoder conv under the port's own scopes."""

    def __init__(self):
        super().__init__()
        self.enc = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.dec = torch.nn.Conv2d(8, 4, 3, padding=1)

    def forward(self, x):
        with attrib.scope("encoder"):
            y = torch.relu(self.enc(x))
        with attrib.scope("decoder"):
            return self.dec(y)


def test_attribute_events_on_a_real_cpu_trace(tmp_path):
    """A torch.profiler trace of a tiny forward and backward: every conv op,
    forward and backward, lands in its scope (the backward through its
    sequence number), and coverage >= 0.9."""
    torch.manual_seed(0)
    model = _Tiny()
    x = torch.randn(1, 3, 32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = model(x)
        with attrib.scope("losses"):
            loss = out.square().mean()
        loss.backward()
    path = str(tmp_path / "t.trace.json")
    prof.export_chrome_trace(path)
    items, basis = attrib.attributed_items(attrib.load_trace_events(path))
    assert basis == "host"
    convs = [(ev["name"], comp) for ev, comp in items if "onvolution" in ev["name"]
             or ev["name"] == "aten::conv2d"]
    assert sorted(convs) == sorted([
        ("aten::conv2d", "encoder"), ("aten::conv2d", "decoder"),
        ("autograd::engine::evaluate_function: ConvolutionBackward0", "encoder"),
        ("autograd::engine::evaluate_function: ConvolutionBackward0", "decoder"),
    ])
    table = attrib.attribute_profile_dir(str(tmp_path))
    assert table["trace"] == path and table["covered"] and table["coverage"] >= 0.9
    assert {r["component"] for r in table["rows"]} >= {"encoder", "decoder", "losses"}
    assert abs(sum(r["time_ms"] for r in table["rows"]) - table["total_ms"]) < 1e-2


def test_attribute_events_device_kernels_follow_their_launch():
    """A trace shaped like a CUDA one: kernels take the scope of the host op
    whose runtime call launched them (correlation id), and a backward op on
    another thread takes its forward op's scope through (Fwd thread id,
    Sequence number), whatever sequence numbers the two threads share."""
    main, bwd = 100, 200

    def op(name, tid, ts, dur, cat="cpu_op", **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts,
                "dur": dur, "args": args}

    events = [
        op("encoder", main, 0, 100, cat="user_annotation"),
        op("aten::conv2d", main, 10, 50, **{"Sequence number": 7, "Fwd thread id": 0}),
        op("cudaLaunchKernel", main, 20, 5, cat="cuda_runtime", correlation=1),
        op("decoder", main, 200, 100, cat="user_annotation"),
        op("aten::conv2d", main, 210, 50, **{"Sequence number": 8, "Fwd thread id": 0}),
        op("cudaLaunchKernel", main, 220, 5, cat="cuda_runtime", correlation=2),
        # a recompute on the autograd thread reuses sequence number 7
        op("composite", bwd, 300, 50, cat="user_annotation"),
        op("aten::mul", bwd, 305, 10, **{"Sequence number": 7, "Fwd thread id": 0}),
        op("autograd::engine::evaluate_function: ConvolutionBackward0", bwd, 400, 80,
           **{"Sequence number": 8, "Fwd thread id": 1}),
        # the node's own event, nested, with the same sequence number
        op("ConvolutionBackward0", bwd, 401, 78, **{"Sequence number": 8, "Fwd thread id": 1}),
        op("cudaLaunchKernel", bwd, 410, 5, cat="cuda_runtime", correlation=3),
        op("autograd::engine::evaluate_function: ConvolutionBackward0", bwd, 500, 80,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        op("cudaLaunchKernel", bwd, 510, 5, cat="cuda_runtime", correlation=4),
        op("cudaMemcpyAsync", main, 600, 5, cat="cuda_runtime", correlation=5),
        # a backward op of the autograd thread's own recompute (profiler
        # thread 3) enclosing a scoped forward op of its sequence number:
        # that op came later, so it is not its forward; no loop, no guess
        op("autograd::engine::evaluate_function: MulBackward0", bwd, 700, 100,
           **{"Sequence number": 9, "Fwd thread id": 3}),
        op("cudaLaunchKernel", bwd, 705, 2, cat="cuda_runtime", correlation=6),
        op("composite", bwd, 708, 60, cat="user_annotation"),
        op("aten::mul", bwd, 710, 50, **{"Sequence number": 9, "Fwd thread id": 0}),
        op("autograd::engine::evaluate_function: MulBackward0", bwd, 900, 50,
           **{"Sequence number": 10, "Fwd thread id": 3}),
        op("aten::add", bwd, 850, 10, **{"Sequence number": 10, "Fwd thread id": 0}),
        op("decoder", 0, 0, 1000, cat="gpu_user_annotation"),
    ] + [op(f"k{c}", 7, 1000 + 100 * c, dur, cat=kind, correlation=c)
         for c, dur, kind in ((1, 40, "kernel"), (2, 30, "kernel"), (3, 20, "kernel"),
                              (4, 6, "kernel"), (5, 4, "gpu_memcpy"), (6, 2, "kernel"))]
    table = attrib.attribute_events(events)
    assert table["basis"] == "device"
    by = {r["component"]: (r["time_ms"], r["calls"]) for r in table["rows"]}
    assert by == {"encoder": (0.046, 2), "decoder": (0.05, 2), "unattributed": (0.006, 2)}
    assert table["coverage"] == pytest.approx(96 / 102, abs=1e-4) and table["covered"]


# -- flight recorder -------------------------------------------------------------------


def _flight_dirs(dump_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(dump_dir, "*", "flight_*")))


def test_flight_recorder_dumps_on_sigusr1(tmp_path):
    tracer = Tracer(enabled=True)
    with tracer.span("before_signal", cat="test"):
        pass
    fr = FlightRecorder(str(tmp_path), tracer=tracer, last_k_spans=16,
                        min_dump_interval_s=0.0, get_status=lambda: {"phase": "testing"})
    prev = signal.getsignal(signal.SIGUSR1)
    fr.start()
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not fr.dumps and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        fr.stop()
    assert signal.getsignal(signal.SIGUSR1) == prev  # disarmed
    assert fr.dumps and _flight_dirs(str(tmp_path)) == fr.dumps
    dump = fr.dumps[0]
    assert os.path.basename(os.path.dirname(dump)) == f"pid{os.getpid()}"
    assert "test_flight_recorder_dumps_on_sigusr1" in open(os.path.join(dump, "stacks.txt")).read()
    spans = json.load(open(os.path.join(dump, "spans.json")))
    assert [s["name"] for s in spans["spans"]] == ["before_signal"]
    meta = json.load(open(os.path.join(dump, "meta.json")))
    assert meta["reason"] == "signal_sigusr1" and meta["status"] == {"phase": "testing"}
    assert meta["device_memory"] == "cuda not initialized"  # never initialised by a dump


def test_flight_recorder_dumps_on_simulated_stall(tmp_path):
    """A short watchdog and a 'step' that sleeps past it: exactly one stall
    dump with all-thread stacks and the last-K spans; the heartbeat
    resuming re-arms the watchdog."""
    tracer = Tracer(enabled=True)
    fr = FlightRecorder(str(tmp_path), tracer=tracer, watchdog_timeout_s=0.25,
                        last_k_spans=4, min_dump_interval_s=0.0)
    fr.start()
    try:
        for i in range(6):
            with tracer.span("step", cat="train", step=i):
                pass
            fr.heartbeat(step=i)
        time.sleep(0.9)
        assert len(fr.dumps) == 1, "stall watchdog should dump exactly once"
        dump = fr.dumps[0]
        assert "test_flight_recorder_dumps_on_simulated_stall" in open(
            os.path.join(dump, "stacks.txt")).read()
        spans = json.load(open(os.path.join(dump, "spans.json")))
        assert len(spans["spans"]) == 4 and all(s["name"] == "step" for s in spans["spans"])
        meta = json.load(open(os.path.join(dump, "meta.json")))
        assert meta["reason"] == "stall" and meta["last_step"] == 5
        assert meta["heartbeat_age_s"] >= 0.25
        fr.heartbeat(step=6)
        time.sleep(0.6)
        assert len(fr.dumps) == 2
    finally:
        fr.stop()


# -- the trainer with obs on -------------------------------------------------------------

TINY = {"data.name": "synthetic", "data.img_h": 128, "data.img_w": 128,
        "model.num_layers": 18, "mpi.num_bins_coarse": 4, "data.per_gpu_batch_size": 1,
        "model.dtype": "float32", "model.imagenet_pretrained": False,
        "data.num_workers": 0, "training.log_interval": 1}


def test_trainer_with_obs_writes_spans_mfu_attribution_and_arms_flight(tmp_path):
    """3 steps, obs.enabled, a 1-step profile window at step 2: the five
    host spans in host_spans.trace.json, metrics.jsonl with the JAX tags and
    a finite obs/mfu, the component gauges with coverage >= 0.9, a counted
    step of forward + backward FLOPs, and the flight recorder armed during
    fit (a SIGUSR1 from inside step 2 dumps) and disarmed after it."""
    cfg = Config().replace(**{**TINY, "obs.enabled": True, "obs.peak_flops_override": 1e12,
                              "obs.profile_start_offset": 1, "obs.profile_steps": 1})
    ws = str(tmp_path / "ws")
    trainer = Trainer(cfg, ws, device="cpu")
    step = trainer.step

    def poke(batch):
        out = step(batch)
        if trainer.global_step == 2:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    trainer.step = poke
    prev = signal.getsignal(signal.SIGUSR1)
    logged = trainer.fit(build_dataset(cfg, "train", 1), max_steps=3)
    assert math.isfinite(logged["loss"]) and trainer.global_step == 3
    assert signal.getsignal(signal.SIGUSR1) == prev
    dumps = _flight_dirs(os.path.join(ws, "flight"))
    assert len(dumps) == 1 and dumps[0].endswith("signal_sigusr1")
    meta = json.load(open(os.path.join(dumps[0], "meta.json")))
    # the signal came from inside step 2, before the loop's bookkeeping of it
    assert meta["last_step"] == 1 and meta["status"]["global_step"] == 1
    assert meta["status"]["step_flops"] > 0

    trace = json.load(open(os.path.join(ws, "profile", "host_spans.trace.json")))
    names = {ev["name"] for ev in trace["traceEvents"] if ev.get("ph") == "X"}
    assert {"data", "step", "sync", "log", "ckpt"} <= names
    lines = [json.loads(ln) for ln in open(os.path.join(ws, "metrics.jsonl"))]
    tags = {ln["tag"] for ln in lines}
    assert {"train/loss", "train/psnr_tgt", "train/imgs_per_sec", "train/backbone_lr",
            "train/grad_norm", "train_epoch/loss", "obs/mfu", "obs/tflops_per_sec",
            "obs/step_flops", "obs/attrib_coverage", "obs/component_encoder_ms"} <= tags
    mfu = [ln["value"] for ln in lines if ln["tag"] == "obs/mfu"]
    assert mfu and all(math.isfinite(v) and v > 0 for v in mfu)
    # the counted step (1) and the profiled one (2) are left out of the
    # timing: only step 3's interval is timed
    assert [ln["step"] for ln in lines if ln["tag"] == "obs/mfu"] == [3]
    rates = [json.loads(ln)["imgs_per_sec"] for ln in open(os.path.join(ws, "train_log.jsonl"))]
    assert rates[:2] == [None, None] and rates[2] > 0
    assert os.path.exists(os.path.join(ws, "train.log"))
    assert "obs cost accounting" in open(os.path.join(ws, "train.log")).read()

    m = trainer.obs_metrics
    assert m.step_flops.value() == trainer.train_cost.flops > 0
    assert m.mfu.value() == pytest.approx(mfu[-1])
    table = trainer.attribution
    assert table["covered"] and m.attrib_coverage.value() == table["coverage"] >= 0.9
    assert {"encoder", "decoder", "homography_warp", "composite", "losses",
            "optimizer"} <= {r["component"] for r in table["rows"]}
    exposition = m.registry.render()
    assert 'mine_train_component_time_ms{component="encoder"}' in exposition
    assert 'mine_build_info{backend="cpu"' in exposition
    # the counted step ran the backward under the counter too: about three
    # forwards (the backward's two convolution products a forward one)
    batch = next(iter(build_dataset(cfg, "train", 1).epoch(1)))
    x = torch.from_numpy(np.asarray(batch["src_img"], np.float32))
    with torch.no_grad():
        _, forward = cost.counted_cost(trainer.model, x, torch.linspace(1.0, 0.05, 4)[None])
    assert 2.5 <= trainer.train_cost.flops / forward.flops <= 3.5


def test_scopes_cost_nothing_with_the_profiler_off():
    """A scope outside a profiler session is the shared no-op context."""
    assert attrib.scope("encoder") is attrib.scope("composite")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with attrib.scope("encoder"):
            pass
    assert (time.perf_counter() - t0) / n < 20e-6
    with pytest.raises(ValueError, match="unknown component"):
        attrib.scope("nonsense")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert attrib.scope("encoder") is not attrib.scope("encoder")
