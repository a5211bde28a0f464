"""Cost accounting: FLOPs per step, peaks, MFU (the port's own copy of
mine_tpu/obs/cost.py).

The training loop and the serving engine both quote THIS module, so a
metrics.jsonl line and a /metrics gauge share one definition:

  * step FLOPs: the operations PyTorch's `FlopCounterMode` counts while the
    callable runs once (`counted_cost`). It counts matrix products and
    convolutions, forward and backward, by the standard formula
    2 x (output elements) x (reduction length), every tap of a zero-padded
    convolution included. XLA's cost analysis, which the JAX package
    quotes, counts a convolution's non-padded taps only, so the port's
    count of the same network is a little higher (1.030x at ResNet-18,
    128x128; 1.012x at ResNet-50), and the gap shrinks as the borders
    become a smaller share of the image.
  * MFU: step FLOPs over the measured step time, divided by the card's
    published dense bf16 peak (`compute_mfu`).

The hand-written CUDA kernels (the warp, its backward, the warp-composite)
count 0 FLOPs: they run outside PyTorch's dispatcher, as the Pallas kernels
count 0 in XLA's analysis (no pallas_call in mine_tpu/ops/pallas/warp.py
passes a cost_estimate). Elementwise work counts 0 here too; XLA counts one
operation per element, which the convolutions dwarf.

`bytes_accessed` stays None: nothing in PyTorch counts the bytes a step
moves the way XLA's analysis does, so the achieved-bandwidth gauge is left
unset, as the JAX package leaves it on a backend without that analysis.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Callable

import torch

# Published dense bf16 peak FLOP/s of one card, keyed by
# torch.cuda.get_device_name(). Source: NVIDIA H100 Tensor Core GPU
# datasheet, H100 SXM column: 989 TFLOP/s bf16 without sparsity.
CHIP_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

# Published memory bandwidth, bytes/s. Same datasheet and column: 3.35 TB/s
# of HBM3.
CHIP_PEAK_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _lookup(table: dict[str, float], device_kind: str) -> float | None:
    if device_kind in table:
        return table[device_kind]
    # prefix match tolerates a suffix on the device name
    for kind, peak in sorted(table.items(), key=lambda kv: -len(kv[0])):
        if device_kind.startswith(kind):
            return peak
    return None


def chip_peak_flops(device_kind: str) -> float | None:
    """Peak FLOP/s of one card of this name (None when unknown, notably
    "cpu": CPU runs pass obs.peak_flops_override instead of a made-up
    table entry)."""
    return _lookup(CHIP_PEAK_FLOPS, device_kind)


def chip_peak_hbm_bytes(device_kind: str) -> float | None:
    """Peak memory bandwidth (bytes/s) of one card (None unknown)."""
    return _lookup(CHIP_PEAK_HBM_BYTES, device_kind)


@dataclass(frozen=True)
class StepCost:
    """What one call of a step costs."""

    flops: float | None = None
    bytes_accessed: float | None = None
    peak_memory_bytes: float | None = None
    argument_bytes: float | None = None
    output_bytes: float | None = None

    def to_dict(self) -> dict[str, float | None]:
        return asdict(self)


def counted_cost(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> tuple[Any, StepCost]:
    """Run fn(*args, **kwargs) once under FlopCounterMode; returns its result
    and the StepCost (module docstring). On a CUDA device that is already
    initialised, peak_memory_bytes is torch.cuda.max_memory_allocated after
    the call when the call raised it, else None: the peak statistic is
    process-wide (the memory gauges read it too), so it is never reset
    here, and a call that stayed under an earlier peak has no peak of its
    own to report. The counting mode slows the call on the host, so a
    caller keeps it out of every timing window; the card still runs the
    same kernels."""
    from torch.utils.flop_counter import FlopCounterMode

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    before = torch.cuda.max_memory_allocated() if on_card else None
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    peak = None
    if on_card:
        torch.cuda.synchronize()
        after = torch.cuda.max_memory_allocated()
        peak = float(after) if after > before else None
    return out, StepCost(flops=flops if flops > 0 else None, peak_memory_bytes=peak)


def compute_mfu(
    flops_per_step: float | None,
    step_seconds: float,
    peak_flops: float | None,
) -> float | None:
    """Model FLOPs utilization: achieved FLOP/s over the device peak.

    None in, None out: an unknown FLOP count or peak surfaces as an absent
    gauge, never as a fake 0% or 100%.
    """
    if not flops_per_step or not peak_flops or step_seconds <= 0:
        return None
    return (flops_per_step / step_seconds) / peak_flops


def achieved_fraction(
    amount_per_step: float | None,
    step_seconds: float,
    peak_per_second: float | None,
) -> float | None:
    """Generic achieved/peak fraction (bytes for bandwidth, FLOPs for MFU)."""
    if not amount_per_step or not peak_per_second or step_seconds <= 0:
        return None
    return (amount_per_step / step_seconds) / peak_per_second


def _device_kind(device: Any) -> str:
    """torch.cuda.get_device_name of a CUDA device; "cpu" otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def resolve_peak_flops(device: Any = None, override: float = 0.0) -> float | None:
    """The peak the gauges divide by: an explicit override wins (the only
    honest option on the CPU); else the table row of the card's name; else
    None."""
    if override and override > 0:
        return float(override)
    return chip_peak_flops(_device_kind(device))


def resolve_peak_hbm_bytes(device: Any = None, override: float = 0.0) -> float | None:
    if override and override > 0:
        return float(override)
    return chip_peak_hbm_bytes(_device_kind(device))

