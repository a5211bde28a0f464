"""chip_smoke.py's device-time filter (`device_work`) on recorded stand-ins
of torch.profiler events, so that it runs without a card.

The profiler reports, besides the kernels and copies the card ran, the
GPU-side ranges of every record_function that obs/attrib.py `scope` opens
(`gpu_user_annotation`), on the device and spanning those kernels. Summing
every device event counted each component's time a second time (a dense
step's device time came to 1.28 of its wall time). `device_work` keeps the
kernels, copies and sets, and drops the annotations and any other event
that encloses another one on its stream.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import chip_smoke

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Interval(SimpleNamespace):
    def elapsed_us(self) -> float:
        return self.end - self.start


def _event(name, start, end, device_type=CUDA, stream=7, **extra):
    return SimpleNamespace(name=name, device_type=device_type, device_index=0,
                           device_resource_id=stream,
                           time_range=_Interval(start=start, end=end), **extra)


def _recorded(with_flags: bool) -> list:
    """A step's events: three kernels, a copy and a set on stream 7, a
    kernel on stream 9, the CPU op that launched one, the decoder's
    GPU-side annotation over two kernels and a profiler range over all of
    stream 7's work. Older profilers carry neither the annotation flag nor
    the activity type (with_flags False)."""
    def ev(name, start, end, kind, **kw):
        flags = {"is_user_annotation": kind.endswith("annotation"), "activity_type": kind}
        return _event(name, start, end, **(flags if with_flags else {}), **kw)

    return [
        ev("decoder", 0.0, 20.0, "gpu_user_annotation"),
        ev("ProfilerStep#1", 0.0, 40.0, "gpu_user_annotation"),
        ev("implicit_gemm", 0.0, 10.0, "kernel"),
        ev("bn_fw_tr", 12.0, 20.0, "kernel"),
        ev("Memcpy HtoD (Pageable -> Device)", 21.0, 25.0, "gpu_memcpy"),
        ev("Memset (Device)", 26.0, 27.0, "gpu_memset"),
        ev("warp_bilinear_kernel", 30.0, 40.0, "kernel"),
        ev("adam_kernel", 5.0, 15.0, "kernel", stream=9),
        ev("aten::add", 1.0, 2.0, "cpu_op", device_type=CPU),
    ]


@pytest.mark.parametrize("with_flags", [True, False], ids=["flagged", "unflagged"])
def test_device_work_drops_annotations_and_enclosing_ranges(with_flags):
    kept = chip_smoke.device_work(_recorded(with_flags))
    assert sorted(e.name for e in kept) == sorted([
        "implicit_gemm", "bn_fw_tr", "Memcpy HtoD (Pageable -> Device)", "Memset (Device)",
        "warp_bilinear_kernel", "adam_kernel"])
    # 10 + 8 + 4 + 1 + 10 on stream 7, 10 on stream 9: each kernel once
    assert sum(e.time_range.elapsed_us() for e in kept) == 43.0


def test_device_work_keeps_back_to_back_kernels():
    """Kernels that touch end to start, and a kernel whose annotation spans
    exactly it, are each counted once."""
    events = [_event("a", 0.0, 5.0), _event("b", 5.0, 9.0),
              _event("scope", 9.0, 12.0), _event("c", 9.0, 12.0)]
    kept = chip_smoke.device_work(events)
    assert [e.time_range.elapsed_us() for e in kept] == [5.0, 4.0, 3.0]
