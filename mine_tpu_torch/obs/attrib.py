"""Per-component device-time attribution: who owns the step time (the
port's own copy of mine_tpu/obs/attrib.py, over torch.profiler traces).

The model's components are annotated with `scope(name)` (a
torch.profiler.record_function around one function call) at the JAX
package's `jax.named_scope` sites: `encoder` and `decoder`
(models/mpi.py), `homography_warp` and `composite` (ops/mpi_render.py, the
warp's backward in ops/kernels/warp.py), `losses` and `optimizer`
(training/step.py). With the profiler off a scope is one attribute read.

`attribute_events` turns a torch.profiler Chrome trace into a per-component
table with an explicit `unattributed` row and a coverage fraction; the table
accounts for the step only when coverage >= COVERAGE_TARGET (0.9):

  * host ops nest by time on their thread; an op belongs to the innermost
    enclosing scope;
  * a backward op runs outside every forward scope (on the card, on a
    thread of the autograd engine). Its `autograd::engine::evaluate_function`
    event carries the forward op's "Sequence number" and the forward
    thread's id ("Fwd thread id", the profiler's own thread number, mapped
    to an OS thread by which forward ops carry those sequence numbers), so
    it takes its forward op's scope: the torch form of the JAX package's
    transpose(jvp(encoder)) peel;
  * a device event (a kernel, copy or memset) takes the scope of the host
    op that launched it, through the launch's "correlation" id;
  * a trace without device events (a CPU run) is attributed by the host
    time of its outermost ops.

The JAX module's HLO parsers (`_parse_hlo`, `hlo_op_components`,
`attribute_hlo`) read XLA's compiled text, which PyTorch has no counterpart
of: the scopes reach the trace itself, so nothing needs a second map.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from collections import Counter
from contextlib import nullcontext
from functools import wraps
from typing import Any, Callable, Iterable

import torch
import torch.autograd.profiler as _profiler

# Components in the order the scopes nest, innermost-distinctive first;
# component_of scans a path's segments right to left, so the innermost
# annotated scope wins (losses wraps the render calls)
COMPONENT_PATTERNS: tuple[tuple[str, re.Pattern], ...] = tuple(
    (name, re.compile(pat))
    for name, pat in (
        ("zero1_gather", r"^zero1_gather$"),
        ("fsdp_gather", r"^fsdp_gather$"),
        ("optimizer", r"^optimizer$"),
        ("losses", r"^losses$"),
        ("homography_warp", r"^homography_warp$"),
        ("composite", r"^composite$"),
        ("decoder", r"^decoder$"),
        # flax names the encoder module "backbone"; both spellings map
        ("encoder", r"^(encoder|backbone)$"),
    )
)

COMPONENTS = tuple(name for name, _ in COMPONENT_PATTERNS)
UNATTRIBUTED = "unattributed"

# the table "accounts for" the step only above this attributed fraction
COVERAGE_TARGET = 0.9

_NULL_SCOPE = nullcontext()


def scope(name: str):
    """A profiler range named after a component around one call: a
    record_function while a torch.profiler session is on, else a shared
    no-op context manager."""
    if name not in COMPONENTS:
        raise ValueError(f"unknown component {name!r} (known: {COMPONENTS})")
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL_SCOPE


def scoped(name: str) -> Callable:
    """Decorator form of scope(name)."""

    def deco(fn: Callable) -> Callable:
        @wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def component_of(op_name: str | None) -> str | None:
    """Map one scope path ('/'-separated) to its component (None =
    unscoped). Scans the segments innermost-first; transform wrappers like
    "transpose(jvp(main))" around a segment are stripped."""
    if not op_name:
        return None
    for seg in reversed(op_name.split("/")):
        while True:
            m = re.fullmatch(r"[\w.\-]+\((.*)\)", seg)
            if m is None:
                break
            seg = m.group(1)
        for name, pat in COMPONENT_PATTERNS:
            if pat.search(seg):
                return name
    return None


# -- the trace --------------------------------------------------------------------

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
# the device-lane projection of a record_function: not work, and not a host op
_SKIPPED_CATS = frozenset({"gpu_user_annotation"})
_BACKWARD_PREFIX = "autograd::engine::evaluate_function:"
SEQ_ARG, FWD_TID_ARG, CORRELATION_ARG = "Sequence number", "Fwd thread id", "correlation"


class _HostTree:
    """The host events of a trace nested by time per (pid, tid), with each
    event's component resolved once (module docstring)."""

    def __init__(self, host: list[dict]):
        self.events = host
        self.parent: list[int | None] = [None] * len(host)
        by_thread: dict[tuple, list[int]] = {}
        for i, ev in enumerate(host):
            by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append(i)
        for idx in by_thread.values():
            idx.sort(key=lambda i: (float(host[i]["ts"]), -float(host[i].get("dur", 0.0))))
            stack: list[int] = []
            for i in idx:
                ts = float(host[i]["ts"])
                while stack and ts >= _end(host[stack[-1]]):
                    stack.pop()
                self.parent[i] = stack[-1] if stack else None
                stack.append(i)
        self._memo: dict[int, str | None] = {}
        # (OS tid, seq) -> forward ops carrying that sequence number, by time
        self._forward: dict[tuple[Any, int], list[int]] = {}
        for i, ev in enumerate(host):
            # a forward op carries "Fwd thread id" 0; a backward node's own
            # event (nested in its evaluate_function) carries its forward
            # thread's number and the same sequence number
            args = ev.get("args") or {}
            if args.get(SEQ_ARG) is not None and not args.get(FWD_TID_ARG) \
                    and ev.get("cat") == "cpu_op":
                self._forward.setdefault((ev.get("tid"), int(args[SEQ_ARG])), []).append(i)
        for ops in self._forward.values():
            ops.sort(key=lambda i: float(host[i]["ts"]))
        seq_tids: dict[int, set] = {}
        for tid, seq in self._forward:
            seq_tids.setdefault(seq, set()).add(tid)
        # the profiler's thread number -> OS tid: the thread whose forward
        # ops carry the sequence numbers its backward ops name, by majority
        # (sequence numbers are counted per thread, so two threads share
        # some of them)
        votes: dict[Any, Counter] = {}
        for i, ev in enumerate(host):
            args = ev.get("args") or {}
            if ev["name"].startswith(_BACKWARD_PREFIX) and args.get(SEQ_ARG) is not None:
                for tid in seq_tids.get(int(args[SEQ_ARG]), ()):
                    if self._forward_of(tid, int(args[SEQ_ARG]), i) is not None:
                        votes.setdefault(args.get(FWD_TID_ARG), Counter())[tid] += 1
        self._fwd_thread = {n: c.most_common(1)[0][0] for n, c in votes.items()}

    def _forward_of(self, tid: Any, seq: int, backward: int) -> int | None:
        """The outermost forward op of (tid, seq) that began before the
        backward op `backward`: a backward node's forward op precedes it.
        (A recompute inside a backward op can carry the same key; since
        each link goes to an earlier op, resolving never loops.)"""
        ops = self._forward.get((tid, seq))
        if ops and float(self.events[ops[0]]["ts"]) < float(self.events[backward]["ts"]):
            return ops[0]
        return None

    def component(self, i: int | None) -> str | None:
        """The component of host event i: its own or its innermost
        ancestor's scope, a backward op's forward scope on the way."""
        chain = []
        comp = None
        while i is not None:
            if i in self._memo:
                comp = self._memo[i]
                break
            chain.append(i)
            comp = self._own(i)
            if comp is not None:
                break
            i = self.parent[i]
        for j in chain:
            self._memo[j] = comp
        return comp

    def _own(self, i: int) -> str | None:
        ev = self.events[i]
        if ev.get("cat") == "user_annotation":
            return component_of(ev["name"])
        args = ev.get("args") or {}
        if ev["name"].startswith(_BACKWARD_PREFIX) and args.get(SEQ_ARG) is not None:
            tid = self._fwd_thread.get(args.get(FWD_TID_ARG))
            fwd = self._forward_of(tid, int(args[SEQ_ARG]), i)
            if fwd is not None:
                return self.component(fwd)
        return None

    def outermost_ops(self) -> Iterable[int]:
        """cpu_op events with no cpu_op ancestor."""
        for i, ev in enumerate(self.events):
            if ev.get("cat") != "cpu_op":
                continue
            p = self.parent[i]
            while p is not None and self.events[p].get("cat") != "cpu_op":
                p = self.parent[p]
            if p is None:
                yield i


def _end(ev: dict) -> float:
    return float(ev["ts"]) + float(ev.get("dur", 0.0))


def attributed_items(events: Iterable[dict]) -> tuple[list[tuple[dict, str | None]], str]:
    """The work of a torch.profiler Chrome trace with its component:
    ([(event, component or None), ...], basis). The events are the device
    events (kernels, copies, memsets) when the trace has any ("device"),
    else the outermost host ops ("host")."""
    events = [ev for ev in events if ev.get("ph") == "X"]
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATS]
    host = [ev for ev in events
            if ev.get("cat") not in DEVICE_CATS and ev.get("cat") not in _SKIPPED_CATS]
    tree = _HostTree(host)
    if not device:
        return [(host[i], tree.component(i)) for i in tree.outermost_ops()], "host"
    launch = {}
    for i, ev in enumerate(host):
        corr = (ev.get("args") or {}).get(CORRELATION_ARG)
        if corr is not None:
            launch[corr] = i
    return [(ev, tree.component(launch.get((ev.get("args") or {}).get(CORRELATION_ARG))))
            for ev in device], "device"


def attribute_events(events: Iterable[dict]) -> dict:
    """Bucket a torch.profiler Chrome trace's work (attributed_items) into
    per-component time. Returns {"rows": [{component, time_ms, pct,
    calls}...] sorted by time (the `unattributed` remainder always last),
    "total_ms", "attributed_ms", "coverage", "covered": coverage >=
    COVERAGE_TARGET, "basis": "device" | "host"}."""
    items, basis = attributed_items(events)
    totals: dict[str, list[float]] = {}
    total_us = 0.0
    for ev, comp in items:
        dur = float(ev.get("dur", 0.0))
        total_us += dur
        tot = totals.setdefault(comp or UNATTRIBUTED, [0.0, 0])
        tot[0] += dur
        tot[1] += 1
    attributed_us = sum(t[0] for comp, t in totals.items() if comp != UNATTRIBUTED)
    rows = [
        {
            "component": comp,
            "time_ms": round(t[0] / 1e3, 3),
            "pct": round(100.0 * t[0] / total_us, 1) if total_us else None,
            "calls": int(t[1]),
        }
        for comp, t in totals.items()
    ]
    rows.sort(key=lambda r: (r["component"] == UNATTRIBUTED, -r["time_ms"]))
    coverage = (attributed_us / total_us) if total_us else 0.0
    return {
        "rows": rows,
        "total_ms": round(total_us / 1e3, 3),
        "attributed_ms": round(attributed_us / 1e3, 3),
        "coverage": round(coverage, 4),
        "covered": coverage >= COVERAGE_TARGET,
        "basis": basis,
    }


def attach_cost_estimates(table: dict, flops: float | None,
                          bytes_accessed: float | None) -> dict:
    """Add time-weighted FLOPs/bytes estimates to an attribution table: the
    step's counted totals (obs/cost.py) split by each component's share of
    time. An estimate, labeled as such; the time column is the
    measurement."""
    if not table.get("rows"):
        return table
    for row in table["rows"]:
        share = (row["time_ms"] / table["total_ms"]) if table["total_ms"] else 0.0
        row["flops_est"] = round(flops * share) if flops else None
        row["bytes_est"] = round(bytes_accessed * share) if bytes_accessed else None
    table["cost_note"] = (
        "flops_est/bytes_est are the step's counted totals split by time "
        "share: estimates, not per-op counts"
    )
    return table


# -- run-directory glue -----------------------------------------------------------


def find_trace_files(root: str) -> list[str]:
    """Chrome traces under root, newest first."""
    out = []
    for dirpath, _, names in os.walk(root):
        out.extend(os.path.join(dirpath, n) for n in names
                   if n.endswith((".trace.json", ".trace.json.gz")))
    return sorted(out, key=os.path.getmtime, reverse=True)


def load_trace_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def attribute_profile_dir(trace_dir: str) -> dict | None:
    """The attribution table of the newest torch.profiler trace under
    trace_dir that holds op events (a host-span export holds none), or
    None."""
    for path in find_trace_files(trace_dir):
        try:
            events = load_trace_events(path)
        except (OSError, ValueError):
            continue
        table = attribute_events(events)
        if table["rows"]:
            table["trace"] = path
            return table
    return None
