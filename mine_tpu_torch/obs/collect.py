"""Cross-process trace collection, the fleet half (the port's own copy of
mine_tpu/obs/collect.py): N span rings -> one timeline.

Every replica and the fleet router keep their own span ring (obs/trace.py)
and serve it at `GET /debug/trace`. To see where one request's time went
across the wire:

  fetch_member_trace   pull one member's /debug/trace, measuring the round
                       trip and estimating the member's wall-clock skew from
                       the export's clock anchor (recorded, +- rtt/2);
  merge_member_traces  rebase every member's spans onto one wall-clock epoch
                       and give each member its own named process lane;
  request_tree         one request's spans across the lanes, assembled into
                       the cross-process hop tree through the span_id /
                       parent_span args the trace context carries;
  collect_fleet_trace  all of it in one call: the router's aggregated
                       GET /debug/trace?request_id= and the fleet CLI's
                       `trace` subcommand.

The one per-request matching rule is obs/trace.py's filter_doc_to_request.
The training half (training_timeline) is not ported.
"""

from __future__ import annotations

import json
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from mine_tpu_torch.obs.trace import (
    HOST_PROCESS_NAME,
    PARENT_SPAN_ARG,
    SPAN_ID_ARG,
    _matches_request,
)

# the JAX package's producer name, so that each package's merge recognises
# the other's merged docs
MERGED_PRODUCER = "mine_tpu trace merge"


def _http_get_json(url: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def fetch_member_trace(
    name: str,
    base_url: str,
    request_id: str | None = None,
    timeout_s: float = 5.0,
    fetch_fn: Callable[[str, float], dict] | None = None,
    now_fn: Callable[[], float] = time.time,
) -> dict:
    """One member's ring as {"name", "doc", "skew_s", "rtt_s"}, or {"name",
    "error"}. Skew = the member's wall clock minus the collector's, from the
    export's wall timestamp placed at the probe's midpoint (|error| <=
    rtt/2)."""
    url = base_url.rstrip("/") + "/debug/trace"
    if request_id:
        url += "?request_id=" + urllib.parse.quote(request_id, safe="")
    fetch = fetch_fn if fetch_fn is not None else _http_get_json
    t0 = now_fn()
    try:
        doc = fetch(url, timeout_s)
    except Exception as exc:  # noqa: BLE001 - per-member verdicts
        return {"name": name, "error": f"{type(exc).__name__}: {exc}"}
    t1 = now_fn()
    clock = (doc.get("metadata") or {}).get("clock") or {}
    skew = None
    if "exported_unix_s" in clock:
        skew = float(clock["exported_unix_s"]) - (t0 + t1) / 2.0
    return {"name": name, "doc": doc, "skew_s": skew, "rtt_s": t1 - t0}


def _wall_offset(doc: dict, skew_s: float | None) -> float:
    """Seconds to add to ts_us / 1e6 to land the doc's events on the
    collector's wall clock; 0 for a doc without a clock anchor."""
    clock = (doc.get("metadata") or {}).get("clock") or {}
    if "exported_unix_s" not in clock:
        return 0.0
    return (float(clock["exported_unix_s"])
            - float(clock.get("exported_ts_us", 0.0)) / 1e6
            - (skew_s or 0.0))


def _explode_if_merged(member: dict) -> list[dict]:
    """A member whose doc is itself a merged trace (the router's aggregated
    answer) splits back into one member per inner lane, anchored on the
    merged doc's epoch and carrying the outer fetch's skew; merging it as
    one member would fold its lanes onto one pid."""
    doc = member.get("doc") or {}
    meta = doc.get("metadata") or {}
    if meta.get("producer") != MERGED_PRODUCER:
        return [member]
    epoch = float(meta.get("epoch_unix_s", 0.0))
    inner_names = {
        m["pid"]: name
        for name, m in (meta.get("members") or {}).items()
        if isinstance(m, dict) and "pid" in m
    }
    by_pid: dict[Any, list[dict]] = {}
    for ev in doc.get("traceEvents", ()):
        by_pid.setdefault(ev.get("pid"), []).append(ev)
    out: list[dict] = []
    for pid in sorted(by_pid, key=str):
        inner = inner_names.get(pid, f"{member['name']}:pid{pid}")
        events = []
        for ev in by_pid[pid]:
            ev = dict(ev)
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                args = dict(ev.get("args") or {})
                lane = str(args.get("name", HOST_PROCESS_NAME))
                prefix = f"{inner} · "  # the previous merge's, not stacked
                if lane.startswith(prefix):
                    args["name"] = lane[len(prefix):]
                ev["args"] = args
            events.append(ev)
        out.append({
            "name": inner, "_exploded": True,
            "skew_s": member.get("skew_s"), "rtt_s": member.get("rtt_s"),
            "doc": {"traceEvents": events, "metadata": {"clock": {
                "exported_unix_s": epoch, "exported_ts_us": 0.0}}},
        })
    return out


def merge_member_traces(members: list[dict]) -> dict:
    """Members (fetch_member_trace results, or {"name", "doc"[, "skew_s",
    "rtt_s"]} dicts) -> one Chrome-trace doc: one pid lane per member named
    "<member> · <lane>", every ts rebased onto the earliest skew-corrected
    wall instant. Unreachable members are named in metadata. An exploded
    lane that a direct fetch also covers is dropped (the direct fetch has
    its own skew estimate); of two direct members with one name the first
    is kept."""
    exploded: list[dict] = []
    for m in members:
        exploded.extend(_explode_if_merged(m) if "doc" in m else [m])
    direct_names = {m["name"] for m in exploded if "doc" in m and not m.get("_exploded")}
    members = [m for m in exploded if not (m.get("_exploded") and m["name"] in direct_names)]
    seen: set[str] = set()
    deduped: list[dict] = []
    for m in members:
        if "doc" in m and m["name"] in seen:
            deduped.append({"name": f"{m['name']} (duplicate)",
                            "error": "duplicate member name, dropped"})
            continue
        seen.add(m["name"])
        deduped.append(m)
    members = deduped
    events: list[dict] = []
    meta_members: dict[str, dict] = {}
    offsets: list[tuple[dict, float]] = []
    epoch: float | None = None
    for m in (m for m in members if "doc" in m):
        off = _wall_offset(m["doc"], m.get("skew_s"))
        offsets.append((m, off))
        for ev in m["doc"].get("traceEvents", ()):
            if ev.get("ph") == "X":
                wall = off + float(ev.get("ts", 0.0)) / 1e6
                epoch = wall if epoch is None else min(epoch, wall)
    if epoch is None:
        epoch = 0.0
    for i, (m, off) in enumerate(offsets):
        pid = i + 1
        doc = m["doc"]
        meta = doc.get("metadata") or {}
        meta_members[m["name"]] = {
            "pid": pid,
            "skew_s": m.get("skew_s"),
            "rtt_s": m.get("rtt_s"),
            "dropped_spans": meta.get("dropped_spans", 0),
            "clock_anchored": bool((meta.get("clock") or {}).get("exported_unix_s")),
        }
        named = False
        for ev in doc.get("traceEvents", ()):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    args = dict(ev.get("args") or {})
                    args["name"] = f"{m['name']} · " + str(args.get("name", HOST_PROCESS_NAME))
                    ev["args"] = args
                    named = True
            elif ev.get("ph") in ("X", "C", "I"):
                ev["ts"] = round((off + float(ev.get("ts", 0.0)) / 1e6 - epoch) * 1e6, 3)
            events.append(ev)
        if not named:
            events.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                           "args": {"name": f"{m['name']} · {HOST_PROCESS_NAME}"}})
    for m in members:
        if "doc" not in m:
            meta_members[m["name"]] = {"error": m.get("error", "unreachable")}
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "metadata": {"producer": MERGED_PRODUCER, "epoch_unix_s": epoch,
                     "members": meta_members},
    }


def request_tree(doc: dict, request_id: str) -> dict:
    """One request's spans out of a doc, and its cross-process hop tree.
    Tree nodes are the spans with a span_id and/or parent_span arg (the
    hops the trace context crossed); a parent that was never seen (its ring
    dropped it) makes its child a root."""
    pid_names: dict[Any, str] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev.get("pid")] = (ev.get("args") or {}).get("name", "?")
    kept = [ev for ev in doc.get("traceEvents", ()) if _matches_request(ev, request_id)]
    nodes: dict[str, dict] = {}
    ordered: list[dict] = []
    for ev in kept:
        args = ev.get("args") or {}
        sid, parent = args.get(SPAN_ID_ARG), args.get(PARENT_SPAN_ARG)
        if sid is None and parent is None:
            continue
        node = {
            "name": ev.get("name"),
            "process": pid_names.get(ev.get("pid"), str(ev.get("pid"))),
            "span_id": sid,
            "parent_span": parent,
            "ts_us": ev.get("ts"),
            "dur_us": ev.get("dur"),
            "children": [],
        }
        if sid is not None:
            nodes[sid] = node
        ordered.append(node)
    roots: list[dict] = []
    for node in ordered:
        parent = node["parent_span"]
        if parent is not None and parent in nodes and nodes[parent] is not node:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)
    return {
        "request_id": request_id,
        "processes": sorted({pid_names.get(ev.get("pid"), str(ev.get("pid")))
                             for ev in kept}),
        "span_count": len(kept),
        "tree": roots,
        "events": kept,
    }


def tree_depth(tree: list[dict]) -> int:
    """The longest root-to-leaf hop chain."""
    if not tree:
        return 0
    return 1 + max(tree_depth(n["children"]) for n in tree)


def collect_fleet_trace(
    members: dict[str, str],
    request_id: str | None = None,
    local: dict | None = None,
    timeout_s: float = 5.0,
    fetch_fn: Callable[[str, float], dict] | None = None,
) -> dict:
    """Pull every member's ring (filtered to one request when given) and
    merge. `local` is a doc already in hand ({"name", "doc"}: the router's
    own ring, skew 0). The members are fetched concurrently, so K
    unreachable replicas cost about one timeout, not K."""
    fetched = [local] if local else []
    if members:
        with ThreadPoolExecutor(max_workers=min(8, len(members)),
                                thread_name_prefix="mine-trace-fetch") as pool:
            fetched.extend(pool.map(
                lambda item: fetch_member_trace(item[0], item[1], request_id=request_id,
                                                timeout_s=timeout_s, fetch_fn=fetch_fn),
                list(members.items()),
            ))
    doc = merge_member_traces(fetched)
    if request_id:
        doc["metadata"]["request_id"] = request_id
        doc["metadata"]["request_tree"] = {
            k: v for k, v in request_tree(doc, request_id).items() if k != "events"
        }
    return doc
