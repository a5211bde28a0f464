"""The port's serving building blocks against the JAX package's, driven by
the same scripted sequences: the metrics registry (identical exposition
text), the MPI cache (eviction order, bytes, key strings), the micro-batcher
(groups, pose ceiling, errors, admission control), the circuit breaker
(states under an injected clock and seed) and the span tracer (the
Chrome-trace structure). No model is involved."""

import threading
import time

import numpy as np
import pytest
import torch

from mine_tpu.obs import memlog as jmemlog
from mine_tpu.obs import trace as jtrace
from mine_tpu.obs.collect import filter_doc_to_request as jax_filter
from mine_tpu.resilience import breaker as jbreaker
from mine_tpu.serving import batcher as jbatcher
from mine_tpu.serving import cache as jcache
from mine_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from mine_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from mine_tpu_torch.obs import memlog as tmemlog
from mine_tpu_torch.obs import trace as ttrace
from mine_tpu_torch.resilience import breaker as tbreaker
from mine_tpu_torch.serving import batcher as tbatcher
from mine_tpu_torch.serving import cache as tcache
from mine_tpu_torch.serving.metrics import ServingMetrics
from mine_tpu_torch.utils.metrics import MetricsRegistry


# -- metrics registry -----------------------------------------------------------


def _script_registry(reg):
    c = reg.counter("req_total", "requests")
    c.inc(endpoint="render", status="200")
    c.inc(3, endpoint="predict", status="200")
    c.inc(endpoint="render", status="503")
    g = reg.gauge("bytes_resident", "bytes")
    g.set(12345678)
    g.set(2.5, tier="int8")
    g.inc(0.25, tier="int8")
    g.dec(1, tier="bf16")
    h = reg.histogram("latency_seconds", "latency")
    for v in (0.0004, 0.003, 0.003, 0.07, 0.9, 42.0, 100.0):
        h.observe(v, endpoint="render")
    h.observe(0.02, endpoint="predict")
    hc = reg.histogram("custom_seconds", "custom edges", buckets=(0.1, 1.0))
    hc.observe(0.5)
    s = reg.summary("window", "window", window=4)
    for v in (5, 1, 4, 2, 3, 9):
        s.observe(v, kind="a")
    reg.counter("req_total", "requests").inc(endpoint="render", status="200")  # re-register
    return reg


def test_metrics_registry_renders_the_same_text():
    got = _script_registry(MetricsRegistry())
    want = _script_registry(JaxRegistry())
    assert got.render() == want.render()
    h, jh = got._families["latency_seconds"], want._families["latency_seconds"]
    for q in (0.5, 0.95, 0.99):
        assert h.quantile(q, endpoint="render") == jh.quantile(q, endpoint="render")
    with pytest.raises(ValueError):
        got.gauge("req_total", "a counter already")
    with pytest.raises(ValueError):
        got._families["req_total"].inc(-1)


def test_serving_metric_families_are_the_jax_families():
    """Every family the port exports is a JAX family of the same type."""
    ours = ServingMetrics().registry._families
    theirs = JaxServingMetrics().registry._families
    assert set(ours) <= set(theirs)
    assert {n: f.kind for n, f in ours.items()} == {n: theirs[n].kind for n in ours}
    # the cost gauges came with obs/cost.py: the port exports every family
    assert set(theirs) - set(ours) == set()


def test_rate_gauge_matches():
    ours, theirs = ServingMetrics(), JaxServingMetrics()
    for m in (ours, theirs):
        for t, n in ((0.0, 5), (0.5, 3), (10.0, 8), (45.0, 1)):
            m.renders_per_sec.record(n, now=t)
    assert ours.renders_per_sec.refresh(now=46.0) == theirs.renders_per_sec.refresh(now=46.0)


# -- MPI cache --------------------------------------------------------------------


def _entries(s: int, h: int = 2, w: int = 2):
    shapes = [(1, s, h, w, 3), (1, s, h, w, 1), (1, s), (1, 3, 3)]
    torch_entry = tcache.MPIEntry(*(torch.zeros(sh) for sh in shapes), (h, w, s))
    jax_entry = jcache.MPIEntry(*(np.zeros(sh, np.float32) for sh in shapes), (h, w, s))
    return torch_entry, jax_entry


def test_cache_eviction_order_bytes_and_keys_match():
    per = _entries(2)[0].nbytes
    caches = {"port": (tcache, tcache.MPICache(3 * per, metrics=ServingMetrics())),
              "jax": (jcache, jcache.MPICache(3 * per, metrics=JaxServingMetrics()))}
    script = [("put", 0, 2), ("put", 1, 2), ("put", 2, 2), ("get", 0, 0), ("put", 3, 2),
              ("get", 1, 0), ("put", 4, 8), ("put", 5, 2), ("put", 5, 2), ("get", 5, 0),
              ("put", 6, 1)]
    trace = {}
    for name, (mod, cache) in caches.items():
        log = []
        for op, i, s in script:
            key = mod.mpi_key(f"img{i}", 7, (2, 2, 2), "int8" if i % 2 else "fp32")
            if op == "put":
                entry = _entries(s)[0 if name == "port" else 1]
                log.append(("evicted", [mod.key_to_str(k) for k in cache.put(key, entry)]))
            else:
                log.append(("hit", cache.get(key) is not None))
            log.append((cache.bytes_resident, len(cache)))
        metrics = cache._metrics
        log.append([metrics.cache_hits.value(), metrics.cache_misses.value(),
                    metrics.cache_evictions.value(), metrics.cache_bytes_resident.value(),
                    metrics.cache_entries.value()])
        trace[name] = (log, [mod.key_to_str(k) for k in cache.keys()])
    assert trace["port"] == trace["jax"]


@pytest.mark.parametrize("wire", [
    "a" * 64 + ":1234:384:512:32:int8", "d:0:128:128:4:fp32", "d:7:128:256:8",
])
def test_cache_keys_parse_alike(wire):
    assert tcache.key_from_str(wire) == jcache.key_from_str(wire)
    assert tcache.key_to_str(tcache.key_from_str(wire)) == \
        jcache.key_to_str(jcache.key_from_str(wire))
    with pytest.raises(ValueError):
        tcache.key_from_str("garbage")


# -- micro-batcher ----------------------------------------------------------------


def _poses(tag: float, n: int) -> np.ndarray:
    p = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    p[:, 0, 3] = tag + np.arange(n)
    return p


def _run_batcher(mod, requests, fail_key=None, **kw):
    """Submit every request before the worker starts, so that the groups are
    decided by the sweep alone; returns the dispatches and each outcome."""
    dispatched = []

    def render(entry, poses):
        dispatched.append((entry, poses.shape[0], poses[:, 0, 3].tolist()))
        if entry == fail_key:
            raise RuntimeError(f"engine failed on {entry}")
        return poses[:, :3, 3].reshape(-1, 1, 1, 3), poses[:, :1, :1].reshape(-1, 1, 1, 1)

    b = mod.MicroBatcher(render, max_delay_ms=0.0, **kw)
    futures = [b.submit(key, key, _poses(10 * i, n)) for i, (key, n) in enumerate(requests)]
    b.start()
    outcomes = []
    for f in futures:
        try:
            rgb, _ = f.result(timeout=30)
            outcomes.append(rgb[:, 0, 0, 0].tolist())
        except RuntimeError as exc:
            outcomes.append(f"{type(exc).__name__}: {exc}")
    b.stop()
    return dispatched, outcomes


@pytest.mark.parametrize("case", ["coalesce", "pose_ceiling", "error"])
def test_batcher_groups_match(case):
    requests = [("a", 1), ("b", 2), ("a", 2), ("a", 1), ("b", 3), ("a", 5), ("c", 1),
                ("a", 1)]
    kw = {"max_batch_poses": 64 if case == "coalesce" else 4}
    fail = "b" if case == "error" else None
    got = _run_batcher(tbatcher, requests, fail, **kw)
    want = _run_batcher(jbatcher, requests, fail, **kw)
    assert got == want
    if case == "coalesce":
        assert [d[0] for d in got[0]] == ["a", "b", "c"]
    if case == "error":
        assert got[1][1] == got[1][4] == "RuntimeError: engine failed on b"


@pytest.mark.parametrize("mod", [tbatcher, jbatcher], ids=["port", "jax"])
def test_batcher_admission_control(mod):
    b = mod.MicroBatcher(lambda e, p: (p, p), max_delay_ms=0.0, max_queue_requests=3,
                         metrics=ServingMetrics() if mod is tbatcher else JaxServingMetrics())
    head = b.submit("k", "k", _poses(2, 1))
    late = b.submit("k", "k", _poses(0, 1), deadline=time.monotonic() - 1.0)
    b.submit("k", "k", _poses(1, 1))
    with pytest.raises(mod.QueueFull, match="3 pending >= bound 3"):
        b.submit("k", "k", _poses(3, 1))
    assert b.cancel(head) and b.queue_depth() == 2
    b.start()
    with pytest.raises(mod.DeadlineExceeded):
        late.result(timeout=30)
    b.stop()
    with pytest.raises(mod.BatcherStopped):
        b.submit("k", "k", _poses(4, 1))
    stranded = mod.MicroBatcher(lambda e, p: (p, p))
    f = stranded.submit("k", "k", _poses(5, 1))
    stranded.stop()  # never started: the pending request fails typed
    with pytest.raises(mod.BatcherStopped):
        f.result(timeout=1)
    assert b._metrics.shed_requests.value(reason="queue_full") == 1
    assert b._metrics.request_timeouts.value(stage="queue") == 1


def test_batcher_cancels_a_request_behind_others():
    """cancel() finds its request by identity. The JAX batcher's _Pending
    compares by value, so cancelling a request queued behind another raises
    there (numpy's ambiguous truth value of the pose arrays)."""
    for mod, raises in ((tbatcher, False), (jbatcher, True)):
        b = mod.MicroBatcher(lambda e, p: (p, p))
        first = b.submit("k", "k", _poses(0, 1))
        second = b.submit("k", "k", _poses(1, 1))
        if raises:
            with pytest.raises(ValueError, match="ambiguous"):
                b.cancel(second)
        else:
            assert b.cancel(second) and b.queue_depth() == 1
            assert not b.cancel(second)
        b.stop()
        with pytest.raises(mod.BatcherStopped):
            first.result(timeout=1)


def test_batcher_coalesces_concurrent_submissions():
    """Requests arriving inside the window share a dispatch (port only: the
    timing makes the group sizes, not the sweep)."""
    seen = []
    b = tbatcher.MicroBatcher(lambda e, p: (seen.append(p.shape[0]) or p, p),
                              max_delay_ms=50.0).start()
    barrier = threading.Barrier(6)
    results = []

    def client(i):
        barrier.wait()
        results.append(b.submit("k", "k", _poses(i, 1)).result(timeout=30)[0][0, 0, 3])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    b.stop()
    assert sorted(results) == list(range(6)) and sum(seen) == 6 and len(seen) < 6


# -- circuit breaker --------------------------------------------------------------


def _breaker_trace(mod, seed):
    now = [0.0]
    states = []
    b = mod.CircuitBreaker(failure_threshold=2, reset_after_s=10.0, clock=lambda: now[0],
                           on_state=states.append, reset_jitter=0.3, jitter_seed=seed)
    log = []
    for op, arg in [("fail", 0), ("allow", 0), ("fail", 0), ("allow", 0), ("tick", 5.0),
                    ("reject", 0), ("retry", 0), ("tick", 7.5), ("state", 0), ("allow", 0),
                    ("allow", 0), ("fail", 0), ("retry", 0), ("tick", 13.5), ("allow", 0),
                    ("ok", 0), ("state", 0), ("fail", 0), ("fail", 0), ("retry", 0)]:
        if op == "fail":
            b.record_failure()
        elif op == "ok":
            b.record_success()
        elif op == "tick":
            now[0] += arg
        elif op == "allow":
            log.append(b.allow())
        elif op == "reject":
            log.append(b.rejecting())
        elif op == "retry":
            log.append(round(b.retry_after_s(), 9))
        else:
            log.append(b.state)
    return log, states, b.trips


@pytest.mark.parametrize("seed", [1, 7, 123])
def test_breaker_states_match(seed):
    assert _breaker_trace(tbreaker, seed) == _breaker_trace(jbreaker, seed)
    with pytest.raises(ValueError):
        tbreaker.CircuitBreaker(reset_jitter=1.0)
    disabled = tbreaker.CircuitBreaker(failure_threshold=0)
    for _ in range(10):
        disabled.record_failure()
    assert disabled.allow() and disabled.state == "closed"


# -- span tracer ------------------------------------------------------------------


def _script_tracer(mod):
    tracer = mod.Tracer(enabled=True, max_spans=5)
    with tracer.span("request", cat="serve", request_id="r1"):
        with tracer.span("parse", cat="serve", request_id="r1", n=3):
            pass
    t0 = time.perf_counter()
    tracer.record("queue_wait", "serve", t0 - 0.01, t0, request_ids="r1,r2")
    tracer.record("dispatch", "serve", t0, t0 + 0.002, request_ids="r2", obj=object)
    for i in range(3):
        with tracer.span("encode", cat="serve", request_id="r2", frames=i):
            pass
    return tracer


def _structure(doc):
    keep = ("ph", "name", "cat", "args")
    return [{k: ev[k] for k in keep if k in ev and not (k == "args" and ev["ph"] == "M"
                                                         and ev["name"] == "thread_name")}
            for ev in doc["traceEvents"]]


def test_tracer_chrome_trace_structure_matches():
    ours, theirs = _script_tracer(ttrace), _script_tracer(jtrace)
    a, b = ours.to_chrome_trace(), theirs.to_chrome_trace()
    assert _structure(a) == _structure(b)
    assert a["metadata"].keys() == b["metadata"].keys()
    assert a["metadata"]["dropped_spans"] == b["metadata"]["dropped_spans"] == 2
    assert len(ours) == 5 and ours.phase_summary().keys() == theirs.phase_summary().keys()
    for rid in ("r1", "r2", "nobody"):
        assert _structure(ttrace.filter_doc_to_request(a, rid)) == \
            _structure(jax_filter(b, rid))
    assert ttrace.Tracer().span("x") is ttrace.Tracer().span("y")  # the shared no-op


@pytest.mark.parametrize("raw", ["abc-123.x_Y", None, "", "bad id\n", "x" * 200])
def test_trace_context_headers_resolve_alike(raw):
    assert ttrace.resolve_parent_span(raw) == jtrace.resolve_parent_span(raw)
    got = ttrace.resolve_request_id(raw)
    want = jtrace.resolve_request_id(raw)
    if raw and ttrace.TRACE_TOKEN_RE.match(raw):
        assert got == want == raw
    else:
        assert len(got) == len(want) == 16 and got != raw
    assert ttrace.REQUEST_ID_HEADER == jtrace.REQUEST_ID_HEADER
    assert ttrace.PARENT_SPAN_HEADER == jtrace.PARENT_SPAN_HEADER


def test_memlog_samples_gauges_and_counter_events_alike():
    """The same stats through both MemLogs: the same gauges, samples and
    Chrome counter events; no stats (a CPU device) sets no gauge."""
    feed = [[{"device": "d0", "stats": {"bytes_in_use": 10, "peak_bytes_in_use": 30}}],
            [{"device": "d0", "stats": {"bytes_in_use": 25, "peak_bytes_in_use": 40}}]]
    logs = {}
    for name, mod, metrics in (("port", tmemlog, ServingMetrics()),
                               ("jax", jmemlog, JaxServingMetrics())):
        it = iter(feed)
        log = mod.MemLog(live_gauge=metrics.hbm_live_bytes, peak_gauge=metrics.hbm_peak_bytes,
                         stats_fn=lambda it=it: next(it))
        samples = [log.sample(step=i) for i in range(2)]
        events = log.counter_events(pid=1)
        logs[name] = ([{k: s[k] for k in ("step", "live_bytes", "peak_bytes")} for s in samples],
                      [{k: e[k] for k in ("ph", "pid", "name", "args")} for e in events],
                      metrics.hbm_live_bytes.value(), metrics.hbm_peak_bytes.value(),
                      sorted(log.last()))
    assert logs["port"] == logs["jax"]
    cpu = ServingMetrics()
    log = tmemlog.MemLog(live_gauge=cpu.hbm_live_bytes, device="cpu")
    assert tmemlog.device_memory_stats("cpu") == [] and log.sample() is None
    assert "mine_serve_hbm_live_bytes{" not in cpu.render() and len(log) == 0
