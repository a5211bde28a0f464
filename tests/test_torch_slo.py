"""The port's SLO tracker (mine_tpu_torch/obs/slo.py) against the JAX
package's (mine_tpu/obs/slo.py): the same counter and histogram
observations, made from a seed with numpy, on the same fake clock, give the
same `mine_slo_*` gauges and verdicts, and the same /metrics pages give the
same exposition readings. Tolerance: rtol 1e-12 (both sum the same float64
values in the same order); the live-HTTP cases check names only.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from mine_tpu.config import Config as JaxConfig
from mine_tpu.obs import slo as jslo
from mine_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from mine_tpu_torch.config import Config
from mine_tpu_torch.obs import slo as tslo
from mine_tpu_torch.utils.metrics import MetricsRegistry

RTOL = 1e-12
ENDPOINTS = ("predict", "render", "mpi", "healthz", "metrics")
STATUSES = ("200", "200", "200", "404", "500", "503", "504")


def _objectives(mod, window_s=30.0):
    return (
        mod.Objective(name="availability", kind="availability",
                      family="req_total", target=0.99, window_s=window_s),
        mod.Objective(name="latency_p95", kind="latency", family="lat_seconds",
                      target=0.95, threshold_s=0.07, window_s=window_s),
        mod.Objective(name="strict", kind="availability", family="req_total",
                      target=0.9, exempt_statuses=(), endpoints=("render",),
                      window_s=window_s),
        mod.Objective(name="past_buckets", kind="latency", family="lat_seconds",
                      target=0.5, threshold_s=100.0, window_s=window_s),
    )


def _pair(window_s=30.0):
    """(port, jax) trackers over fresh registries on one shared fake clock."""
    clock = [0.0]
    out = []
    for mod, reg_cls in ((tslo, MetricsRegistry), (jslo, JaxRegistry)):
        reg = reg_cls()
        counter = reg.counter("req_total", "requests")
        hist = reg.histogram("lat_seconds", "latency")
        tracker = mod.SLOTracker(reg, _objectives(mod, window_s), clock=lambda: clock[0])
        out.append((reg, counter, hist, tracker))
    return out, clock


def _observe(pair, rng, n):
    endpoints = rng.integers(0, len(ENDPOINTS), n)
    statuses = rng.integers(0, len(STATUSES), n)
    latencies = rng.lognormal(-3.0, 1.5, n)  # past the last bucket too
    for reg, counter, hist, _ in pair:
        for e, s, v in zip(endpoints, statuses, latencies):
            counter.inc(endpoint=ENDPOINTS[e], status=STATUSES[s])
            hist.observe(float(v), endpoint=ENDPOINTS[e])


def _gauges(reg):
    return {(name, labels): value
            for name in ("mine_slo_compliance", "mine_slo_burn_rate",
                         "mine_slo_error_budget_remaining")
            for labels, value in reg._families[name]._children.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rolling_window_gauges_and_verdicts_match_jax(seed):
    rng = np.random.default_rng(seed)
    (port, jax_), clock = _pair(window_s=30.0)
    for step in range(8):
        _observe((port, jax_), rng, int(rng.integers(0, 60)))
        clock[0] += float(rng.uniform(2.0, 12.0))
        got, want = port[3].evaluate(), jax_[3].evaluate()
        assert got == want, f"step {step}"
        g, w = _gauges(port[0]), _gauges(jax_[0])
        assert set(g) == set(w) and len(g) == 12
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0, err_msg=str(k))


def test_empty_window_is_a_vacuous_pass_in_both():
    (port, jax_), clock = _pair()
    clock[0] = 5.0
    assert port[3].evaluate() == jax_[3].evaluate()
    assert all(v["compliance"] == 1.0 and v["burn_rate"] == 0.0
               for v in port[3].evaluate().values())


@pytest.mark.parametrize("kwargs", [
    dict(name="a", kind="bogus", family="f", target=0.9),
    dict(name="a", kind="availability", family="f", target=0.0),
    dict(name="a", kind="availability", family="f", target=1.5),
    dict(name="a", kind="latency", family="f", target=0.95, threshold_s=0.0),
])
def test_objective_validation_matches_jax(kwargs):
    for mod in (tslo, jslo):
        with pytest.raises(ValueError):
            mod.Objective(**kwargs)


def test_tracker_refuses_what_jax_refuses():
    for mod, reg_cls in ((tslo, MetricsRegistry), (jslo, JaxRegistry)):
        with pytest.raises(ValueError):
            mod.SLOTracker(reg_cls(), ())
        objs = mod.default_objectives()
        with pytest.raises(ValueError, match="duplicate"):
            mod.SLOTracker(reg_cls(), objs + objs[:1])
        reg = reg_cls()
        reg.counter("mine_serve_request_latency_seconds", "a counter, not a histogram")
        with pytest.raises(TypeError, match="latency needs a histogram"):
            mod.SLOTracker(reg, mod.default_objectives())


def test_tracker_from_config_reads_the_serving_knobs_like_jax():
    knobs = {"serving.slo_availability_target": 0.98, "serving.slo_p95_ms": 250.0,
             "serving.slo_window_s": 42.0}
    got = tslo.tracker_from_config(MetricsRegistry(), Config().replace(**knobs),
                                   family_prefix="mine_fleet").objectives
    want = jslo.tracker_from_config(JaxRegistry(), JaxConfig().replace(**knobs),
                                    family_prefix="mine_fleet").objectives
    assert [vars(o) for o in got] == [vars(o) for o in want]
    assert got[1].threshold_s == 0.25 and got[0].family == "mine_fleet_requests_total"


def _pages():
    """/metrics pages: hand-written edge cases and two rendered registries."""
    pages = [
        "",
        'mine_slo_burn_rate{slo="availability"} 2.5\n'
        'mine_slo_burn_rate{slo="latency_p95"} 0.125\n'
        'mine_slo_burn_rate_other{slo="decoy"} 9.0\n'
        "mine_fleet_degradation_level 2\n"
        "mine_fleet_degradation_level_other 9\n"
        'mine_fleet_request_latency_seconds_bucket{endpoint="render",le="0.1"} 50\n'
        'mine_fleet_request_latency_seconds_bucket{endpoint="render",le="1.0"} 100\n'
        'mine_fleet_request_latency_seconds_bucket{endpoint="render",le="+Inf"} 100\n'
        'mine_fleet_request_latency_seconds_bucket{endpoint="healthz",le="+Inf"} 999\n',
        'mine_fleet_request_latency_seconds_bucket{endpoint="render",le="0.5"} 1\n'
        'mine_fleet_request_latency_seconds_bucket{endpoint="render",le="+Inf"} 10\n'
        "# TYPE mine_slo_burn_rate gauge\nmine_slo_burn_rate{slo=\"x\"} nan-ish\n",
    ]
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        (port, _), clock = _pair()
        reg = port[0]
        hist = reg.histogram("mine_fleet_request_latency_seconds", "router latency")
        level = reg.gauge("mine_fleet_degradation_level", "ladder")
        for v, e in zip(rng.lognormal(-2.0, 1.0, 200), rng.integers(0, 5, 200)):
            hist.observe(float(v), endpoint=ENDPOINTS[e])
        level.set(float(rng.integers(0, 4)))
        _observe((port,), rng, 80)
        clock[0] = 10.0
        port[3].evaluate()
        pages.append(reg.render())
    return pages


@pytest.mark.parametrize("page", range(5))
def test_exposition_readers_match_jax(page):
    text = _pages()[page]
    assert tslo.burn_rates_from_exposition(text) == jslo.burn_rates_from_exposition(text)
    assert (tslo.degradation_from_exposition(text)
            == jslo.degradation_from_exposition(text))
    for kw in ({}, {"endpoints": ("render",)}, {"q": 0.5}, {"family": "lat_seconds"}):
        got, want = tslo.p95_from_exposition(text, **kw), jslo.p95_from_exposition(text, **kw)
        assert (got is None) == (want is None), kw
        if got is not None:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    if page == 1:
        assert tslo.p95_from_exposition(text) == pytest.approx(0.91)


def test_slo_gauges_on_replica_and_router_scrapes():
    """A live fake replica and a router both publish the mine_slo_* gauges
    on every /metrics scrape."""
    from mine_tpu_torch.serving.fake import make_fake_app
    from mine_tpu_torch.serving.fleet import FleetApp, make_fleet_server
    from mine_tpu_torch.serving.server import make_server

    app = make_fake_app(device="cpu")
    srv = make_server(app)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = "http://%s:%d" % srv.server_address[:2]
    fleet = FleetApp({"r0": url}, probe_interval_s=3600)
    fsrv = make_fleet_server(fleet)
    threading.Thread(target=fsrv.serve_forever, daemon=True).start()
    base = "http://%s:%d" % fsrv.server_address[:2]
    try:
        for target in (url, base):
            with urllib.request.urlopen(target + "/healthz", timeout=10) as resp:
                assert json.loads(resp.read())["status"] == "ok"
            with urllib.request.urlopen(target + "/metrics", timeout=10) as resp:
                text = resp.read().decode()
            burns = tslo.burn_rates_from_exposition(text)
            assert set(burns) == {"availability", "latency_p95"}, target
            for family in ("mine_slo_compliance", "mine_slo_error_budget_remaining",
                           "mine_build_info"):
                assert f"# TYPE {family} gauge" in text
    finally:
        fsrv.shutdown()
        fsrv.server_close()
        fleet.close()
        srv.shutdown()
        srv.server_close()
        app.close()
