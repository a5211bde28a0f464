"""The port's HTTP server (ServingApp behind make_server on port 0) against
the JAX package's ServingApp on the same weights and the same PNG, at
128x128, S=4, ResNet-18, fp32: frames, response fields, /healthz and
/metrics names, the wire, hot swaps, and the honest 503/504 answers.

Tolerance: decoded /render frames within 1 LSB of the JAX server's (the
frames agree to 1e-3 before the uint8 rounding, tests/test_torch_slice.py,
so a value near a rounding edge can land one code apart).
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from mine_tpu.config import Config as JaxConfig
from mine_tpu.serving import compress as jc
from mine_tpu.serving import server as jserver
from mine_tpu.serving.server import ServingApp as JaxApp
from mine_tpu.serving.server import make_server as jax_make_server
from mine_tpu.training.step import build_model as jax_build_model
from mine_tpu_torch.config import Config
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.serving import compress as tc
from mine_tpu_torch.serving import server as tserver
from mine_tpu_torch.serving.cache import key_from_str
from mine_tpu_torch.serving.server import ServingApp, make_server
from tests.test_torch_model import random_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
S = 4
TINY = {"data.img_h": H, "data.img_w": W, "model.num_layers": 18,
        "model.dtype": "float32", "mpi.num_bins_coarse": S}
OFFSETS = [[0.02, 0.0, 0.0], [0.0, -0.015, 0.01], [-0.01, 0.01, 0.05]]


def _http(base, path, data=None, headers=None, timeout=120):
    req = urllib.request.Request(base + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as err:
        return err.code, err.read(), err.headers


def _json(base, path, obj, headers=None):
    code, body, hdrs = _http(base, path, json.dumps(obj).encode(),
                             {"Content-Type": "application/json", **(headers or {})})
    return code, json.loads(body), hdrs


def _serve(app, make):
    server = make(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, "http://%s:%d" % server.server_address[:2]


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig().replace(**TINY)
    variables = random_jax_variables(jax_build_model(jcfg), jnp.zeros((1, H, W, 3)),
                                     jnp.ones((1, S)), seed=11)
    return variables, jax_variables_to_torch(flatten_variables(variables), 18)


@pytest.fixture(scope="module")
def png():
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (H, W, 3), dtype=np.uint8)
                    ).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def servers(weights):
    variables, state = weights
    swaps = {"source": None}
    port = ServingApp(Config().replace(**TINY), state, checkpoint_step=0, device="cpu",
                      swap_source=lambda: swaps["source"]())
    jax_app = JaxApp(JaxConfig().replace(**TINY), variables["params"],
                     variables["batch_stats"])
    servers_ = [_serve(port, make_server), _serve(jax_app, jax_make_server)]
    yield {"port": (port, servers_[0][1]), "jax": (jax_app, servers_[1][1]),
           "state": state, "swaps": swaps}
    for server, _ in servers_:
        server.shutdown()
        server.server_close()
    port.close()
    jax_app.close()


def _frames(body):
    return np.stack([np.asarray(Image.open(io.BytesIO(base64.b64decode(f))))
                     for f in body["frames_png_b64"]])


def test_predict_and_render_match_jax_within_one_lsb(servers, png):
    out = {}
    for name in ("port", "jax"):
        app, base = servers[name]
        code, pred, _ = _http(base, "/predict", png, {"Content-Type": "image/png"})
        assert code == 200, pred
        pred = json.loads(pred)
        code, render, _ = _json(base, "/render", {"mpi_key": pred["mpi_key"],
                                                  "offsets": OFFSETS,
                                                  "include_disparity": True})
        assert code == 200, render
        out[name] = (pred, render)
    (pred, render), (jpred, jrender) = out["port"], out["jax"]
    assert pred == {**jpred, "cached": pred["cached"]}  # the same key string, fields
    assert set(render) == set(jrender)
    assert (render["num_frames"], render["height"], render["width"]) == (3, H, W)
    got, want = _frames(render), _frames(jrender)
    assert got.shape == want.shape == (3, H, W, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert len(render["disparity_png_b64"]) == 3


def test_predict_repeats_and_concurrent_misses_run_the_encoder_once(servers):
    app, base = servers["port"]
    buf = io.BytesIO()
    Image.fromarray(np.full((90, 70, 3), 77, np.uint8)).save(buf, format="PNG")
    before = app.metrics.encoder_invocations.value()
    results = []

    def client():
        results.append(_http(base, "/predict", buf.getvalue(),
                             {"Content-Type": "image/png"})[:2])

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [c for c, _ in results] == [200] * 4
    assert len({json.loads(b)["mpi_key"] for _, b in results}) == 1
    assert app.metrics.encoder_invocations.value() == before + 1
    code, body, _ = _json(base, "/predict", {"image_b64": base64.b64encode(
        buf.getvalue()).decode(), "bucket": [H, W, S]})
    assert code == 200 and body["cached"]


def test_healthz_and_metrics_carry_the_jax_names(servers, png):
    names = {}
    for name in ("port", "jax"):
        _, base = servers[name]
        code, health, _ = _http(base, "/healthz")
        assert code == 200
        code, text, hdrs = _http(base, "/metrics")
        assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
        families = {ln.split()[2]: ln.split()[3] for ln in text.decode().splitlines()
                    if ln.startswith("# TYPE")}
        names[name] = (json.loads(health), families)
    (health, families), (jhealth, jfamilies) = names["port"], names["jax"]
    assert set(health) == set(jhealth)
    assert health["backend"] == "cpu" and health["status"] == "ok"
    assert set(families) <= set(jfamilies)
    assert all(families[f] == jfamilies[f] for f in families)
    for family in ("mine_serve_requests_total", "mine_serve_encoder_invocations_total",
                   "mine_serve_cache_bytes_resident", "mine_build_info",
                   "mine_serve_batch_dispatches_total", "mine_serve_weight_generation"):
        assert family in families


def test_get_mpi_parses_in_both_packages(servers, png):
    app, base = servers["port"]
    code, pred, _ = _http(base, "/predict", png, {"Content-Type": "image/png"})
    key = json.loads(pred)["mpi_key"]
    code, blob, hdrs = _http(base, "/mpi/" + key)
    assert code == 200 and hdrs["Content-Type"] == "application/octet-stream"
    entry = app.cache.get(key_from_str(key), record=False)
    theirs = jc.from_wire(blob)
    np.testing.assert_array_equal(theirs.mpi_rgb, entry.mpi_rgb.numpy())
    np.testing.assert_array_equal(theirs.mpi_sigma, entry.mpi_sigma.numpy())
    assert tuple(theirs.bucket) == (H, W, S)
    # and the JAX server's blob of the same key parses in the port
    _, jbase = servers["jax"]
    _http(jbase, "/predict", png, {"Content-Type": "image/png"})
    code, jblob, _ = _http(jbase, "/mpi/" + key)
    assert code == 200
    ours = tc.from_wire(jblob)
    np.testing.assert_allclose(ours.mpi_rgb.numpy(), entry.mpi_rgb.numpy(), atol=1e-3)
    assert _http(base, "/mpi/" + key.replace(key[:8], "00000000"))[0] == 404
    assert _http(base, "/mpi/not-a-key")[0] == 400


def test_admin_swap_async_wait_and_mismatch(servers, png):
    app, base = servers["port"]
    state = servers["state"]
    gen0 = app.engine.generation
    code, pred, _ = _http(base, "/predict", png, {"Content-Type": "image/png"})
    old_key = json.loads(pred)["mpi_key"]

    gen = torch.Generator().manual_seed(1)
    new = {k: (v + 1e-3 * torch.randn(v.shape, generator=gen) if v.dim() == 4 else v)
           for k, v in state.items()}
    servers["swaps"]["source"] = lambda: (new, 10)
    code, status, _ = _json(base, "/admin/swap", {})
    assert code == 202 and status["state"] == "in_progress"
    deadline = time.monotonic() + 60
    while _http(base, "/admin/swap")[1] and json.loads(
            _http(base, "/admin/swap")[1])["state"] == "in_progress":
        assert time.monotonic() < deadline
        time.sleep(0.05)
    code, status, _ = _http(base, "/admin/swap")
    status = json.loads(status)
    assert code == 200 and status["state"] == "ok" and status["swapped_to_step"] == 10
    assert app.engine.generation == gen0 + 1

    servers["swaps"]["source"] = lambda: (state, 11)
    code, status, _ = _json(base, "/admin/swap", {"wait": True})
    assert code == 200 and status["state"] == "ok" and app.engine.generation == gen0 + 2
    code, status, _ = _json(base, "/admin/swap", {"wait": True})
    assert code == 200 and status["state"] == "noop"

    name = next(k for k, v in state.items() if v.dim() == 4)
    servers["swaps"]["source"] = lambda: (
        {**state, name: torch.zeros(state[name].shape[0] + 1, *state[name].shape[1:])}, 12)
    code, status, _ = _json(base, "/admin/swap", {"wait": True})
    assert code == 422 and status["state"] == "failed" and status["reason"] == "rejected"
    assert app.engine.generation == gen0 + 2 and app.engine.checkpoint_step == 11
    # the old generation's key still renders; a new predict mints step 11's
    code, body, _ = _json(base, "/render", {"mpi_key": old_key, "offsets": OFFSETS[:1]})
    assert code == 200 and body["num_frames"] == 1
    code, pred, _ = _http(base, "/predict", png, {"Content-Type": "image/png"})
    assert json.loads(pred)["mpi_key"].split(":")[1] == "11"
    assert app.metrics.swaps.value() == 2
    assert app.metrics.swap_failures.value(reason="rejected") == 1
    assert _http(servers["jax"][1], "/admin/swap", b"{}")[0] == 400  # no source: both


def test_full_queue_sheds_503_with_retry_after_and_deadline_504(weights, png):
    _, state = weights
    cfg = Config().replace(**TINY, **{"resilience.serve_max_queue_requests": 1,
                                      "resilience.serve_retry_after_s": 2.5})
    app = ServingApp(cfg, state, device="cpu", max_delay_ms=0.0)
    server, base = _serve(app, make_server)
    entered, release = threading.Event(), threading.Event()
    real = app.engine.render

    def blocking(entry, poses):
        entered.set()
        release.wait(60)
        return real(entry, poses)

    app.engine.render = blocking
    try:
        key = json.loads(_http(base, "/predict", png, {"Content-Type": "image/png"})[1])[
            "mpi_key"]
        body = {"mpi_key": key, "offsets": OFFSETS[:1]}
        first = threading.Thread(target=_json, args=(base, "/render", body))
        first.start()
        assert entered.wait(60)  # dispatching, the queue empty again
        results = []
        second = threading.Thread(target=lambda: results.append(
            _json(base, "/render", body)[0]))
        second.start()
        deadline = time.monotonic() + 60
        while app.batcher.queue_depth() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, shed, hdrs = _json(base, "/render", body)
        assert code == 503 and hdrs["Retry-After"] == "2.5" and shed["retry_after_s"] == 2.5
        code, late, _ = _json(base, "/render", {**body, "timeout_s": 0.2})
        assert code in (503, 504)  # still full, or waited past its deadline
        release.set()
        first.join()
        second.join()
        assert results == [200]
        assert app.metrics.shed_requests.value(reason="queue_full") >= 1
        # a deadline that passes while the request waits: 504
        release.clear()
        entered.clear()
        app.batcher.max_queue_requests = 0
        first = threading.Thread(target=_json, args=(base, "/render", body))
        first.start()
        assert entered.wait(60)
        code, late, _ = _json(base, "/render", {**body, "timeout_s": 0.2})
        assert code == 504, late
        release.set()
        first.join()
    finally:
        release.set()
        server.shutdown()
        server.server_close()
        app.close()


def test_open_breaker_sheds_503_and_healthz_degrades(weights, png):
    _, state = weights
    cfg = Config().replace(**TINY, **{"resilience.breaker_failure_threshold": 1,
                                      "resilience.breaker_reset_s": 300.0})
    app = ServingApp(cfg, state, device="cpu")
    server, base = _serve(app, make_server)

    def failing(entry, poses):
        raise RuntimeError("engine down")

    try:
        key = json.loads(_http(base, "/predict", png, {"Content-Type": "image/png"})[1])[
            "mpi_key"]
        app.engine.render = failing
        code, body, _ = _json(base, "/render", {"mpi_key": key, "offsets": OFFSETS[:1]})
        assert code == 500 and "engine down" in body["error"]
        code, body, hdrs = _json(base, "/render", {"mpi_key": key, "offsets": OFFSETS[:1]})
        assert code == 503 and float(hdrs["Retry-After"]) > 0 and "breaker" in body["error"]
        code, health, _ = _http(base, "/healthz")
        assert code == 503 and json.loads(health)["status"] == "degraded"
        buf = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="PNG")
        assert _http(base, "/predict", buf.getvalue(), {"Content-Type": "image/png"})[0] == 503
        assert app.metrics.breaker_trips.value() == 1
        assert app.metrics.shed_requests.value(reason="breaker_open") == 2
    finally:
        server.shutdown()
        server.server_close()
        app.close()


def test_bad_requests_are_4xx_and_traces_name_the_request(servers, png):
    app, base = servers["port"]
    assert _http(base, "/predict", b"", {"Content-Type": "image/png"})[0] == 400
    assert _http(base, "/predict", b"not an image", {"Content-Type": "image/png"})[0] == 400
    assert _json(base, "/predict", {"image_b64": base64.b64encode(png).decode(),
                                    "bucket": [256, 256, 4]})[0] == 400
    assert _json(base, "/render", {"mpi_key": "d:0:128:128:4:fp32",
                                   "offsets": OFFSETS})[0] == 404
    assert _json(base, "/render", {"mpi_key": "garbage", "offsets": OFFSETS})[0] == 400
    assert _json(base, "/render", {"offsets": OFFSETS})[0] == 400
    assert _http(base, "/nowhere")[0] == 404
    key = json.loads(_http(base, "/predict", png, {"Content-Type": "image/png"})[1])["mpi_key"]
    code, _, hdrs = _json(base, "/render", {"mpi_key": key, "offsets": OFFSETS[:2]},
                          {"X-Request-Id": "req-42.a"})
    assert code == 200 and hdrs["X-Request-Id"] == "req-42.a"
    code, doc, _ = _http(base, "/debug/trace?request_id=req-42.a")
    names = {ev["name"] for ev in json.loads(doc)["traceEvents"] if ev["ph"] == "X"}
    assert {"request", "parse", "cache_lookup", "dispatch", "encode"} <= names
    code, doc, _ = _http(base, "/debug/trace")
    assert code == 200 and json.loads(doc)["metadata"]["producer"] == "mine_tpu host spans"


def test_root_span_is_recorded_before_the_answer_goes_out(servers, monkeypatch):
    """A fault of the reference (ROADMAP queue 3): the JAX handler records a
    request's root span after it has written the answer, so a client that
    reads /debug/trace?request_id= at once can miss it (a loaded host did).
    The port records it, as it counts the request, before the headers go
    out. Pinned both ways on a 404, which reaches no engine."""
    order = {}
    for name, handler_cls in (("port", tserver._Handler), ("jax", jserver._Handler)):
        app, base = servers[name]
        events = order.setdefault(name, [])
        record, end_headers = app.tracer.record, handler_cls.end_headers

        def spy_record(span_name, *args, _record=record, _events=events, **kwargs):
            if span_name == "request":
                _events.append("root_span")
            return _record(span_name, *args, **kwargs)

        def spy_end_headers(self, _end=end_headers, _events=events):
            _events.append("answer_sent")
            return _end(self)

        monkeypatch.setattr(app.tracer, "record", spy_record)
        monkeypatch.setattr(handler_cls, "end_headers", spy_end_headers)
        assert _http(base, "/nowhere")[0] == 404
        deadline = time.monotonic() + 10.0
        while len(events) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert order == {"port": ["root_span", "answer_sent"],
                     "jax": ["answer_sent", "root_span"]}


def test_a_burst_of_connections_is_answered(servers):
    """32 clients connecting at once all get their answer: the listen
    backlog holds the burst (with socketserver's default of 5, 8 concurrent
    clients saw a connection reset on an H100 host)."""
    _, base = servers["port"]
    barrier = threading.Barrier(32)
    codes = []

    def client():
        barrier.wait(timeout=60)
        codes.append(_http(base, "/healthz", timeout=60)[0])

    threads = [threading.Thread(target=client) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and codes == [200] * 32
    assert tserver.ServingHTTPServer.request_queue_size >= 32


def test_server_cli_and_app_refuse_what_they_cannot_serve(weights, tmp_path):
    _, state = weights
    # the brownout ladder is served now (tests/test_torch_degrade.py)
    app = ServingApp(Config().replace(**{**TINY, "serving.degrade_enabled": True}), state,
                     device="cpu")
    assert app.degrade is not None and app.health()["degradation"]["level"] == 0
    app.close()
    # coarse-to-fine is served now (tests/test_torch_c2f.py): the bucket keeps
    # the coarse count as its key and renders the merged planes
    app = ServingApp(Config().replace(**{**TINY, "mpi.num_bins_fine": 4}), state, device="cpu")
    bucket = app.engine.bucket()
    assert bucket.is_c2f and bucket.num_planes == bucket.spec[2] + 4
    app.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserver.main(["--workspace", str(tmp_path)])
