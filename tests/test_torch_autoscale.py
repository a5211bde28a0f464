"""The port's autoscaling controller (mine_tpu_torch/serving/autoscale.py)
against the JAX package's:

  * the same scripted /metrics pages (burn rates, the router's latency
    histogram, the fleet's degradation level, failed scrapes) on the same
    fake clock give the same decision records and status (exact);
  * the same config gives the same controller; the same add/remove calls
    the same membership and `mine_fleet_*` counters;
  * port only: over FakeEngine replicas (InProcessPool) a join pre-warms
    the joiner's arc and a drain hands its arc off, with client traffic
    running through both and no 5xx, and the fleet's encoder invocations
    equal to the images it was shown; and SubprocessPool starts the port's
    own serving CLI (`python -m mine_tpu_torch.serving`) and drives a join
    and a drain over its admin surface.
"""

import io
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from mine_tpu.config import Config as JaxConfig
from mine_tpu.serving import autoscale as jauto
from mine_tpu.serving import fleet as jfleet
from mine_tpu_torch.config import Config
from mine_tpu_torch.serving import autoscale as tauto
from mine_tpu_torch.serving import fleet as tfleet
from mine_tpu_torch.serving.fake import make_fake_app
from mine_tpu_torch.training.checkpoint import save_paired_config


class _NullPool:
    """A pool whose spawn always fails: decision tests observe the action,
    and a scale event is recorded as aborted."""

    def spawn(self):
        raise RuntimeError("null pool")

    def names(self):
        return []

    def retire(self, name):
        pass

    def close(self):
        pass


def _pages(rng, n: int) -> list:
    """Scripted /metrics pages of the router, in runs of breach, calm and
    mixed pressure, with failed scrapes among them."""
    pages, regime = [], 0
    for _ in range(n):
        if rng.uniform() < 0.12:
            regime = int(rng.integers(0, 3))
        if rng.uniform() < 0.05:
            pages.append(ConnectionError("scrape refused"))
            continue
        burns = {0: [1.0, 2.5, 4.0], 1: [0.0, 0.05, 0.2], 2: [0.0, 0.3, 0.9, 1.0]}[regime]
        lines = [f'mine_slo_burn_rate{{slo="{slo}"}} {float(rng.choice(burns)):g}'
                 for slo in ("availability", "latency_p95") if rng.uniform() < 0.95]
        if rng.uniform() < 0.8:
            top = {0: 4, 1: 1, 2: 3}[regime]
            lines.append(f"mine_fleet_degradation_level {int(rng.integers(0, top))}")
        cum = 0
        for le in ("0.05", "0.25", "1.0", "+Inf"):
            cum += int(rng.integers(0, 30))
            lines.append('mine_fleet_request_latency_seconds_bucket'
                         f'{{endpoint="render",le="{le}"}} {cum}')
        pages.append("\n".join(lines) + "\n")
    return pages


@pytest.mark.parametrize("seed,knobs", [
    (0, {}),
    (1, {"up_after": 1, "down_after": 1, "cooldown_s": 5.0}),
    (2, {"p95_up_threshold_s": 0.2, "degrade_up_level": 1, "max_replicas": 2}),
    (3, {"degrade_up_level": 2, "min_replicas": 2, "up_burn_threshold": 2.0,
         "down_burn_threshold": 0.1, "cooldown_s": 30.0}),
])
def test_decisions_match_jax(seed, knobs):
    runs = []
    for auto, fl in ((tauto, tfleet), (jauto, jfleet)):
        rng = np.random.default_rng(seed)
        fleet = fl.FleetApp({f"r{i}": f"http://r{i}" for i in range(2)}, probe_interval_s=3600,
                            transport=lambda *a: (200, {}, b"{}"))
        clock, page = [0.0], [""]

        def scrape():
            if isinstance(page[0], Exception):
                raise page[0]
            return page[0]

        kw = {"min_replicas": 1, "max_replicas": 4, "cooldown_s": 0.0, **knobs}
        ctl = auto.AutoscaleController(fleet, _NullPool(), scrape, clock=lambda: clock[0], **kw)
        records = []
        for page[0] in _pages(rng, 150):
            clock[0] += float(rng.uniform(1.0, 10.0))
            records.append(ctl.tick())
            records.append(ctl.status())
        runs.append((records, [ln for ln in fleet.metrics.render().splitlines()
                               if "mine_build_info" not in ln]))
        fleet.close()
    assert runs[0] == runs[1]
    actions = {r["action"] for r in runs[0][0] if "action" in r}
    assert "hold" in actions and len(actions) >= 2


def test_controller_from_config_and_bounds_match_jax():
    knobs = {"serving.autoscale_min_replicas": 1, "serving.autoscale_max_replicas": 3,
             "serving.autoscale_interval_s": 0.5, "serving.autoscale_up_after": 4,
             "serving.autoscale_cooldown_s": 12.0, "serving.autoscale_prewarm_keys": 7,
             "serving.slo_p95_ms": 150.0, "serving.degrade_scaleup_level": 2}
    names = ("min_replicas", "max_replicas", "interval_s", "up_burn_threshold",
             "down_burn_threshold", "up_after", "down_after", "cooldown_s", "prewarm_keys",
             "join_timeout_s", "drain_timeout_s", "p95_up_threshold_s", "degrade_up_level")
    got, want = [], []
    for auto, fl, cfg, out in ((tauto, tfleet, Config(), got), (jauto, jfleet, JaxConfig(), want)):
        fleet = fl.FleetApp({"r0": "http://r0"}, probe_interval_s=3600)
        ctl = auto.controller_from_config(fleet, _NullPool(), cfg.replace(**knobs))
        out.append({n: getattr(ctl, n) for n in names})
        for bounds in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2}):
            with pytest.raises(ValueError):
                auto.AutoscaleController(fleet, _NullPool(), **bounds)
        fleet.close()
    assert got == want and got[0]["p95_up_threshold_s"] == 0.15
    assert tauto.routing_digest("abc:1:2:3:4:int8") == jauto.routing_digest("abc:1:2:3:4:int8")


def test_membership_changes_match_jax():
    pages = []
    for fl in (tfleet, jfleet):
        fleet = fl.FleetApp({"r0": "http://r0", "r1": "http://r1"}, probe_interval_s=3600)
        fleet.add_replica("s0", "http://s0")
        with pytest.raises(ValueError):
            fleet.add_replica("s0", "http://s0")
        fleet.remove_replica("r0")
        with pytest.raises(ValueError):
            fleet.remove_replica("r0")
        fleet.remove_replica("r1")
        with pytest.raises(ValueError, match="last replica"):
            fleet.remove_replica("s0")
        pages.append((fleet.ring_members(), [ln for ln in fleet.metrics.render().splitlines()
                                             if "mine_build_info" not in ln]))
        fleet.close()
    assert pages[0] == pages[1] and pages[0][0] == ["s0"]


# -- the scale events over live replicas (port only) ---------------------------

def _png(i: int) -> bytes:
    img = np.full((8, 8, 3), (i * 53) % 256, np.uint8)
    img[0, 0] = (i % 256, 3, 9)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _http(base, path, data=None, headers=None, timeout=30):
    req = urllib.request.Request(base + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


class _Elastic:
    """A pool's replicas behind a router server, with a controller that
    scales only through scale_to."""

    def __init__(self, pool, n: int, **kw):
        self.pool = pool
        for _ in range(n):
            pool.spawn()
        urls = pool.urls()
        pool.configure_peers(urls)
        self.fleet = tfleet.FleetApp(urls, probe_interval_s=3600, deadline_s=30.0)
        self.srv = tfleet.make_fleet_server(self.fleet)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.base = "http://%s:%d" % self.srv.server_address[:2]
        self.controller = tauto.AutoscaleController(
            self.fleet, pool, scrape=f"{self.base}/metrics", up_after=10**6,
            down_after=10**6, cooldown_s=0.0, join_timeout_s=60.0, drain_timeout_s=60.0, **kw)

    def predict(self, i: int) -> tuple[int, str | None]:
        code, body = _http(self.base, "/predict", _png(i), {"Content-Type": "image/png"})
        return code, json.loads(body).get("mpi_key") if code == 200 else None

    def render(self, i: int, key: str) -> list[int]:
        """A render; on 404 (the MPI is not on the replica the key now routes
        to) the documented client contract: predict again, render again."""
        req = json.dumps({"mpi_key": key, "offsets": [[0.01, 0.0, 0.0]]}).encode()
        hdr = {"Content-Type": "application/json"}
        codes = [_http(self.base, "/render", req, hdr)[0]]
        if codes[0] == 404:
            code, key = self.predict(i)
            codes += [code, _http(self.base, "/render", json.dumps(
                {"mpi_key": key, "offsets": [[0.01, 0.0, 0.0]]}).encode(), hdr)[0]]
        return codes

    def traffic(self, keys: dict[int, str], stop: threading.Event, codes: list[int]):
        while not stop.is_set():
            for i, key in keys.items():
                codes.extend(self.render(i, key))

    def close(self):
        self.controller.close()
        self.srv.shutdown()
        self.srv.server_close()
        self.fleet.close()
        self.pool.close()


def _scale_under_traffic(ef: _Elastic, keys: dict[int, str], target: int) -> list[int]:
    stop, codes = threading.Event(), []
    client = threading.Thread(target=ef.traffic, args=(keys, stop, codes))
    client.start()
    try:
        assert ef.controller.scale_to(target) == target
    finally:
        stop.set()
        client.join(timeout=60)
    assert not client.is_alive()
    return codes


def test_join_prewarms_and_drain_hands_off_without_a_5xx():
    pool = tauto.InProcessPool(lambda: make_fake_app(checkpoint_step=1, device="cpu"))
    ef = _Elastic(pool, 2, min_replicas=2, max_replicas=3)
    try:
        keys = {}
        for i in range(8):
            code, keys[i] = ef.predict(i)
            assert code == 200
        encoder = lambda: sum(pool.app(n).metrics.encoder_invocations.value()  # noqa: E731
                              for n in pool.names())
        assert encoder() == 8
        codes = _scale_under_traffic(ef, keys, 3)
        joiner = pool.names()[-1]
        prewarmed = pool.app(joiner).metrics.prewarm_keys.value(outcome="fetched")
        assert len(ef.fleet.ring_members()) == 3 and prewarmed >= 1
        assert len(pool.app(joiner).cache) >= prewarmed
        ev = ef.fleet.metrics.autoscale_events
        assert ev.value(direction="join", outcome="ok") == 1
        codes += _scale_under_traffic(ef, keys, 2)
        assert ev.value(direction="drain", outcome="ok") == 1
        assert len(ef.fleet.ring_members()) == 2 and len(pool.names()) == 2
        assert codes and all(c < 500 for c in codes) and codes.count(200) >= len(codes) // 2
        # every routed key renders, and no arc was re-encoded on the way
        assert all(ef.render(i, k) == [200] for i, k in keys.items())
        assert encoder() == 8
        code, body = _http(pool.urls()[pool.names()[0]], "/debug/hot_keys?n=3")
        assert code == 200 and len(json.loads(body)["hot_keys"]) == 3
    finally:
        ef.close()


def test_subprocess_pool_runs_the_ports_serving_cli(tmp_path):
    """The pool's replicas behind a router join and drain under traffic;
    the pool's `env` reaches every replica (a corrupt_ckpt fault refuses a
    swap as corrupt), and `pid` signals one (SIGUSR1: a flight dump)."""
    cfg = Config().replace(**{"data.img_h": 128, "data.img_w": 128, "model.num_layers": 18,
                              "model.dtype": "float32", "mpi.num_bins_coarse": 2})
    save_paired_config(cfg, str(tmp_path))
    pool = tauto.SubprocessPool(str(tmp_path), server_args=[
        "--device", "cpu", "--allow-random-init", "--no-warmup"],
        env=dict(os.environ, MINE_TPU_FAULTS="corrupt_ckpt@swap=1"))
    ef = _Elastic(pool, 1, min_replicas=1, max_replicas=2, prewarm_keys=16)
    try:
        first = pool.names()[0]
        code, body = _http(pool.urls()[first], "/healthz")
        assert code == 200 and json.loads(body)["backend"] == "cpu"
        keys = {}
        for i in range(6):
            code, keys[i] = ef.predict(i)
            assert code == 200
        assert ef.controller.scale_to(2) == 2
        joiner = pool.names()[-1]
        arc = [k for k in keys.values()
               if tfleet.HashRing(pool.names()).candidates(k.split(":")[0])[0] == joiner]
        code, body = _http(pool.urls()[joiner], "/healthz")
        assert code == 200 and json.loads(body)["cache_entries"] == len(arc) >= 1
        assert all(ef.render(i, k) == [200] for i, k in keys.items())
        assert ef.controller.scale_to(1) == 1
        assert pool.names() == [first]
        assert all(ef.render(i, k) == [200] for i, k in keys.items())
        code, body = _http(pool.urls()[first], "/admin/swap", data=b'{"wait": true}',
                           headers={"Content-Type": "application/json"})
        assert code == 422 and json.loads(body)["reason"] == "corrupt"
        os.kill(pool.pid(first), signal.SIGUSR1)
        dumps = os.path.join(str(tmp_path), "flight", f"pid{pool.pid(first)}")
        deadline = time.monotonic() + 30
        while not (os.path.isdir(dumps) and os.listdir(dumps)):
            assert time.monotonic() < deadline, "no flight dump after SIGUSR1"
            time.sleep(0.05)
        assert os.listdir(dumps)[0].endswith("signal_sigusr1")
    finally:
        ef.close()
