"""The port's brownout ladder (mine_tpu_torch/serving/degrade.py) and the
serving pieces it drives, against the JAX package's:

  * the same PressureSample sequence on the same fake clock gives the same
    levels, on_level calls, transitions and snapshots (exact: integer
    levels and the clock's own floats);
  * the cache's stale_key/hot_keys and the engine's degraded-compression
    override answer as the JAX package's do (exact);
  * the batcher's live window retarget: a fault of the reference pinned in
    both packages (ROADMAP queue 3);
  * port-only, over FakeEngine apps on live HTTP: stale-while-revalidate
    across a swap, the announced X-Degraded answers at every level, a real
    queue flood climbing the ladder, and the relax back to L0 restoring
    the tier and the coalescing window.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from mine_tpu.config import Config as JaxConfig
from mine_tpu.serving import degrade as jdeg
from mine_tpu.serving.batcher import MicroBatcher as JaxBatcher
from mine_tpu.serving.cache import MPICache as JaxCache
from mine_tpu.serving.fake import FakeEngine as JaxFakeEngine
from mine_tpu_torch.config import Config
from mine_tpu_torch.serving import degrade as tdeg
from mine_tpu_torch.serving.batcher import MicroBatcher
from mine_tpu_torch.serving.cache import MPICache, mpi_key
from mine_tpu_torch.serving.fake import FakeEngine, fake_checkpoint, make_fake_app
from mine_tpu_torch.serving.server import make_server


def _png(i: int = 0) -> bytes:
    img = np.full((8, 8, 3), (i * 53) % 256, np.uint8)
    img[0, 0] = (i % 256, 3, 9)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _samples(mod, seed: int, n: int = 200) -> list:
    """Seeded pressure: runs of breach, calm and deadband samples, with the
    breaker sometimes open."""
    rng = np.random.default_rng(seed)
    out, kind = [], 0
    for _ in range(n):
        if rng.uniform() < 0.15:
            kind = int(rng.integers(0, 3))
        q = {0: rng.uniform(0.8, 1.0), 1: rng.uniform(0.0, 0.2), 2: rng.uniform(0.3, 0.7)}[kind]
        burn = {0: rng.uniform(0.0, 4.0), 1: rng.uniform(0.0, 0.4), 2: rng.uniform(0.6, 1.5)}[kind]
        out.append(mod.PressureSample(queue_frac=float(q), burn_rate=float(burn),
                                      breaker_open=bool(rng.uniform() < 0.03)))
    return out


@pytest.mark.parametrize("seed,knobs", [
    (0, {}),
    (1, {"engage_after": 1, "relax_after": 1, "dwell_s": 0.0}),
    (2, {"engage_after": 3, "relax_after": 2, "dwell_s": 4.0, "max_level": 2}),
    (3, {"queue_high": 0.9, "queue_low": 0.1, "burn_high": 3.0, "burn_low": 0.2}),
])
def test_ladder_levels_match_jax(seed, knobs):
    runs = []
    for mod in (tdeg, jdeg):
        clock = [0.0]
        calls = []
        ctl = mod.DegradationController(clock=lambda: clock[0], on_level=calls.append, **knobs)
        levels, snaps, sems = [], [], []
        rng = np.random.default_rng(seed + 100)
        for sample in _samples(mod, seed):
            clock[0] += float(rng.uniform(0.1, 2.0))
            levels.append(ctl.tick(sample))
            snaps.append(ctl.snapshot())
            sems.append((ctl.tier_override(), ctl.prune_eps_override(), ctl.serve_stale(),
                         ctl.skip_peer_fetch(), ctl.widen_coalesce(),
                         ctl.announcement("int8")))
        runs.append((levels, calls, ctl.transitions(), snaps, sems))
    assert runs[0] == runs[1]
    levels = runs[0][0]
    assert max(levels) >= 1 and levels[-1] in range(4)
    steps = [lvl for _, lvl in runs[0][2]]
    assert all(abs(b - a) == 1 for a, b in zip(steps, steps[1:]))  # never skips


@pytest.mark.parametrize("knobs", [
    {"queue_low": 0.9, "queue_high": 0.5}, {"burn_low": 3.0, "burn_high": 1.0},
    {"engage_after": 0}, {"relax_after": 0}, {"dwell_s": -1.0},
    {"max_level": tdeg.MAX_LEVEL + 1}, {"max_level": -1},
])
def test_controller_refuses_the_knobs_jax_refuses(knobs):
    for mod in (tdeg, jdeg):
        with pytest.raises(ValueError):
            mod.DegradationController(**knobs)


def test_ladder_table_and_config_match_jax():
    assert tdeg.LADDER == jdeg.LADDER and tdeg.MAX_LEVEL == jdeg.MAX_LEVEL
    knobs = {"serving.degrade_queue_high": 0.6, "serving.degrade_queue_low": 0.1,
             "serving.degrade_burn_high": 1.5, "serving.degrade_burn_low": 0.3,
             "serving.degrade_engage_after": 3, "serving.degrade_relax_after": 4,
             "serving.degrade_dwell_s": 2.5, "serving.degrade_max_level": 2}
    got = tdeg.controller_from_config(Config().replace(**knobs))
    want = jdeg.controller_from_config(JaxConfig().replace(**knobs))
    names = ("queue_high", "queue_low", "burn_high", "burn_low", "engage_after",
             "relax_after", "dwell_s", "max_level")
    assert {n: getattr(got, n) for n in names} == {n: getattr(want, n) for n in names}


class _Blob:
    def __init__(self, nbytes: int = 10):
        self.nbytes = nbytes


def test_cache_stale_key_and_hot_keys_match_jax():
    rng = np.random.default_rng(5)
    caches = (MPICache(byte_budget=600), JaxCache(byte_budget=600))
    for _ in range(120):
        key = mpi_key(f"d{rng.integers(0, 6)}", int(rng.integers(0, 5)),
                      (8 * int(rng.integers(1, 3)), 8, 2),
                      tier=("fp32", "bf16", "int8")[rng.integers(0, 3)])
        op, size = rng.integers(0, 3), int(rng.integers(5, 40))
        for cache in caches:
            if op == 0:
                cache.get(key)
            else:
                cache.put(key, _Blob(size))
        probe = mpi_key(f"d{rng.integers(0, 6)}", int(rng.integers(0, 6)), (8, 8, 2))
        assert caches[0].stale_key(probe) == caches[1].stale_key(probe)
        n = int(rng.integers(-1, 8))
        assert caches[0].hot_keys(n) == caches[1].hot_keys(n)
    fresh = mpi_key("x", 7, (8, 8, 2))
    cache = MPICache(byte_budget=1 << 20)
    cache.put(mpi_key("x", 1, (8, 8, 2)), _Blob())
    cache.put(mpi_key("x", 4, (8, 8, 2), tier="int8"), _Blob())
    cache.put(mpi_key("x", 4, (16, 8, 2)), _Blob())  # another bucket
    assert cache.stale_key(fresh) == mpi_key("x", 4, (8, 8, 2), tier="int8")
    assert cache.stale_key(mpi_key("x", 1, (8, 8, 2))) is None


def test_degraded_compression_override_matches_jax():
    cfg = {"data.img_h": 128, "data.img_w": 128, "mpi.num_bins_coarse": 2,
           "serving.prune_transmittance_eps": 2e-3}
    ours = FakeEngine(Config().replace(**cfg), device="cpu")
    theirs = JaxFakeEngine(JaxConfig().replace(**cfg))
    script = [("set", "int8", 1e-3), ("set", "bf16", 5e-3), ("clear",), ("set", "fp32", 0.0),
              ("set", "nope", 0.0), ("set", "int8", 1.0), ("clear",)]
    for step in script:
        outcome = []
        for engine in (ours, theirs):
            try:
                if step[0] == "set":
                    engine.set_degraded_compression(step[1], step[2])
                else:
                    engine.clear_degraded_compression()
                outcome.append((engine.effective_tier(), engine.effective_prune_eps()))
            except ValueError:
                outcome.append("ValueError")
        assert outcome[0] == outcome[1], step


def test_window_retarget_reaches_the_waiting_group_jax_does_not():
    """A fault of the reference: the JAX batcher fixes a group's window when
    it seeds the group, so a widening (brownout L3) reaches only later
    groups, though its docstring says the current queue. The port re-reads
    the window on every wake-up: a request arriving inside the widened
    window joins the waiting group."""
    groups = {}
    for name, cls in (("port", MicroBatcher), ("jax", JaxBatcher)):
        sizes = groups[name] = []

        def render(entry, poses, sizes=sizes):
            sizes.append(poses.shape[0])
            return np.zeros((poses.shape[0], 2, 2, 3)), np.zeros((poses.shape[0], 2, 2, 1))

        batcher = cls(render, max_delay_ms=300.0).start()
        try:
            key, pose = mpi_key("d", 0, (8, 8, 2)), np.eye(4, dtype=np.float32)[None]
            first = batcher.submit(key, None, pose)
            time.sleep(0.05)
            batcher.set_max_delay_s(3.0)  # L3 widens while the group waits
            time.sleep(0.85)  # past the old 0.3 s window, inside the new one
            second = batcher.submit(key, None, pose)
            time.sleep(0.05)
            batcher.set_max_delay_s(0.0)  # L0 restores: dispatch now
            first.result(timeout=10)
            second.result(timeout=10)
        finally:
            batcher.stop()
    assert groups == {"port": [2], "jax": [1, 1]}


# -- live HTTP over FakeEngine replicas (port only) ----------------------------

def _degrade_cfg(**over):
    return Config().replace(**{
        "data.img_h": 128, "data.img_w": 128, "mpi.num_bins_coarse": 2,
        "serving.degrade_enabled": True, "serving.degrade_engage_after": 1,
        "serving.degrade_relax_after": 5, "serving.degrade_dwell_s": 300.0, **over})


def _serve(app):
    srv = make_server(app)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, "http://%s:%d" % srv.server_address[:2]


def _http(base, path, data=None, headers=None):
    req = urllib.request.Request(base + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


BREACH = tdeg.PressureSample(queue_frac=1.0)
CALM = tdeg.PressureSample()


def test_swr_serves_the_old_generation_across_a_swap():
    app = make_fake_app(checkpoint_step=1, cfg=_degrade_cfg(), device="cpu",
                        swap_source=lambda: fake_checkpoint(7))
    try:
        before = app.predict(_png(3))
        assert app.swap(wait=True)["state"] == "ok"
        for _ in range(2):
            app.degrade.tick(BREACH)
        assert app.degrade.level == 2
        out = app.predict(_png(3))
        assert out["stale"] is True and out["cached"] is True
        assert out["mpi_key"] == before["mpi_key"]  # the step-1 entry
        assert app.metrics.encoder_invocations.value() == 1
    finally:
        app.close()


def test_every_degraded_answer_is_announced_and_relaxing_restores_fidelity():
    app = make_fake_app(cfg=_degrade_cfg(), device="cpu")
    srv, base = _serve(app)
    try:
        normal_delay = app.batcher.max_delay_s
        code, hdrs, body = _http(base, "/predict", _png(0), {"Content-Type": "image/png"})
        assert code == 200 and hdrs.get("X-Degraded") is None
        assert json.loads(body)["tier"] == "fp32"
        seen = []
        for level in (1, 2, 3):
            assert app.degrade.tick(BREACH) == level
            code, hdrs, body = _http(base, "/predict", _png(level),
                                     {"Content-Type": "image/png"})
            pred = json.loads(body)
            assert code == 200 and pred["tier"] == "int8"
            assert pred["planes_kept"] <= pred["planes"]
            code, hdrs_r, _ = _http(base, "/render", json.dumps(
                {"mpi_key": pred["mpi_key"], "offsets": [[0.01, 0, 0]]}).encode(),
                {"Content-Type": "application/json"})
            assert code == 200
            seen.append((hdrs["X-Degraded"], hdrs_r["X-Degraded"]))
        assert seen == [(f"level={n};tier=int8",) * 2 for n in (1, 2, 3)]
        assert app.batcher.max_delay_s == pytest.approx(0.025)  # degrade_coalesce_delay_ms
        assert app.metrics.degradation_level.value() == 3
        assert [app.metrics.degradation_responses.value(level=str(n)) for n in (1, 2, 3)] \
            == [2, 2, 2]
        code, _, body = _http(base, "/healthz")
        assert json.loads(body)["degradation"]["name"] == "coalesce"
        # calm /metrics scrapes walk the ladder down, one level each
        app.degrade.relax_after, app.degrade.dwell_s = 1, 0.0
        for want in (2, 1, 0):
            _http(base, "/metrics")
            assert app.degrade.level == want
        assert app.engine.effective_tier() == "fp32"
        assert app.batcher.max_delay_s == pytest.approx(normal_delay)
        code, hdrs, body = _http(base, "/predict", _png(9), {"Content-Type": "image/png"})
        assert hdrs.get("X-Degraded") is None and json.loads(body)["tier"] == "fp32"
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()


def test_a_render_flood_climbs_the_ladder_from_real_queue_pressure():
    app = make_fake_app(cfg=_degrade_cfg(**{"resilience.serve_max_queue_requests": 4}),
                        render_delay_s=0.3, device="cpu")
    srv, base = _serve(app)
    try:
        key = app.predict(_png(1))["mpi_key"]
        clients = 10
        barrier = threading.Barrier(clients)
        answers = []

        def client(i):
            barrier.wait(timeout=30)
            code, hdrs, _ = _http(base, "/render", json.dumps(
                {"mpi_key": key, "offsets": [[0.01 * i, 0, 0]]}).encode(),
                {"Content-Type": "application/json"})
            answers.append((code, hdrs.get("X-Degraded"), hdrs.get("Retry-After")))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        levels = [lvl for _, lvl in app.degrade.transitions()]
        assert max(levels) >= 1  # the queue itself pushed the ladder up
        assert {code for code, _, _ in answers} <= {200, 503}
        assert all(ra is not None for code, _, ra in answers if code == 503)
        assert app.metrics.degradation_level.value() == levels[-1]
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
