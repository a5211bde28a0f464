"""The port's fleet router (mine_tpu_torch/serving/fleet.py), trace collector
(obs/collect.py), FakeEngine (serving/fake.py) and the replicas' peer fetch,
against the JAX package's:

  * HashRing candidates for 1,000 seeded digests under 1-5 members and
    under a member added and removed, and digest_of_request on every
    routed path: equal (exact);
  * a scripted transport (connect errors, timeouts, 503 + Retry-After,
    answers, each attempt advancing a fake clock) driven through both
    routers: the same attempt order and budgets, outcomes and
    `mine_fleet_*` exposition (exact);
  * the collector's merge and hop tree on the same docs, and FakeEngine's
    slabs for the same image: equal (exact);
  * port only, live HTTP on the loopback: a routed answer is byte-identical
    to the owner's direct one; /admin/swap fans out to every replica; the
    merged /debug/trace?request_id= of the three-process case has the JAX
    case's hop tree; and a replica adopts a peer's entry (fp32, bf16, int8)
    from a real tiny RenderEngine (ResNet-18, 128x128, S=4, CPU, so K5's
    plain version) and renders frames equal to the owner's (exact: the same
    bytes through the same code).
"""

import base64
import hashlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from mine_tpu.obs import collect as jcollect
from mine_tpu.serving import fleet as jfleet
from mine_tpu.serving.fake import FakeEngine as JaxFakeEngine
from mine_tpu.serving.fake import make_fake_app as jax_make_fake_app
from mine_tpu.serving.server import make_server as jax_make_server
from mine_tpu_torch.config import Config
from mine_tpu_torch.inference.trajectory import poses_from_offsets
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.obs import collect as tcollect
from mine_tpu_torch.serving import fleet as tfleet
from mine_tpu_torch.serving.cache import MPIEntry, key_from_str
from mine_tpu_torch.serving.compress import CompressedMPI
from mine_tpu_torch.serving.fake import fake_checkpoint, fake_slabs, make_fake_app
from mine_tpu_torch.serving.server import ServingApp, make_server
from mine_tpu_torch.training.step import build_model
from torch_threads import one_torch_thread  # noqa: F401


def _png(i: int = 0, size: int = 8) -> bytes:
    img = np.full((size, size, 3), (i * 53) % 256, np.uint8)
    img[0, 0] = (i % 256, 3, 9)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _digests(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [hashlib.sha256(rng.bytes(16)).hexdigest() for _ in range(n)]


# -- the ring and the routing digest -------------------------------------------

RING_CASES = {f"{n}_members": ([f"r{i}" for i in range(n)], None) for n in range(1, 6)}
RING_CASES["member_added"] = (["r0", "r1", "r2"], ["r0", "r1", "r2", "s9"])
RING_CASES["member_removed"] = (["r0", "r1", "r2", "r3"], ["r0", "r2", "r3"])


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_candidates_match_jax(case):
    before, after = RING_CASES[case]
    assert tfleet.DEFAULT_VNODES == jfleet.DEFAULT_VNODES == 64
    for members in filter(None, (before, after)):
        ours, theirs = tfleet.HashRing(members), jfleet.HashRing(members)
        for digest in _digests(1000, seed=len(members)):
            cands = ours.candidates(digest)
            assert cands == theirs.candidates(digest)
            assert sorted(cands) == sorted(members)
    if after is not None:  # only the arc of the member that came or went moves
        old, new = tfleet.HashRing(before), tfleet.HashRing(after)
        changed = set(before) ^ set(after)
        for digest in _digests(1000, seed=99):
            a, b = old.candidates(digest)[0], new.candidates(digest)[0]
            assert a == b or a in changed or b in changed


def _predict_json(img: bytes, **extra) -> bytes:
    return json.dumps({"image_b64": base64.b64encode(img).decode(), **extra}).encode()


DIGEST_CASES = {
    "predict_raw": ("/predict", _png(3), "image/png"),
    "predict_json": ("/predict", _predict_json(_png(3), timeout_s=2.5), "application/json"),
    "predict_json_bad_timeout": ("/predict", _predict_json(_png(4), timeout_s="x"),
                                 "application/json"),
    "render": ("/render", json.dumps({"mpi_key": "abc123:4:128:128:2:int8",
                                      "timeout_s": 7}).encode(), "application/json"),
    "mpi": ("/mpi/abc123:4:128:128:2:fp32", b"", ""),
    "unroutable": ("/healthz", b"", ""),
    "render_without_key": ("/render", b"{}", "application/json"),
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_digest_of_request_matches_jax(case):
    path, body, ctype = DIGEST_CASES[case]
    results = []
    for mod in (tfleet, jfleet):
        try:
            results.append(mod.digest_of_request(path, body, ctype))
        except (ValueError, KeyError, TypeError) as exc:
            results.append(type(exc).__name__)
    assert results[0] == results[1]
    if case == "predict_raw":
        assert results[0] == (hashlib.sha256(_png(3)).hexdigest(), None)


def test_health_gate_matches_jax():
    rng = np.random.default_rng(3)
    obs = [bool(v) for v in rng.integers(0, 2, 300)]
    for up, down in ((1, 1), (2, 2), (3, 1), (1, 4)):
        ours, theirs = tfleet.HealthGate(up, down), jfleet.HealthGate(up, down)
        assert [(ours.observe(o), ours.healthy) for o in obs] \
            == [(theirs.observe(o), theirs.healthy) for o in obs]


@pytest.mark.parametrize("specs,want", [
    (["r0=http://127.0.0.1:8001", "r1=http://127.0.0.1:8002/"],
     {"r0": "http://127.0.0.1:8001", "r1": "http://127.0.0.1:8002"}),
    (["b=http://127.0.0.1:8002", "a=http://127.0.0.1:8001"],
     {"b": "http://127.0.0.1:8002", "a": "http://127.0.0.1:8001"}),
    (["http://127.0.0.1:8001", "http://127.0.0.1:8002"],
     {"r0": "http://127.0.0.1:8001", "r1": "http://127.0.0.1:8002"}),
], ids=["named", "named_out_of_order", "bare_urls"])
def test_router_cli_names_its_members_as_given(monkeypatch, specs, want):
    """`--replica NAME=URL` gives the ring that name (each replica's
    --peer-name) and that base URL; a bare URL is named by its position."""
    built = {}

    class _Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def shutdown(self):
            pass

    def make(app, host, port, verbose=False):
        built["app"] = app
        return _Server()

    monkeypatch.setattr(tfleet.FleetApp, "start", lambda self: self)
    monkeypatch.setattr(tfleet, "make_fleet_server", make)
    argv = [a for spec in specs for a in ("--replica", spec)]
    tfleet.main(argv + ["--port", "0"])
    app = built["app"]
    assert {n: r.base_url for n, r in app.replicas.items()} == want
    assert app._ring.members == sorted(want)


# -- the router's attempts, through a scripted transport -----------------------

class _Script:
    """One transport for one router: the i-th call (whatever its URL) gets
    the i-th behaviour and advances the fake clock by the i-th cost, so two
    routers that make the same calls see the same world."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        self.clock = [100.0]
        self.calls: list[tuple] = []
        self.behaviours = []
        for _ in range(2000):
            kind = rng.choice(["ok", "ok", "ok", "connect", "timeout", "503", "404",
                               "500", "degraded", "http_exc"])
            self.behaviours.append((str(kind), float(rng.uniform(0.0, 3.0)),
                                    float(rng.choice([0.5, 2.0, 7.5]))))

    def __call__(self, method, url, body, headers, timeout_s):
        kind, cost, retry_after = self.behaviours[len(self.calls)]
        self.calls.append((method, url, round(timeout_s, 9),
                           sorted(k for k in headers if k != "X-Parent-Span")))
        self.clock[0] += cost
        if kind == "connect":
            raise ConnectionError("refused")
        if kind == "timeout":
            raise TimeoutError("read timed out")
        if kind == "http_exc":
            raise OSError("reset by peer")
        if url.endswith("/healthz"):
            code = 200 if kind in ("ok", "degraded", "404") else 503
            return code, {}, json.dumps({"status": "ok", "degradation": {
                "level": 2 if kind == "degraded" else 0}}).encode()
        if kind == "503":
            return 503, {"Retry-After": f"{retry_after}"}, b'{"error": "shed"}'
        if kind == "degraded":
            return 200, {"X-Degraded": "level=2;tier=int8"}, b'{"ok": 1}'
        return {"ok": 200, "404": 404, "500": 500}[kind], {}, b'{"ok": 1}'


def _exposition(app) -> list[str]:
    """The router's metrics page without the build-identity family (its
    labels name each package's framework)."""
    return [ln for ln in app.metrics.render().splitlines() if "mine_build_info" not in ln]


@pytest.mark.parametrize("seed", range(5))
def test_router_attempts_and_metrics_match_jax(seed):
    runs = []
    for mod in (tfleet, jfleet):
        script = _Script(seed)
        app = mod.FleetApp({f"r{i}": f"http://r{i}" for i in range(4)}, transport=script,
                           clock=lambda s=script: s.clock[0], probe_interval_s=3600,
                           max_attempts=3, deadline_s=6.0, up_after=2, down_after=2)
        rng = np.random.default_rng(seed)
        outcomes = []
        for i, digest in enumerate(_digests(150, seed)):
            if i % 17 == 16:
                outcomes.append(("probe", app.probe_once()))
                continue
            timeout = [None, 1.0, 4.0][int(rng.integers(0, 3))]
            try:
                status, headers, body, name = app.forward(
                    digest, "POST", "/render", b"{}", {"Content-Type": "application/json"},
                    timeout_s=timeout, request_id=f"rid{i}")
                outcomes.append((status, name, body, headers.get("X-Degraded")))
            except (mod.NoHealthyReplica, mod.FleetDeadlineExceeded) as exc:
                outcomes.append((type(exc).__name__, getattr(exc, "retry_after_s", None)))
            outcomes.append(("ring", app.ring_members()))
        runs.append((outcomes, script.calls, _exposition(app)))
        app.close()
    assert runs[0][1] == runs[1][1]  # the attempt order, budgets and headers
    assert runs[0][0] == runs[1][0]  # statuses, replicas, exceptions, the ring
    assert runs[0][2] == runs[1][2]  # every mine_fleet_* family
    kinds = {o[0] for o in runs[0][0]}
    assert {200, "ring", "probe"} <= kinds


def test_collector_merge_and_hop_tree_match_jax():
    """The same member docs (one a merged doc itself, one unreachable) merge
    into the same doc and the same hop tree."""
    def doc(name, spans, exported):
        events = [{"ph": "M", "pid": 7, "tid": 0, "name": "process_name",
                   "args": {"name": "mine_tpu host spans"}}]
        for n, (sname, ts, args) in enumerate(spans):
            events.append({"ph": "X", "pid": 7, "tid": 1, "name": sname, "cat": "serve",
                           "ts": ts, "dur": 50.0 + n, "args": args})
        return {"traceEvents": events, "metadata": {"clock": {
            "exported_unix_s": exported, "exported_ts_us": 9000.0}, "dropped_spans": 1}}

    rid = "req-1"
    router = doc("router", [("request", 10.0, {"request_id": rid, "span_id": "a"}),
                            ("forward", 20.0, {"request_id": rid, "span_id": "b",
                                               "parent_span": "a"}),
                            ("forward", 30.0, {"request_id": "other", "span_id": "z"})],
                 1000.0)
    rep = doc("r0", [("request", 25.0, {"request_id": rid, "span_id": "c",
                                        "parent_span": "b"}),
                     ("dispatch", 40.0, {"request_ids": f"x,{rid}"}),
                     ("peer_fetch", 45.0, {"request_id": rid, "span_id": "d",
                                           "parent_span": "c"}),
                     ("request", 60.0, {"request_id": rid, "span_id": "e",
                                        "parent_span": "gone"})],
              1000.5)
    members = [{"name": "router", "doc": router, "skew_s": 0.0},
               {"name": "r0", "doc": rep, "skew_s": 0.25, "rtt_s": 0.01},
               {"name": "r1", "error": "ConnectionError: refused"}]
    got = tcollect.merge_member_traces(members)
    want = jcollect.merge_member_traces(members)
    assert got == want
    again = [{"name": "fleet", "doc": got, "skew_s": 0.5},
             {"name": "r0", "doc": rep, "skew_s": 0.1}]
    assert tcollect.merge_member_traces(again) == jcollect.merge_member_traces(again)
    for d in (got, router):
        tree = tcollect.request_tree(d, rid)
        assert tree == jcollect.request_tree(d, rid)
        assert tcollect.tree_depth(tree["tree"]) == jcollect.tree_depth(tree["tree"])
    assert tcollect.tree_depth(tcollect.request_tree(got, rid)["tree"]) == 4

    def fetch(url, timeout_s):
        if "r1" in url:
            raise ConnectionError("refused")
        return rep

    clock = iter([5.0, 5.5, 6.0, 6.5])
    assert tcollect.fetch_member_trace("r0", "http://r0/", rid, fetch_fn=fetch,
                                       now_fn=lambda: next(clock))["skew_s"] \
        == pytest.approx(1000.5 - 5.25)
    out = tcollect.collect_fleet_trace({"r0": "http://r0", "r1": "http://r1"},
                                       request_id=rid, fetch_fn=fetch)
    assert out["metadata"]["members"]["r1"]["error"].startswith("ConnectionError")
    assert out["metadata"]["request_tree"]["span_count"] == 4


def test_fake_slabs_are_the_jax_fakes():
    engine = JaxFakeEngine(checkpoint_step=3)
    bucket = engine.bucket((128, 128, 8))
    rng = np.random.default_rng(8)
    for _ in range(3):
        image = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
        want = engine._dispatch_predict(bucket, image, engine.variables)
        got = fake_slabs(image, 128, 128, 8, 3.0)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))


# -- live HTTP: replicas behind the router (port only) -------------------------

def _serve(app, make=make_server):
    srv = make(app)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, "http://%s:%d" % srv.server_address[:2]


def _http(base, path, data=None, headers=None):
    req = urllib.request.Request(base + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


class _Fleet:
    """Fake or real replicas, each behind its own server, with peers
    configured, and optionally a router over them."""

    def __init__(self, apps, router=True, make=make_server, fleet_mod=tfleet):
        self.apps, self.servers, self.urls = apps, [], {}
        for i, app in enumerate(apps):
            srv, url = _serve(app, make)
            self.servers.append(srv)
            self.urls[f"r{i}"] = url
        for i, app in enumerate(apps):
            app.configure_peers(self.urls, f"r{i}")
        self.fleet = self.fsrv = None
        if router:
            self.fleet = fleet_mod.FleetApp(self.urls, probe_interval_s=3600)
            self.fsrv, self.base = _serve(self.fleet, fleet_mod.make_fleet_server)

    def owner(self, data: bytes) -> str:
        return tfleet.HashRing(list(self.urls)).candidates(hashlib.sha256(data).hexdigest())[0]

    def close(self):
        for srv in self.servers + ([self.fsrv] if self.fsrv else []):
            srv.shutdown()
            srv.server_close()
        if self.fleet is not None:
            self.fleet.close()
        for app in self.apps:
            app.close()


def test_routed_answers_are_the_owners_bytes_and_swap_fans_out():
    fl = _Fleet([make_fake_app(checkpoint_step=1, device="cpu",
                               swap_source=lambda: fake_checkpoint(2)) for _ in range(3)])
    try:
        for i in range(6):
            img = _png(i, size=16)
            code, hdrs, body = _http(fl.base, "/predict", img, {"Content-Type": "image/png"})
            owner = fl.owner(img)
            assert code == 200 and hdrs["X-Mine-Replica"] == owner
            key = json.loads(body)["mpi_key"]
            req = json.dumps({"mpi_key": key, "offsets": [[0.01 * i, 0.0, 0.02]]}).encode()
            routed = _http(fl.base, "/render", req, {"Content-Type": "application/json"})
            direct = _http(fl.urls[owner], "/render", req, {"Content-Type": "application/json"})
            assert routed[0] == direct[0] == 200 and routed[2] == direct[2]
            code, _, blob = _http(fl.base, "/mpi/" + key)
            assert code == 200 and blob == fl.apps[int(owner[1])].compressed_blob(key)
        assert sum(a.metrics.encoder_invocations.value() for a in fl.apps) == 6
        code, _, body = _http(fl.base, "/admin/swap", json.dumps({"wait": True}).encode())
        out = json.loads(body)["replicas"]
        assert code == 200 and all(r["state"] == "ok" and r["generation"] == 1
                                   for r in out.values())
        assert [a.engine.checkpoint_step for a in fl.apps] == [2, 2, 2]
        code, _, body = _http(fl.base, "/healthz")
        assert code == 200 and json.loads(body)["ring_size"] == 3
        code, _, body = _http(fl.base, "/debug/trace?request_id=a%20b%0ac")
        assert code == 400 and "malformed request_id" in body.decode()
    finally:
        fl.close()


def _hop_tree(make_app, make, fleet_mod, collect_mod):
    """The three-process case: the owner is ejected from the router's ring
    (what the health gate does to a shedding replica) but stays up, so a
    routed /predict lands on the other replica, which peer-fetches. Returns
    the merged trace's hop edges with processes named by role."""
    fl = _Fleet([make_app(), make_app()], router=False, make=make)
    try:
        img = _png(7)
        owner = fl.owner(img)
        non_owner = next(n for n in fl.urls if n != owner)
        assert _http(fl.urls[owner], "/predict", img, {"Content-Type": "image/png"})[0] == 200
        fleet = fleet_mod.FleetApp(fl.urls, probe_interval_s=3600)
        for _ in range(2):
            fleet._observe(fleet.replicas[owner], False)
        assert fleet.ring_members() == [non_owner]
        fsrv, base = _serve(fleet, fleet_mod.make_fleet_server)
        try:
            rid = "req-accept-trace-1"
            code, hdrs, body = _http(base, "/predict", img,
                                     {"Content-Type": "image/png", "X-Request-Id": rid})
            assert code == 200 and json.loads(body)["cached"] is True
            assert hdrs["X-Request-Id"] == rid
            code, _, body = _http(base, f"/debug/trace?request_id={rid}")
            doc = json.loads(body)
        finally:
            fsrv.shutdown()
            fsrv.server_close()
            fleet.close()
        assert set(doc["metadata"]["members"]) == {"router", "r0", "r1"}
        for name in ("r0", "r1"):
            assert abs(doc["metadata"]["members"][name]["skew_s"]) < 5.0
        tree = doc["metadata"]["request_tree"]
        roles = {"router": "router", owner: "owner", non_owner: "non_owner"}

        def edges(nodes, parent=None):
            for n in nodes:
                node = (roles[n["process"].split(" ·")[0]], n["name"])
                yield (parent, node)
                yield from edges(n["children"], node)

        return sorted(edges(tree["tree"]), key=str), collect_mod.tree_depth(tree["tree"])
    finally:
        fl.close()


def test_merged_trace_has_the_jax_hop_tree_across_three_processes():
    got = _hop_tree(lambda: make_fake_app(device="cpu"), make_server, tfleet, tcollect)
    want = _hop_tree(jax_make_fake_app, jax_make_server, jfleet, jcollect)
    assert got == want
    edges, depth = got
    assert depth >= 5
    assert (("non_owner", "request"), ("non_owner", "peer_fetch")) in edges
    assert (("non_owner", "peer_fetch"), ("owner", "request")) in edges


TINY = {"data.img_h": 128, "data.img_w": 128, "model.num_layers": 18,
        "model.dtype": "float32", "mpi.num_bins_coarse": 4}


@pytest.fixture(scope="module")
def tiny_state():
    cfg = Config().replace(**TINY)
    return cfg, init_weights(build_model(cfg), torch.Generator().manual_seed(0)).state_dict()


@pytest.mark.parametrize("tier", ["fp32", "bf16", "int8"])
def test_peer_fetch_adopts_the_owners_entry_and_renders_its_frames(tier, tiny_state):
    """A real tiny RenderEngine on each replica: the non-owner adopts the
    owner's entry over /mpi/<key> instead of running its encoder, and its
    render of the adopted entry (through K5's plain version here) gives the
    owner's frames."""
    cfg, state = tiny_state
    cfg = cfg.replace(**{"serving.cache_tier": tier})
    fl = _Fleet([ServingApp(cfg, state, device="cpu") for _ in range(2)], router=False)
    try:
        img = np.random.default_rng(4).integers(0, 256, (128, 128, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        png = buf.getvalue()
        owner = fl.owner(png)
        o_app = fl.apps[int(owner[1])]
        n_app = fl.apps[1 - int(owner[1])]
        first = o_app.predict(png)
        adopted = n_app.predict(png)
        assert first["mpi_key"] == adopted["mpi_key"] and adopted["cached"] is True
        assert adopted["tier"] == tier
        assert n_app.metrics.peer_fetch.value(outcome="hit") == 1
        assert n_app.metrics.encoder_invocations.value() == 0
        key = key_from_str(first["mpi_key"])
        mine, theirs = n_app.cache.get(key, record=False), o_app.cache.get(key, record=False)
        assert type(mine) is type(theirs) is (MPIEntry if tier == "fp32" else CompressedMPI)
        fields = ((mine.mpi_rgb, theirs.mpi_rgb), (mine.mpi_sigma, theirs.mpi_sigma)) \
            if tier == "fp32" else ((mine.rgb, theirs.rgb), (mine.sigma, theirs.sigma))
        assert all(torch.equal(a, b) for a, b in fields)
        assert mine.nbytes == theirs.nbytes
        # a moved pose, not the identity, over an MPI that is not empty
        sigma = fields[1][0].float()
        assert sigma.abs().max() > 0
        offsets = np.array([[0.05, -0.03, 0.1], [-0.04, 0.02, -0.05]])
        got, _ = n_app.render(first["mpi_key"], poses_from_offsets(offsets))
        want, _ = o_app.render(first["mpi_key"], poses_from_offsets(offsets))
        still, _ = o_app.render(first["mpi_key"], poses_from_offsets(np.zeros((1, 3))))
        assert np.array_equal(got, want)
        assert np.abs(want[0] - still[0]).max() > 1e-3
        # the owner's own miss on a key nobody holds falls through to its encoder
        assert o_app.metrics.peer_fetch.value(outcome="hit") == 0
    finally:
        fl.close()


def test_adopt_entry_refuses_an_entry_that_does_not_fit_its_bucket(tiny_state):
    from mine_tpu_torch.serving.compress import from_wire, to_wire

    cfg, state = tiny_state
    app = ServingApp(cfg, state, device="cpu")
    try:
        entry = app.engine.predict(np.zeros((128, 128, 3), np.uint8))
        wire = from_wire(to_wire(entry))
        assert app.engine._adopt_entry(wire).mpi_rgb.device.type == "cpu"
        wire.bucket = (128, 256, 4)
        with pytest.raises(ValueError, match="bucket"):
            app.engine._adopt_entry(wire)
    finally:
        app.close()
