"""The port's RenderEngine at every cache tier, with and without pruning,
against the JAX package's RenderEngine on the same weights and image, at
128x128, S=4, ResNet-18, fp32; then its weight swap, warmup and warm pool.

Tolerances: fp32 frames as tests/test_torch_slice.py states them (rgb atol
1e-3, disparity rtol 1e-3: the networks' fp32 convolutions sum in another
order). The bf16 and int8 slabs hold the two networks' slightly different
MPIs, so a value can round to the neighbouring code: bf16 slabs agree
within one bf16 step (at most 2^-7 relative), int8 slabs within one
quantisation step of the JAX dequantised slab. The renderer itself is held
at the fp32 tolerance on identical slabs: the JAX entry crosses the wire
into the port's engine.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mine_tpu.config import Config as JaxConfig
from mine_tpu.inference.trajectory import camera_trajectories
from mine_tpu.serving import compress as jc
from mine_tpu.serving.engine import RenderEngine as JaxEngine
from mine_tpu.training.step import build_model as jax_build_model
from mine_tpu_torch.config import Config
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.serving import compress as tc
from mine_tpu_torch.serving.engine import RenderEngine, SwapInProgress, SwapRejected
from tests.test_torch_model import random_jax_variables

H = W = 128
S = 4
TINY = {"data.img_h": H, "data.img_w": W, "model.num_layers": 18,
        "model.dtype": "float32", "mpi.num_bins_coarse": S}
# 0.3 drops one plane (3 kept: a pad plane fills the 4-plane bucket), 0.6
# two (the 2-plane bucket); measured on these weights' contributions
# (0.26, 0.52, 0.72, ~1e-6), the last plane always kept
PRUNE = (0.0, 0.3, 0.6)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig().replace(**TINY)
    variables = random_jax_variables(jax_build_model(jcfg), jnp.zeros((1, H, W, 3)),
                                     jnp.ones((1, S)), seed=11)
    state = jax_variables_to_torch(flatten_variables(variables), 18)
    image = np.random.default_rng(5).integers(0, 256, (H, W, 3), dtype=np.uint8)
    (_, zoom), (_, swing) = camera_trajectories("llff")[0]
    poses = np.stack([zoom[30], swing[10], swing[50]])
    jax_engine = JaxEngine(jcfg, variables["params"], variables["batch_stats"])
    port = RenderEngine(Config().replace(**TINY), state, device="cpu")
    return {"variables": variables, "state": state, "image": image, "poses": poses,
            "jax": jax_engine, "port": port}


def _frames_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3, err_msg="rgb")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-6, err_msg="disparity")


@pytest.mark.parametrize("prune_eps", PRUNE)
@pytest.mark.parametrize("tier", ["fp32", "bf16", "int8"])
def test_engine_tier_matches_jax(setup, tier, prune_eps):
    image, poses = setup["image"], setup["poses"]
    want = setup["jax"].predict(image, tier=tier, prune_eps=prune_eps)
    got = setup["port"].predict(image, tier=tier, prune_eps=prune_eps)
    assert type(got).__name__ == type(want).__name__
    assert got.bucket == tuple(want.bucket) == (H, W, S)
    if isinstance(want, jc.CompressedMPI):
        assert (got.tier, got.planes_kept, got.num_planes_full) == \
            (want.tier, want.planes_kept, want.num_planes_full)
        assert got.nbytes == want.nbytes
        np.testing.assert_allclose(got.disparity.numpy(), np.asarray(want.disparity),
                                   rtol=1e-6)
        deq_got = [t.numpy() for t in tc.decompress(got)[:2]]
        deq_want = [np.asarray(t) for t in jc.decompress(want)[:2]]
        for name, a, b in zip(("rgb", "sigma"), deq_got, deq_want):
            if tier == "int8":  # one quantisation step, per plane
                step = np.asarray(getattr(want, f"{name}_scale"))
                assert np.all(np.abs(a - b) <= step * (1 + 1e-3) + 1e-6), name
            elif tier == "bf16":  # one bf16 step: 8 significand bits, <= 2^-7 relative
                np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * max(1.0, np.abs(b).max()),
                                           err_msg=name)
    jax_frames = setup["jax"].render(want, poses)
    if tier == "fp32":
        _frames_close(setup["port"].render(got, poses), jax_frames)
    # the renderer on identical slabs: the JAX entry through the wire
    crossed = tc.from_wire(jc.to_wire(want))
    _frames_close(setup["port"].render(crossed, poses), jax_frames)
    if prune_eps:
        assert got.planes_kept == {0.3: 3, 0.6: 2}[prune_eps]


def test_pruned_render_pads_inert_planes(setup):
    """A 3-plane entry renders in the 4-plane bucket: one sigma-0 plane at
    the nearest surviving disparity in front, which moves the frame by no
    more than the compositor's 1e-6 epsilon."""
    port = setup["port"]
    entry = port.predict(setup["image"], tier="fp32", prune_eps=0.3)
    bucket = port.bucket(entry.bucket)
    rgb, sigma, disparity, _, n_planes = port._render_inputs(bucket, entry)
    assert n_planes == 4 and entry.planes_kept == 3
    assert torch.all(sigma[:, 0] == 0) and disparity[0, 0] == disparity[0, 1]
    assert torch.equal(rgb[:, 1:], entry.rgb)
    direct = tc.CompressedMPI(tier="fp32", rgb=entry.rgb, sigma=entry.sigma,
                              disparity=entry.disparity, k=entry.k, bucket=(H, W, 3),
                              num_planes_full=3)
    padded = port.render(entry, setup["poses"])
    unpadded = port.render(direct, setup["poses"])  # its own 3-plane bucket: no pad
    np.testing.assert_allclose(padded[0], unpadded[0], rtol=0, atol=1e-5)


def test_swap_weights_rejects_a_mismatch_and_flips_a_match(setup):
    state = setup["state"]
    engine = RenderEngine(Config().replace(**TINY), state, checkpoint_step=3, device="cpu")
    image, poses = setup["image"], setup["poses"]
    old = engine.predict(image)
    old_frames = engine.render(old, poses)
    live = engine.model
    live_weight = next(iter(live.parameters())).detach().clone()

    name = next(k for k, v in state.items() if v.dim() == 4)
    bad = {**state, name: torch.zeros(state[name].shape[0] + 1, *state[name].shape[1:])}
    with pytest.raises(SwapRejected, match=name):
        engine.swap_weights(bad, 4)
    missing = {k: v for k, v in state.items() if k != name}
    with pytest.raises(SwapRejected, match="missing leaf"):
        engine.swap_weights(missing, 4)
    assert engine.generation == 0 and engine.checkpoint_step == 3 and engine.model is live

    gen = torch.Generator().manual_seed(0)
    new_state = {k: (v + 0.01 * torch.randn(v.shape, generator=gen) if v.dim() == 4 else v)
                 for k, v in state.items()}
    engine._swap_lock.acquire()
    with pytest.raises(SwapInProgress):
        engine.swap_weights(new_state, 4)
    engine._swap_lock.release()

    ws = engine.swap_weights(new_state, 4)
    assert (ws.generation, ws.checkpoint_step) == (1, 4) and engine.generation == 1
    assert engine.model is not live and engine.weights() is ws
    # the old generation's module was never written to
    assert torch.equal(next(iter(live.parameters())), live_weight)
    again = engine.render(old, poses)  # the old entry still renders, unchanged
    np.testing.assert_array_equal(again[0], old_frames[0])
    new = engine.predict(image)
    assert not torch.equal(new.mpi_sigma, old.mpi_sigma)

    def broken(*args):
        raise RuntimeError("device rejected the weights")

    engine._dispatch_predict = broken
    with pytest.raises(SwapRejected, match="verification predict failed"):
        engine.swap_weights(state, 5)
    assert engine.generation == 1 and engine.checkpoint_step == 4


def test_warmup_and_warm_pool_match_jax(setup):
    """warmup makes one first dispatch per predict bucket and per (plane
    bucket, pose bucket) render, as many as the JAX engine compiles; after
    it, traffic on those buckets adds none."""
    kw = {"pose_buckets": (1, 2), "prune_eps": 0.3}
    port = RenderEngine(Config().replace(**TINY, **{"serving.prune_transmittance_eps": 0.3}),
                        setup["state"], device="cpu", pose_buckets=(1, 2))
    jcfg = JaxConfig().replace(**TINY)
    v = setup["variables"]
    jax_engine = JaxEngine(jcfg, v["params"], v["batch_stats"], **kw)
    assert port.warmup() == jax_engine.warmup() == 1 + 2 * 2
    assert port.compiles == jax_engine.compiles == 5
    pool, jpool = port.warm_pool(), jax_engine.warm_pool()
    assert pool == {k: {"predict": p["predict"], "render": [tuple(r) for r in p["render"]]}
                    for k, p in jpool.items()}
    assert pool == {"128x128x4": {"predict": True,
                                  "render": [(2, 1), (2, 2), (4, 1), (4, 2)]}}
    assert port.warmup() == 0
    entry = port.predict(setup["image"])
    port.render(entry, setup["poses"][:2])
    assert port.compiles == 5


def test_engine_refuses_bad_knobs(setup):
    cfg = Config().replace(**TINY)
    with pytest.raises(ValueError, match="cache_tier"):
        RenderEngine(cfg.replace(**{"serving.cache_tier": "fp16"}), setup["state"],
                     device="cpu")
    with pytest.raises(ValueError, match="prune_transmittance_eps"):
        RenderEngine(cfg.replace(**{"serving.prune_transmittance_eps": 1.0}),
                     setup["state"], device="cpu")
    tiered = RenderEngine(cfg.replace(**{"serving.cache_tier": "int8"}), setup["state"],
                          device="cpu")
    assert tiered.cache_tier == "int8" and tiered.prune_eps == 0.0
