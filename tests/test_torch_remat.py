"""Sigma dropout and activation recompute (model.remat_decoder).

Sigma dropout: the JAX decoder draws one Bernoulli keep per (b, s) plane at
each output scale and scales sigma by 1/(1 - p) (mine_tpu/models/decoder.py).
Its train-mode forward at p = 0.5 gives sigma exactly 0 on dropped planes
and >= 1e-4 / (1 - p) elsewhere, so its masks read back off the output; the
port's decoder, given those masks, must give the same MPIs at the model
tolerance of tests/test_torch_model.py (rtol 1e-3, atol 1e-4 of the output
scale), at 256x256 so that the train-mode BatchNorms of the decoder
extension see 8 values a channel.

Remat: on the CPU every op repeats bit for bit, so a train step with and
without recompute must give bit-equal loss, gradients and BatchNorm
statistics, the statistics moving exactly once (the recompute re-runs
train-mode BatchNorm; a guard keeps it from updating them a second time),
with sigma dropout on (the masks are drawn outside the recomputed regions).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from mine_tpu.models import MPINetwork as JaxMPINetwork
from mine_tpu_torch.config import Config
from mine_tpu_torch.data.synthetic import make_synthetic_batch
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.models.mpi import MPINetwork, init_weights
from mine_tpu_torch.models.norm import BatchNorm2d
from mine_tpu_torch.training import step as tstep
from torch_threads import one_torch_thread  # noqa: F401

B, S, H, W = 2, 3, 128, 128
RATE = 0.5
TINY = {
    "data.name": "synthetic", "data.img_h": H, "data.img_w": W,
    "data.per_gpu_batch_size": B, "model.num_layers": 18, "model.dtype": "float32",
    "mpi.num_bins_coarse": S, "data.visible_point_count": 16,
    "loss.smoothness_lambda_v1": 0.5,
}


def test_sigma_dropout_matches_the_jax_decoder(rng):
    # at 128x128 they would see 2 values a channel, where fp32 rounding
    # alone flips outputs
    x = rng.uniform(0, 1, (B, 2 * H, 2 * W, 3)).astype(np.float32)
    disparity = np.stack([np.linspace(1.0, 0.05, S, dtype=np.float32)] * B)
    jmodel = JaxMPINetwork(num_layers=18, multires=10, dtype=jnp.float32,
                           sigma_dropout_rate=RATE)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, disparity, True))
    wrng = np.random.default_rng(3)
    flat = {}
    for key, sds in traverse_util.flatten_dict(shapes, sep="/").items():
        if key.endswith("kernel"):
            val = wrng.uniform(-1, 1, sds.shape) / np.sqrt(np.prod(sds.shape[:-1]))
        elif "BatchNorm_0" in key and key.endswith(("scale", "var")):
            val = wrng.uniform(0.5, 1.5, sds.shape)
        else:
            val = wrng.normal(0.0, 0.05, sds.shape)
        flat[key] = val.astype(np.float32)
    variables = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                             sep="/")
    want, _ = jax.jit(lambda v, key: jmodel.apply(v, x, disparity, True, rngs={"dropout": key},
                                                  mutable=["batch_stats"]))(
        variables, jax.random.PRNGKey(7))
    scales = (0, 1, 2, 3)
    # sigma = (|x| + 1e-4) keep / (1 - p): zero exactly where dropped
    keep = np.stack([(np.asarray(want[s])[..., 3] != 0).all(axis=(2, 3)) for s in scales])
    dropped = [(np.asarray(want[s])[..., 3] == 0).all(axis=(2, 3)) for s in scales]
    assert all(np.array_equal(~k, d) for k, d in zip(keep, dropped))  # whole planes
    assert keep.any() and (~keep).any()
    model = MPINetwork(num_layers=18, multires=10, sigma_dropout_rate=RATE)
    model.load_state_dict(jax_variables_to_torch(flatten_variables(
        jax.tree.map(np.asarray, variables)), 18))
    model.train()
    with pytest.raises(ValueError, match="sigma_keep"):
        model(torch.from_numpy(x), torch.from_numpy(disparity))
    got = model(torch.from_numpy(x), torch.from_numpy(disparity),
                torch.from_numpy(keep.astype(np.float32)))
    for s in scales:
        w = np.asarray(want[s])
        np.testing.assert_allclose(got[s].detach().numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=f"scale {s}")
    model.eval()  # no dropout in eval mode, no mask needed
    model(torch.from_numpy(x), torch.from_numpy(disparity))


def _step(cfg, model, batch, seed):
    """One forward + backward with seeded disparity and dropout draws:
    (total, gradients, BatchNorm buffers, saved-tensor bytes)."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _, _ = tstep.loss_fcn(cfg, model, batch, torch.Generator().manual_seed(seed),
                                     dropout_generator=torch.Generator().manual_seed(seed + 1))
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return total.detach(), grads, buffers, sum(saved)


@pytest.mark.parametrize("compositor", ["dense", "streaming"])
def test_remat_is_bit_equal_and_moves_statistics_once(compositor):
    cfg = Config().replace(**{**TINY, "mpi.compositor": compositor,
                              "mpi.sigma_dropout_rate": 0.3})
    batch = {k: torch.from_numpy(v) for k, v in make_synthetic_batch(
        B, H, W, n_points=16, seed=2).items() if k != "src_depth"}
    plain = init_weights(tstep.build_model(cfg), torch.Generator().manual_seed(4)).train()
    remat = copy.deepcopy(plain)
    remat.remat = True
    start = {n: b.clone() for n, b in plain.named_buffers()}
    want = _step(cfg, plain, batch, seed=9)
    got = _step(cfg, remat, batch, seed=9)
    assert torch.equal(got[0], want[0]), "loss"
    assert all(torch.equal(got[1][n], want[1][n]) for n in want[1]), "gradients"
    assert all(torch.equal(got[2][n], want[2][n]) for n in want[2]), "BatchNorm statistics"
    counts = {b.num_batches_tracked.item() for b in remat.modules() if isinstance(b, BatchNorm2d)}
    assert counts == {1}, f"statistics moved {counts} times"
    moved = [n for n in start if n.endswith("running_mean")
             and not torch.equal(start[n], got[2][n])]
    assert moved  # the statistics did move, once
    # what recompute buys: far fewer activation bytes kept for the backward
    assert got[3] < 0.5 * want[3], (got[3], want[3])


def test_conv3x3_slices_a_batch_past_the_pad_limit(monkeypatch):
    """Past 2^31 padded elements (CUDA's reflection pad indexes in 32 bits)
    the decoder's 3x3 conv pads and convolves slices of the plane batch:
    the same function, forward and backward, to the conv's rounding."""
    from mine_tpu_torch.models import decoder

    conv = decoder.Conv3x3(3, 2)
    x = torch.randn(7, 3, 9, 10, generator=torch.Generator().manual_seed(0), requires_grad=True)
    want = conv(x)
    (want * want).sum().backward()
    want_grads = [x.grad.clone(), conv.conv.weight.grad.clone()]
    x.grad = conv.conv.weight.grad = None
    monkeypatch.setattr(decoder, "_MAX_PAD_ELEMENTS", 3 * 11 * 12 * 2)  # two samples a slice
    got = conv(x)
    (got * got).sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(x.grad, want_grads[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(conv.conv.weight.grad, want_grads[1], rtol=1e-5, atol=1e-5)
