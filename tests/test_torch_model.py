"""The port's MPINetwork against the JAX package's, with the JAX variables
carried across by mine_tpu_torch/models/convert.py.

Both networks get the same seeded numpy weights (non-trivial BatchNorm
statistics, so eval-mode BN is not the identity) and the same input; the
four MPI scales must agree at the tolerance of tests/test_model_parity.py
(rtol 1e-3, atol 1e-4 of the output scale): fp32 convolutions on two
frameworks sum in different orders through 20-50 layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from mine_tpu.models import MPINetwork as JaxMPINetwork
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.models.embedder import positional_encode
from mine_tpu_torch.models.mpi import MPINetwork

B, S, H, W = 1, 3, 128, 128


def random_jax_variables(model, x, disparity, seed: int) -> dict:
    """Seeded numpy weights in the shape of `model`'s flax variables (no
    init compile: the shapes come from eval_shape)."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, disparity, False)
    )
    rng = np.random.default_rng(seed)
    flat = {}
    for key, sds in traverse_util.flatten_dict(shapes, sep="/").items():
        shape = sds.shape
        if key.endswith("kernel"):
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            val = rng.uniform(-bound, bound, shape)
        elif "BatchNorm_0" in key and key.endswith(("scale", "var")):
            val = rng.uniform(0.5, 1.5, shape)
        elif "BatchNorm_0" in key:  # shift and running mean
            val = rng.normal(0.0, 0.1, shape)
        else:  # conv bias
            val = rng.uniform(-0.05, 0.05, shape)
        flat[key] = val.astype(np.float32)
    return traverse_util.unflatten_dict(flat, sep="/")


def _inputs(rng):
    x = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    disparity = np.stack([np.linspace(1.0, 0.05, S, dtype=np.float32)] * B)
    return x, disparity


@pytest.mark.parametrize("num_layers", [18, 50])
def test_mpi_network_matches_jax(num_layers, rng):
    x, disparity = _inputs(rng)
    jax_model = JaxMPINetwork(num_layers=num_layers, multires=10, dtype=jnp.float32)
    variables = random_jax_variables(jax_model, jnp.asarray(x), jnp.asarray(disparity), 7)
    want = jax.jit(jax_model.apply, static_argnums=3)(
        variables, jnp.asarray(x), jnp.asarray(disparity), False
    )

    model = MPINetwork(num_layers=num_layers, multires=10).eval()
    model.load_state_dict(jax_variables_to_torch(flatten_variables(variables), num_layers))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(disparity))

    assert sorted(got) == [0, 1, 2, 3]
    for scale in range(4):
        w = np.asarray(want[scale])
        assert got[scale].shape == w.shape == (B, S, H >> scale, W >> scale, 4)
        np.testing.assert_allclose(
            got[scale].numpy(), w, rtol=1e-3,
            atol=1e-4 * max(1.0, float(np.abs(w).max())),
            err_msg=f"resnet{num_layers} MPI scale {scale}",
        )


def test_converter_is_strict(rng):
    x, disparity = _inputs(rng)
    jax_model = JaxMPINetwork(num_layers=18, multires=10, dtype=jnp.float32)
    flat = flatten_variables(
        random_jax_variables(jax_model, jnp.asarray(x), jnp.asarray(disparity), 3)
    )
    state = jax_variables_to_torch(flat, 18)
    # the converted dict is exactly the port model's state dict
    assert set(state) == set(MPINetwork(num_layers=18).state_dict())
    # HWIO -> OIHW
    kernel = flat["params/backbone/Conv_0/kernel"]
    w = state["backbone.encoder.conv1.weight"].numpy()
    assert w.shape == (64, 3, 7, 7) and w[5, 2, 1, 4] == kernel[1, 4, 2, 5]
    assert int(state["backbone.encoder.bn1.num_batches_tracked"]) == 0

    missing = dict(flat)
    missing.pop("params/backbone/BasicBlock_3/Conv_1/kernel")
    with pytest.raises(KeyError, match="missing"):
        jax_variables_to_torch(missing, 18)
    extra = dict(flat)
    extra["params/decoder/extra_head/kernel"] = np.zeros((3, 3, 4, 4), np.float32)
    with pytest.raises(ValueError, match="no place"):
        jax_variables_to_torch(extra, 18)
    # a resnet-18 tree is not a resnet-50 tree
    with pytest.raises(KeyError):
        jax_variables_to_torch(flat, 50)


def test_positional_encoding_layout_matches_jax(rng):
    from mine_tpu.models.embedder import positional_encode as jax_pe

    x = rng.uniform(0.001, 1.0, (6, 1)).astype(np.float32)
    got = positional_encode(torch.from_numpy(x), 10).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_pe(jnp.asarray(x), 10)),
                               rtol=1e-6, atol=1e-6)
    # [x, sin f0 x, cos f0 x, sin f1 x, ...]
    np.testing.assert_allclose(got[:, 0], x[:, 0])
    np.testing.assert_allclose(got[:, 3], np.sin(2.0 * x[:, 0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, 4], np.cos(2.0 * x[:, 0]), rtol=1e-6, atol=1e-6)
