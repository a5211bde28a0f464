"""A `parallel.rules` row that shards BatchNorm statistics
(`^batch_stats/ = fsdp`): the JAX package resolves it in its table but
cannot train with it, and the port refuses it by name.

The input: ResNet-18, 128x128, S=2, fp32, mesh data=4 x fsdp=2 on the
8-device host platform (tests/conftest.py), `parallel.zero1_min_size` 64 so
that the statistics are large enough to shard. Both tables put 60 of the 68
statistics on fsdp. JAX's parallel train step then fails while it is traced
(jax.eval_shape: no compile): flax's BatchNorm adds the device's (C/2,)
running-mean shard to the batch's (C,) mean, `TypeError: add got
incompatible shapes for broadcasting: (32,), (64,)`. The port's
torch_layout raises NotImplementedError naming that failure.
"""

from __future__ import annotations

import jax
import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROW = "^batch_stats/ = fsdp"
OVER = {"data.img_h": 128, "data.img_w": 128, "model.num_layers": 18,
        "model.dtype": "float32", "model.imagenet_pretrained": False,
        "mpi.num_bins_coarse": 2, "mpi.fix_disparity": True, "mesh.data_parallel": 4,
        "mesh.fsdp_parallel": 2, "parallel.rules": [ROW], "parallel.zero1_min_size": 64}
MESH = {"data": 4, "fsdp": 2, "plane": 1}


def _jax_state():
    from mine_tpu.config import Config
    from mine_tpu.parallel import make_mesh, model_axes
    from mine_tpu.training import build_model, init_state, make_optimizer

    cfg = Config().replace(**OVER)
    mesh = make_mesh(4, 1, 2)
    model = build_model(cfg, **model_axes(mesh))
    tx = make_optimizer(cfg, steps_per_epoch=100)
    shapes = jax.eval_shape(lambda k: init_state(cfg, model, tx, k, load_pretrained=False),
                            jax.random.PRNGKey(0))
    return cfg, mesh, model, tx, shapes


def test_jax_step_fails_on_a_sharded_statistics_row():
    from mine_tpu.data import make_synthetic_batch
    from mine_tpu.parallel import make_parallel_train_step, rules

    cfg, mesh, model, tx, shapes = _jax_state()
    placed = rules.state_placements(rules.partition_rules(cfg), shapes, mesh,
                                    cfg.parallel.zero1_min_size)
    stats = jax.tree_util.tree_leaves(placed.batch_stats,
                                      is_leaf=lambda x: isinstance(x, rules.Placement))
    assert sum(pl.axes == ("fsdp",) for pl in stats) == 60 and len(stats) == 68
    step = make_parallel_train_step(cfg, model, tx, mesh, state=shapes)
    batch = make_synthetic_batch(8, 128, 128, n_points=16, seed=0)
    batch.pop("src_depth")
    with pytest.raises(TypeError, match="add got incompatible shapes for broadcasting"):
        jax.eval_shape(step, shapes, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                      for k, v in batch.items()})


def test_port_refuses_the_row_naming_the_jax_failure():
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.parallel import rules
    from mine_tpu_torch.training.step import build_model

    cfg = Config().replace(**OVER)
    model = build_model(cfg)
    leaves = rules.model_leaves(model, 18)
    placed = rules.state_placements(
        rules.partition_rules(cfg),
        {lf.path: lf.shape for lf in leaves if lf.path.startswith("params/")},
        {lf.path: lf.shape for lf in leaves if lf.path.startswith("batch_stats/")},
        MESH, cfg.parallel.zero1_min_size)
    assert sum(pl.axes == ("fsdp",) for pl in placed["batch_stats"].values()) == 60
    with pytest.raises(NotImplementedError,
                       match="shards BatchNorm statistics.*add got incompatible shapes"):
        rules.torch_layout(rules.partition_rules(cfg), model, 18, MESH,
                           cfg.parallel.zero1_min_size)
