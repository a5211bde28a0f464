"""The port's partition-rule table (mine_tpu_torch/parallel/rules.py)
against the JAX package's (mine_tpu/parallel/rules.py), on shapes alone.

For every leaf of the ResNet-18 and ResNet-50 MPINetworks the port's
tensors, resolved under their flax paths and flax-ordered shapes, land on
the same (flax dimension, axes) as the JAX table's placements of the same
leaves of a jax.eval_shape'd TrainState: parameters, Adam moments (the
port's probe path against the JAX package's real optax paths) and BatchNorm
statistics, on the meshes {fsdp 2}, {data 2, zero1}, {data 2 x fsdp 2,
zero1} and {data 4 x fsdp 2}, under the default table and with user rows
prepended; the torch dimension is the flax one through HWIO -> OIHW; and
placement_bytes agree. The pure functions (partition_dim, resolve_placement,
parse_rule, batch_spec) agree on every leaf and row; an unmatched leaf and an
inconsistent override row raise as in tests/test_rules.py.
"""

from __future__ import annotations

import re

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {
    "fsdp2": ({"data": 1, "fsdp": 2, "plane": 1}, False),
    "data2_zero1": ({"data": 2, "fsdp": 1, "plane": 1}, True),
    "data2_fsdp2_zero1": ({"data": 2, "fsdp": 2, "plane": 1}, True),
    "data4_fsdp2": ({"data": 4, "fsdp": 2, "plane": 1}, False),
}
USER_ROWS = {
    "default": [],
    "decoder_replicated": ["^params/decoder/ = replicated"],
    "moments_data_first": [r"^opt_state/.*\b(mu|nu)/.*kernel$ = fsdp,data",
                           "^params/backbone/.*kernel$ = fsdp"],
}
MIN_SIZE = 1024


def _overrides(zero1: bool, rows: list[str], num_layers: int) -> dict:
    return {"data.img_h": 128, "data.img_w": 128, "model.num_layers": num_layers,
            "model.dtype": "float32", "model.imagenet_pretrained": False,
            "mpi.num_bins_coarse": 2, "parallel.zero1": zero1, "parallel.rules": rows,
            "parallel.zero1_min_size": MIN_SIZE}


@pytest.fixture(scope="module", params=[18, 50])
def models(request):
    """(num_layers, the JAX TrainState of ShapeDtypeStructs, the port's
    model) — shapes only, no compile and no forward."""
    from mine_tpu.config import Config as JaxConfig
    from mine_tpu.training import build_model as jax_build_model
    from mine_tpu.training import init_state, make_optimizer as jax_make_optimizer
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.training.step import build_model

    n = request.param
    jcfg = JaxConfig().replace(**_overrides(True, [], n))
    jmodel = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg, steps_per_epoch=100)
    shapes = jax.eval_shape(lambda key: init_state(jcfg, jmodel, tx, key, load_pretrained=False),
                            jax.random.PRNGKey(0))
    with torch.device("meta"):
        model = build_model(Config().replace(**_overrides(True, [], n)))
    return n, shapes, model


def _jax_placements(shapes, rows, mesh, zero1):
    """The JAX table's placements of the state, flat: {"params/...": pl},
    {"params/<path>": moment pl} (each real mu/nu leaf under its param's
    path; mu and nu must agree) and {"batch_stats/...": pl}."""
    from mine_tpu.parallel import rules as jrules

    placed = jrules.state_placements(jrules.partition_rules(_jcfg(zero1, rows)), shapes, mesh,
                                     MIN_SIZE)
    is_pl = lambda x: isinstance(x, jrules.Placement)  # noqa: E731

    def flat(tree, prefix):
        return {jrules.leaf_path(path, prefix): pl
                for path, pl in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_pl)}

    moments: dict[str, object] = {}
    for path, pl in flat(placed.opt_state, "opt_state").items():
        found = list(re.finditer(r"\b(mu|nu)/", path))
        if found:
            key = "params/" + path[found[-1].end():]
            assert moments.setdefault(key, pl) == pl, path
    return flat(placed.params, "params"), moments, flat(placed.batch_stats, "batch_stats")


def _same(port_pl, jax_pl) -> bool:
    return (port_pl.replicated and jax_pl.replicated) or \
        (port_pl.dim, port_pl.axes) == (jax_pl.dim, jax_pl.axes)


@pytest.mark.parametrize("rows", sorted(USER_ROWS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_every_leaf_is_placed_as_jax_places_it(models, mesh_name, rows):
    """Parameters, moments and statistics: the same flax dimension and axes
    for every leaf, the torch dimension its OIHW twin, and the same bytes."""
    from mine_tpu.parallel import rules as jrules
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.parallel import rules

    n, shapes, model = models
    mesh, zero1 = MESHES[mesh_name]
    jparams, jmoments, jstats = _jax_placements(shapes, USER_ROWS[rows], mesh, zero1)
    cfg = Config().replace(**_overrides(zero1, USER_ROWS[rows], n))
    leaves = rules.model_leaves(model, n)
    params = {lf.path: lf.shape for lf in leaves if lf.path.startswith("params/")}
    stats = {lf.path: lf.shape for lf in leaves if lf.path.startswith("batch_stats/")}
    placed = rules.state_placements(rules.partition_rules(cfg), params, stats, mesh, MIN_SIZE)
    assert set(placed["params"]) == set(jparams) and set(placed["opt_state"]) == set(jmoments)
    assert set(placed["batch_stats"]) == set(jstats)
    for group, want in (("params", jparams), ("opt_state", jmoments), ("batch_stats", jstats)):
        bad = [p for p, pl in placed[group].items() if not _same(pl, want[p])]
        assert not bad, (group, bad[:3], [(placed[group][p], want[p]) for p in bad[:3]])
    assert any(not pl.replicated for pl in placed["opt_state"].values())
    # the torch placement is the flax one through HWIO -> OIHW
    layout = rules.torch_layout(rules.partition_rules(cfg), model, n, mesh, MIN_SIZE)
    by_name = {lf.name: lf for lf in leaves}
    for name, pl in layout.params.items():
        lf = by_name[name]
        flax_pl = placed["params"][lf.path]
        assert pl.replicated == flax_pl.replicated
        if not pl.replicated:
            assert pl.dim == lf.to_torch[flax_pl.dim] and pl.axes == flax_pl.axes
            assert tuple(model.get_parameter(name).shape)[pl.dim] == lf.shape[flax_pl.dim]
    # bytes: the JAX package's placement_bytes of the params and of mu + nu
    jplaced = jrules.state_placements(jrules.partition_rules(_jcfg(zero1, USER_ROWS[rows])),
                                      shapes, mesh, MIN_SIZE)
    full = {p: (s, 4) for p, s in params.items()}
    assert rules.placement_bytes(full, placed["params"], mesh) == \
        jrules.placement_bytes(shapes.params, jplaced.params, mesh)
    is_pl = lambda x: isinstance(x, jrules.Placement)  # noqa: E731
    mu_nu = [(leaf, pl) for (path, leaf), pl in zip(
        jax.tree_util.tree_leaves_with_path(shapes.opt_state),
        jax.tree.leaves(jplaced.opt_state, is_leaf=is_pl))
        if re.search(r"\b(mu|nu)/", jrules.leaf_path(path, "opt_state"))]
    want_moments = sum(int(np.prod(leaf.shape)) * 4 // pl.shards(mesh) for leaf, pl in mu_nu)
    assert 2 * rules.placement_bytes(full, placed["opt_state"], mesh) == want_moments


def _jcfg(zero1, rows):
    from mine_tpu.config import Config as JaxConfig

    return JaxConfig().replace(**{"parallel.zero1": zero1, "parallel.rules": rows})


def test_pure_functions_agree_on_every_leaf(models):
    """partition_dim and resolve_placement on every flax-ordered leaf shape
    and every axes row, parse_rule and batch_spec on every row form."""
    from mine_tpu.config import Config as JaxConfig
    from mine_tpu.parallel import rules as jrules
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.parallel import rules

    n, _, model = models
    mesh = {"data": 2, "fsdp": 2, "plane": 2}
    shapes = {lf.shape for lf in rules.model_leaves(model, n)} | {(4, 6), (3, 3, 16, 2048), ()}
    for shape in sorted(shapes):
        for k in (1, 2, 4, 8):
            assert rules.partition_dim(shape, k, MIN_SIZE) == \
                jrules.partition_dim(shape, k, MIN_SIZE), (shape, k)
        for axes in (None, ("fsdp",), ("fsdp", "data"), ("data", "fsdp"), ("plane", "data")):
            want = jrules.resolve_placement(shape, axes, mesh, MIN_SIZE)
            got = rules.resolve_placement(shape, axes, mesh, MIN_SIZE)
            assert (got.dim, got.axes) == (want.dim, want.axes), (shape, axes)
    for row in ("^params/ = fsdp", "^x = fsdp,data", "^x = replicated", "^batch/ = data,fsdp @ 0",
                "^x = none", "^y =", *sum(USER_ROWS.values(), [])):
        want = jrules.parse_rule(row)
        assert rules.parse_rule(row) == rules.Rule(want.pattern, want.axes, want.dim), row
    for bad in ("^x = tensor", "just-a-pattern"):
        with pytest.raises(ValueError) as want:
            jrules.parse_rule(bad)
        with pytest.raises(ValueError) as got:
            rules.parse_rule(bad)
        assert str(got.value) == str(want.value)
    for rows in ([], ["^batch/ = data @ 0"]):
        table = rules.partition_rules(Config().replace(**{"parallel.rules": rows}))
        jtable = jrules.partition_rules(JaxConfig().replace(**{"parallel.rules": rows}))
        assert [(r.pattern, r.axes, r.dim) for r in table] == \
            [(r.pattern, r.axes, r.dim) for r in jtable]
        spec = jrules.batch_spec(jtable)[0]
        assert rules.batch_spec(table) == (spec if isinstance(spec, tuple) else (spec,))
    with pytest.raises(ValueError, match="dim 0"):
        rules.batch_spec(rules.partition_rules(
            Config().replace(**{"parallel.rules": ["^batch/ = data @ 1"]})))


def test_unmatched_leaf_and_inconsistent_rows_raise(models):
    """A leaf no row matches raises naming it; a row that shards
    parameters but replicates their moments raises naming the parameter
    (tests/test_rules.py's two failures)."""
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.parallel import rules

    n, _, model = models
    with pytest.raises(ValueError, match="no partition rule matches leaf 'batch_stats/"):
        rules.match_partition_rules((rules.Rule(r"^params/", ("fsdp",)),),
                                    {"batch_stats/x/mean": (64,)}, {"fsdp": 2}, 1)
    bad = Config().replace(**{"parallel.zero1": True,
                              "parallel.rules": [r"^opt_state/.*\b(mu|nu)/ = replicated"]})
    with pytest.raises(ValueError, match="moments replicate"):
        rules.torch_layout(rules.partition_rules(bad), model, n,
                           {"data": 2, "fsdp": 2, "plane": 2}, MIN_SIZE)
    split = Config().replace(**{"parallel.rules": [r"^opt_state/.*\b(mu|nu)/ = data"]})
    with pytest.raises(ValueError, match="is not a prefix of its moment placement"):
        rules.torch_layout(rules.partition_rules(split), model, n,
                           {"data": 2, "fsdp": 2, "plane": 1}, MIN_SIZE)
