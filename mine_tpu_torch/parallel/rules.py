"""The partition-rule table: one regex -> placement table decides the layout
of parameters, Adam moments, BatchNorm statistics and batch rows
(counterpart of mine_tpu/parallel/rules.py; its semantics, defaults and
messages).

A rule is `(pattern, axes, dim)`: `pattern` is re.search'ed against a
leaf's '/'-joined path (first match wins, an unmatched leaf raises), `axes`
the mesh axes one dimension splits over (major first; None replicates) and
`dim` the dimension (None: the shape rule of `partition_dim`; an int pins
it and must divide). Size-1 axes drop out; multi-axis rows resolve anchored
left to right, so that a moment row ("fsdp", "data") lands on the dimension
its parameter's ("fsdp",) row picked for the same shape.

The default table (`partition_rules`), with `parallel.rules` rows
("pattern = axes[@ dim]") prepended and `parallel.zero1` selecting the
moment row's axes:

  ^(step|rng)$                -> replicated
  ^params/.*kernel$           -> ("fsdp",)
  ^params/                    -> replicated
  ^batch_stats/               -> replicated
  ^opt_state/.*\\b(mu|nu)/     -> ("fsdp", "data")   (("fsdp",) without zero1)
  ^opt_state/                 -> replicated
  ^batch/                     -> ("data", "fsdp") at dim 0

Paths and shapes are the JAX package's. Rows such as
`^params/decoder/ = replicated` are written against flax paths
(`params/backbone/Bottleneck_3/Conv_1/kernel`, `batch_stats/...`) and
`partition_dim` breaks ties between equal dimensions by index, so a rule must
see a torch tensor under its flax path and in its flax-ordered shape (HWIO
kernels where torch has OIHW): the same rule on (64, 64, 3, 3) would split
the output channels where flax's (3, 3, 64, 64) splits the input channels.
`model_leaves` resolves every parameter and BatchNorm statistic of an
MPINetwork under its flax path (models/convert.py's row map) and
`torch_layout` translates the resolved flax dimension back to the torch
tensor's. Adam's exp_avg / exp_avg_sq are matched as the `mu` / `nu` rows
under the probe path `opt_state/mu/<param path>` the JAX package's
update_placements uses; the port keeps each moment beside its parameter, so
the probe path is also the resident one.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Iterable, Mapping

import torch

from mine_tpu_torch.parallel.mesh import AXIS_NAMES, DATA_AXIS, FSDP_AXIS

# flax dimension -> torch dimension of a conv kernel (HWIO -> OIHW)
KERNEL_TO_TORCH = (2, 3, 1, 0)


@dataclass(frozen=True)
class Rule:
    """One row of the table: leaf-path regex -> mesh-axis assignment."""

    pattern: str
    axes: tuple[str, ...] | None  # None = replicate
    dim: int | None = None  # None = shape rule; int = pinned dimension


@dataclass(frozen=True)
class Placement:
    """Which dimension of a leaf splits over which mesh axes (major first).
    `dim == -1` (REPLICATED) means the leaf lives whole on every rank."""

    dim: int
    axes: tuple[str, ...] = ()

    @property
    def replicated(self) -> bool:
        return self.dim < 0 or not self.axes

    def shards(self, mesh_shape: Mapping[str, int]) -> int:
        if self.replicated:
            return 1
        return math.prod(mesh_shape[a] for a in self.axes)


REPLICATED = Placement(dim=-1, axes=())


# -- the table ----------------------------------------------------------------------------


def parse_rule(row: str) -> Rule:
    """One `parallel.rules` row: `"pattern = axes"`, axes a comma-joined
    mesh-axis list, `replicated`, or `axes @ dim` to pin the dimension."""
    if "=" not in row:
        raise ValueError(f"parallel.rules row {row!r} is not 'pattern = axes'")
    pattern, _, rhs = row.partition("=")
    rhs = rhs.strip()
    dim: int | None = None
    if "@" in rhs:
        rhs, _, d = rhs.partition("@")
        dim = int(d.strip())
    rhs = rhs.strip()
    if rhs.lower() in ("", "replicated", "none"):
        axes = None
    else:
        axes = tuple(a.strip() for a in rhs.split(",") if a.strip())
        unknown = set(axes) - set(AXIS_NAMES)
        if unknown:
            raise ValueError(f"parallel.rules row {row!r} names unknown mesh axes "
                             f"{sorted(unknown)} (mesh axes: {AXIS_NAMES})")
    return Rule(pattern.strip(), axes, dim)


def partition_rules(cfg: Any) -> tuple[Rule, ...]:
    """The table: `parallel.rules` rows first (first match wins), then the
    defaults; `parallel.zero1` selects the moment row's axes."""
    user = tuple(parse_rule(r) for r in cfg.parallel.rules)
    opt_axes = (FSDP_AXIS, DATA_AXIS) if cfg.parallel.zero1 else (FSDP_AXIS,)
    return user + (
        Rule(r"^(step|rng)$", None),
        Rule(r"^params/.*kernel$", (FSDP_AXIS,)),
        Rule(r"^params/", None),
        Rule(r"^batch_stats/", None),
        Rule(r"^opt_state/.*\b(mu|nu)/", opt_axes),
        Rule(r"^opt_state/", None),
        Rule(r"^batch/", (DATA_AXIS, FSDP_AXIS), dim=0),
    )


def _match(rules: Iterable[Rule], path: str) -> Rule:
    for rule in rules:
        if re.search(rule.pattern, path):
            return rule
    raise ValueError(
        f"no partition rule matches leaf {path!r} — every leaf must be "
        "matched explicitly (add a row to parallel.rules or the default "
        "table in parallel/rules.py)"
    )


# -- resolution ---------------------------------------------------------------------------


def partition_dim(shape: tuple[int, ...], n_shards: int, min_size: int) -> int:
    """The dimension of a leaf to split over n_shards, or -1 (replicate):
    dimensions largest first (ties by index), the first that n_shards
    divides; leaves under min_size elements, scalars and leaves with no
    dividing dimension replicate."""
    if not shape or n_shards <= 1:
        return -1
    if math.prod(shape) < min_size:
        return -1
    for d in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[d] % n_shards == 0 and shape[d] >= n_shards:
            return d
    return -1


def resolve_placement(shape: tuple[int, ...], axes: tuple[str, ...] | None,
                      mesh_shape: Mapping[str, int], min_size: int, dim: int | None = None,
                      path: str = "?") -> Placement:
    """A rule's axes -> the Placement of a leaf of `shape`: size-1 axes
    drop out; a pinned dim must divide; otherwise the first live axis picks
    the dimension alone (partition_dim) and the trailing axes extend the
    split while the dimension keeps dividing."""
    if not axes:
        return REPLICATED
    live = tuple(a for a in axes if mesh_shape.get(a, 1) > 1)
    if not live:
        return REPLICATED
    if dim is not None:
        n = math.prod(mesh_shape[a] for a in live)
        if dim >= len(shape) or shape[dim] % n:
            raise ValueError(f"{path}: dim {dim} of shape {tuple(shape)} does not divide "
                             f"over axes {live} (sizes {[mesh_shape[a] for a in live]})")
        return Placement(dim, live)
    d = partition_dim(shape, mesh_shape[live[0]], min_size)
    if d < 0:
        return resolve_placement(shape, live[1:], mesh_shape, min_size, path=path)
    keep = 1
    n = mesh_shape[live[0]]
    for a in live[1:]:
        if shape[d] % (n * mesh_shape[a]):
            break
        n *= mesh_shape[a]
        keep += 1
    return Placement(d, live[:keep])


def match_partition_rules(rules: Iterable[Rule], shapes: Mapping[str, tuple[int, ...]],
                          mesh_shape: Mapping[str, int], min_size: int,
                          prefix: str = "") -> dict[str, Placement]:
    """{path: shape} -> {path: Placement} by the first matching rule,
    each path matched as `prefix/path`. An unmatched leaf raises."""
    rules = tuple(rules)
    out = {}
    for path, shape in shapes.items():
        full = f"{prefix.strip('/')}/{path}" if prefix else path
        rule = _match(rules, full)
        out[path] = resolve_placement(tuple(shape), rule.axes, mesh_shape, min_size,
                                      dim=rule.dim, path=full)
    return out


def _param_suffix(path: str) -> str:
    return path[len("params/"):] if path.startswith("params/") else path


def update_placements(rules: Iterable[Rule], params: Mapping[str, tuple[int, ...]],
                      mesh_shape: Mapping[str, int], min_size: int) -> dict[str, Placement]:
    """For each parameter ({"params/...": shape}), the placement its Adam
    moments get: matched under the probe path `opt_state/mu/<param path>`.
    The sharded update slices gradients and parameters by these, steps Adam
    on the shard, and gathers each update back to its parameter's layout."""
    probe = match_partition_rules(rules, {_param_suffix(p): s for p, s in params.items()},
                                  mesh_shape, min_size, prefix="opt_state/mu")
    return {p: probe[_param_suffix(p)] for p in params}


def _validate_update_layout(param_pl: Mapping[str, Placement],
                            update_pl: Mapping[str, Placement]) -> None:
    """Every parameter's moment placement must extend its own (same dim,
    its axes a prefix), or the parameter replicates: else the update cannot
    be assembled. The JAX package's second check; its first (resident
    moment leaves against their probe twins) holds by construction here,
    where the resident moment is matched under the probe path."""
    for path, ppl in param_pl.items():
        upl = update_pl[path]
        if upl.replicated:
            if not ppl.replicated:
                raise ValueError(f"{path}: param sharded {ppl} but its optimizer moments "
                                 "replicate — the update cannot be assembled; align the "
                                 "params/ and opt_state/ rule rows")
            continue
        if ppl.replicated:
            continue
        if ppl.dim != upl.dim or upl.axes[:len(ppl.axes)] != ppl.axes:
            raise ValueError(f"{path}: param placement {ppl} is not a prefix of its moment "
                             f"placement {upl} — the rule rows for params/ and opt_state/ "
                             "moments must agree on the split")


def state_placements(rules: Iterable[Rule], params: Mapping[str, tuple[int, ...]],
                     batch_stats: Mapping[str, tuple[int, ...]],
                     mesh_shape: Mapping[str, int], min_size: int) -> dict[str, dict]:
    """{"params", "opt_state", "batch_stats"} placement maps (flax paths,
    flax dimensions) of a training state: the parameters under their
    `params/` paths, the moments under the probe path (keyed by their
    parameter's path), the statistics under `batch_stats/`; validated."""
    rules = tuple(rules)
    placed = {
        "params": match_partition_rules(rules, params, mesh_shape, min_size),
        "opt_state": update_placements(rules, params, mesh_shape, min_size),
        "batch_stats": match_partition_rules(rules, batch_stats, mesh_shape, min_size),
    }
    _validate_update_layout(placed["params"], placed["opt_state"])
    return placed


def batch_spec(rules: Iterable[Rule]) -> tuple[str, ...]:
    """The mesh axes the batch rows shard over, read off the `^batch/` row
    (its dim must be 0); () when the row replicates."""
    rule = _match(tuple(rules), "batch/src_img")
    if rule.axes is None:
        return ()
    if (rule.dim or 0) != 0:
        raise ValueError(f"the batch rule must pin dim 0 (got dim={rule.dim}); batches "
                         "shard their leading (example) axis only")
    return rule.axes


# -- torch models under flax paths ----------------------------------------------------------


@dataclass(frozen=True)
class Leaf:
    """A tensor of the model under its flax path: `path` ("params/..." or
    "batch_stats/..."), `shape` in flax order, and `to_torch`, the torch
    dimension of each flax dimension."""

    name: str
    path: str
    shape: tuple[int, ...]
    to_torch: tuple[int, ...]


def model_leaves(model: torch.nn.Module, num_layers: int) -> list[Leaf]:
    """Every parameter and mapped BatchNorm statistic of an MPINetwork,
    under its flax path (models/convert.py's row map). num_batches_tracked
    has no flax counterpart and is left out (a replicated scalar)."""
    from mine_tpu_torch.models.convert import _mapping

    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    leaves = []
    for torch_key, flax_key, is_kernel in _mapping(num_layers):
        shape = tuple(tensors[torch_key].shape)
        if is_kernel:
            perm = KERNEL_TO_TORCH
            shape = tuple(shape[perm[i]] for i in range(4))
        else:
            perm = tuple(range(len(shape)))
        leaves.append(Leaf(torch_key, flax_key, shape, perm))
    return leaves


def _to_torch(pl: Placement, leaf: Leaf) -> Placement:
    return pl if pl.replicated else Placement(leaf.to_torch[pl.dim], pl.axes)


@dataclass(frozen=True)
class TorchLayout:
    """The table resolved for one model on one mesh, by torch parameter
    name and in torch dimensions: `params` (where each parameter lives
    between steps) and `updates` (where its Adam moments live, and the
    slice the sharded update steps)."""

    params: dict[str, Placement]
    updates: dict[str, Placement]
    shapes: dict[str, tuple[int, ...]]  # full torch shapes

    @property
    def sharded(self) -> bool:
        return any(not pl.replicated for pl in (*self.params.values(), *self.updates.values()))


def torch_layout(rules: Iterable[Rule], model: torch.nn.Module, num_layers: int,
                 mesh_shape: Mapping[str, int], min_size: int) -> TorchLayout:
    """The table for `model`: each leaf resolved under its flax path and
    flax-ordered shape, the dimension translated back to the torch tensor's.
    A BatchNorm statistic that a rule shards raises, as the JAX package
    cannot train with such a row either: its step fails when flax's
    BatchNorm adds a rank's (C/n,) running-statistic shard to the batch's
    (C,) statistic (ROADMAP queue 3)."""
    leaves = model_leaves(model, num_layers)
    params = {lf.path: lf.shape for lf in leaves if lf.path.startswith("params/")}
    stats = {lf.path: lf.shape for lf in leaves if lf.path.startswith("batch_stats/")}
    placed = state_placements(rules, params, stats, mesh_shape, min_size)
    sharded_stats = [p for p, pl in placed["batch_stats"].items() if not pl.replicated]
    if sharded_stats:
        raise NotImplementedError(
            f"a parallel.rules row shards BatchNorm statistics ({sharded_stats[:2]}...); the "
            "port keeps them replicated, as the JAX package must: its train step fails on "
            "such a row with `TypeError: add got incompatible shapes for broadcasting` (flax "
            "BatchNorm's running average adds the rank's statistic shard to the batch's "
            "full statistic)")
    by_path = {lf.path: lf for lf in leaves}
    return TorchLayout(
        {by_path[p].name: _to_torch(pl, by_path[p]) for p, pl in placed["params"].items()},
        {by_path[p].name: _to_torch(pl, by_path[p]) for p, pl in placed["opt_state"].items()},
        {name: tuple(t.shape) for name, t in model.named_parameters()},
    )


# -- measurement --------------------------------------------------------------------------


def placement_bytes(shapes: Mapping[str, tuple[tuple[int, ...], int]],
                    placements: Mapping[str, Placement], mesh_shape: Mapping[str, int]) -> int:
    """Analytic per-rank bytes of {name: (shape, itemsize)} under
    {name: Placement}: each leaf's bytes over its shard count."""
    total = 0
    for name, (shape, itemsize) in shapes.items():
        nbytes = math.prod(shape or (1,)) * itemsize
        total += nbytes // placements[name].shards(mesh_shape)
    return total


def per_device_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes resident on this rank: each tensor's own storage as it stands
    (a shard counts its shard)."""
    return sum(t.numel() * t.element_size() for t in tensors)
