"""The train and eval steps over the (data, fsdp, plane) mesh (counterpart
of mine_tpu/parallel/data_parallel.py).

The JAX package shard_maps one step over the mesh. Here every rank runs
training/step.py's step on its rows and its planes, with a `ParallelPlan`
that says where the collectives go (training/step.py):
  * the scalar loss is averaged over the batch replicas before the
    backward, whose all-reduce passes the local cotangent, and the
    parameter gradients are then summed over every rank: over the plane
    ranks because each holds its planes' share of the full-S gradient, over
    the batch replicas because each back-propagated 1/n of the mean;
  * BatchNorm statistics sync over the batch replicas (the encoder and the
    decoder extension) and over batch x plane (the decoder up-stages,
    whose batch is B*S): `model_groups`;
  * the random draws (disparities, sigma dropout masks) are drawn whole,
    (B_global, S), from the generator every rank shares, and each rank takes
    its rows and planes, so a sharded run draws what a one-process run
    draws;
  * the sentinel's finite flag is reduced into one verdict for the mesh;
  * the eval step's weighted mean is exact: its sums and counts are reduced.

The batch replicas are data x fsdp. When the fsdp axis is wider than 1 or
`parallel.zero1` is on over more than one batch replica, the partition-rule
table (parallel/rules.py) lays out the training state (`_state_layout`):
between steps each rank holds its FSDP shard of every fsdp-sharded kernel
and its ZeRO-1 shard of the Adam moments. The train step gathers the
parameters once (`gather_params`, scope "fsdp_gather"), reduces the full
gradients as before, steps Adam on the rank's moment shard and gathers each
update back to its parameter's layout (`sharded_optimizer_step`, scope
"zero1_gather"); the eval step gathers too. `distribute_state` is the one
placement entry point (first placement, warm start, restore): the full
state, broadcast from rank 0, sliced into the layout. Checkpoints are
gathered on save (`gathered_state`), so that any layout restores them.

The JAX package refuses sharded layouts across processes, since a process
cannot gather shards it cannot address; here every rank is one process
with one device, so ranks play the part of the JAX package's devices and
the gathers run through the process groups.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from mine_tpu_torch.obs.attrib import scope
from mine_tpu_torch.ops.mpi_render import Compositor, compositor_from_config
from mine_tpu_torch.parallel import rules as rules_mod
from mine_tpu_torch.parallel.comm import broadcast_, gather_dim
from mine_tpu_torch.parallel.mesh import (
    FSDP_AXIS,
    PLANE_AXIS,
    Mesh,
    data_replica_count,
)
from mine_tpu_torch.parallel.plane_sharding import PlaneAxis, plane_compositor


def model_groups(mesh: Mesh) -> dict:
    """build_model's BatchNorm groups on this mesh (the JAX package's
    model_axes): the batch replicas, and batch x plane for the decoder's
    up-stages."""
    stage = mesh.world_group if data_replica_count(mesh) * mesh.shape[PLANE_AXIS] > 1 else None
    return {"batch_group": mesh.batch_group, "stage_group": stage}


def _check_planes(cfg, n_plane: int) -> None:
    """The JAX package's _plane_args checks: the merged coarse + fine list
    re-shards across the same axis, so both counts must divide it."""
    if cfg.mpi.num_bins_coarse % n_plane:
        raise ValueError(
            f"mpi.num_bins_coarse={cfg.mpi.num_bins_coarse} must divide by "
            f"the plane-axis size {n_plane}"
        )
    if cfg.mpi.num_bins_fine % n_plane:
        raise ValueError(
            f"mpi.num_bins_fine={cfg.mpi.num_bins_fine} must divide by "
            f"the plane-axis size {n_plane}"
        )


@dataclass(frozen=True)
class ParallelPlan:
    """Where one rank's step communicates. `batch_group`: the batch replicas
    (the loss mean, the logged values, the eval sums); `world_group`: every
    rank (the gradient sum, the finite verdict); `plane`: the plane axis.
    `n_batch`/`batch_index` and `plane.size`/`plane.index` place the rank's
    rows and planes in the global draws. `layout`: the sharded state
    layout (None: replicated)."""

    mesh: Mesh
    compositor: Compositor
    plane: PlaneAxis
    n_batch: int
    batch_index: int
    layout: rules_mod.TorchLayout | None = None

    @property
    def batch_group(self):
        return self.mesh.batch_group

    @property
    def world_group(self):
        return self.mesh.world_group

    def local(self, draw: torch.Tensor) -> torch.Tensor:
        """This rank's rows and planes of a global (..., B_global, S) draw."""
        b = draw.shape[-2] // self.n_batch
        s = draw.shape[-1] // self.plane.size
        return draw[..., self.batch_index * b:(self.batch_index + 1) * b,
                    self.plane.index * s:(self.plane.index + 1) * s]


def make_plan(cfg, mesh: Mesh) -> ParallelPlan:
    """The plan of this rank on `mesh`, validated as the JAX package's
    _plane_args: cfg.mpi.compositor selects dense or streaming, plane-sharded
    when the plane axis is wider than 1."""
    n_plane = mesh.shape[PLANE_AXIS]
    compositor = compositor_from_config(cfg)  # unknown values fail here
    if n_plane > 1:
        _check_planes(cfg, n_plane)
        compositor = plane_compositor(PlaneAxis.of(mesh.group(PLANE_AXIS)),
                                      streaming=cfg.mpi.compositor == "streaming",
                                      chunk_planes=cfg.mpi.stream_chunk_planes)
    return ParallelPlan(mesh, compositor, PlaneAxis.of(mesh.group(PLANE_AXIS)),
                        data_replica_count(mesh), mesh.batch_index)


def with_layout(plan: ParallelPlan, cfg, model: torch.nn.Module) -> ParallelPlan:
    """The plan with the model's state layout, when one shards anything."""
    return replace(plan, layout=_state_layout(cfg, plan.mesh, model))


def replicate_state(model: torch.nn.Module, mesh: Mesh) -> None:
    """Rank 0's parameters and buffers to every rank (the DDP initial
    broadcast), so that the replicas begin equal."""
    broadcast_([*model.parameters(), *model.buffers()], mesh.world_group, src=0)


# -- sharded state ------------------------------------------------------------------------


def zero1_enabled(cfg, mesh: Mesh) -> bool:
    """Whether the ZeRO-1 moment rows shard anything: the knob is on and
    there is more than one batch replica."""
    return bool(cfg.parallel.zero1) and data_replica_count(mesh) > 1


def fsdp_enabled(mesh: Mesh) -> bool:
    """FSDP is the fsdp axis being wider than 1 (mesh.fsdp_parallel)."""
    return mesh.shape[FSDP_AXIS] > 1


def sharding_active(cfg, mesh: Mesh) -> bool:
    """Whether any state leaf leaves full replication under the table."""
    return fsdp_enabled(mesh) or zero1_enabled(cfg, mesh)


def _state_layout(cfg, mesh: Mesh, model: torch.nn.Module) -> rules_mod.TorchLayout | None:
    """The table resolved for `model` on `mesh` (parallel/rules.py), or
    None when nothing shards."""
    if not sharding_active(cfg, mesh):
        return None
    layout = rules_mod.torch_layout(rules_mod.partition_rules(cfg), model,
                                    cfg.model.num_layers, mesh.shape,
                                    cfg.parallel.zero1_min_size)
    return layout if layout.sharded else None


def _chunk_index(mesh: Mesh, axes: tuple[str, ...]) -> int:
    """Row-major index over `axes` (major first): the chunk a placement
    over them assigns this rank."""
    idx = 0
    for ax in axes:
        idx = idx * mesh.shape[ax] + mesh.coordinate(ax)
    return idx


def local_shard(t: torch.Tensor, pl: rules_mod.Placement, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk of a full tensor under `pl` (a view)."""
    if pl.replicated:
        return t
    chunk = t.shape[pl.dim] // pl.shards(mesh.shape)
    return t.narrow(pl.dim, _chunk_index(mesh, pl.axes) * chunk, chunk)


def gather_placed(t: torch.Tensor, pl: rules_mod.Placement, mesh: Mesh,
                  axes: tuple[str, ...] | None = None) -> torch.Tensor:
    """Gather a shard over `axes` (default: all of pl's), minor axis first,
    so that the chunks reassemble in placement order."""
    for ax in reversed(pl.axes if axes is None else axes):
        t = gather_dim(t, mesh.group(ax), pl.dim)
    return t


@torch.no_grad()
def gather_params(model: torch.nn.Module, layout: rules_mod.TorchLayout, mesh: Mesh) -> None:
    """The FSDP gather: every sharded parameter to its full shape, in
    place (the only time the full parameters exist on a rank)."""
    with scope("fsdp_gather"):
        for name, p in model.named_parameters():
            pl = layout.params[name]
            if not pl.replicated:
                p.data = gather_placed(p.data, pl, mesh)


@torch.no_grad()
def release_params(model: torch.nn.Module, layout: rules_mod.TorchLayout, mesh: Mesh) -> None:
    """Full parameters back to this rank's shards (no collective); a
    parameter that is not at its full shape is left as it is."""
    for name, p in model.named_parameters():
        pl = layout.params[name]
        if not pl.replicated and tuple(p.shape) == layout.shapes[name]:
            p.data = local_shard(p.data, pl, mesh).clone()
            p.grad = None


@torch.no_grad()
def sharded_optimizer_step(optimizer: torch.optim.Optimizer, scheduler,
                           model: torch.nn.Module, layout: rules_mod.TorchLayout,
                           mesh: Mesh) -> None:
    """Adam on this rank's moment shard: every parameter whose moments
    shard is sliced (its full value and its reduced gradient) to that shard,
    the optimizer and the schedule step on the shards, and each new shard is
    gathered back to its parameter's layout over the moment axes the
    parameter does not shard on (scope "zero1_gather"). Elementwise per
    leaf, so the result equals the unsharded step's."""
    named = list(model.named_parameters())
    for name, p in named:
        upl = layout.updates[name]
        if not upl.replicated:
            grad = p.grad
            p.data = local_shard(p.data, upl, mesh).clone()
            p.grad = local_shard(grad, upl, mesh).clone()
    optimizer.step()
    scheduler.step()
    with scope("zero1_gather"):
        for name, p in named:
            upl, ppl = layout.updates[name], layout.params[name]
            if upl.replicated:
                continue
            p.grad = None
            extra = upl.axes if ppl.replicated else upl.axes[len(ppl.axes):]
            p.data = gather_placed(p.data, upl, mesh, extra)


MOMENTS = ("exp_avg", "exp_avg_sq")


def optimizer_names(optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> list[str]:
    """The parameter name of each optimizer state index."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def resident_tensors(model: torch.nn.Module, optimizer: torch.optim.Optimizer | None):
    """The parameters and Adam moments as this rank holds them: what
    rules.per_device_bytes counts."""
    out = [p.data for p in model.parameters()]
    if optimizer is not None:
        for state in optimizer.state.values():
            out.extend(state[m] for m in MOMENTS if m in state)
    return out


def state_bytes(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                layout: rules_mod.TorchLayout, mesh: Mesh) -> dict[str, int]:
    """This rank's parameter and Adam-moment bytes: resident (as it holds
    them), by the table (placement_bytes of the parameters and of both
    moments) and replicated (the same state unsharded)."""
    sizes = {n: (layout.shapes[n], p.element_size()) for n, p in model.named_parameters()}
    repl = {n: rules_mod.REPLICATED for n in sizes}
    return {"resident": rules_mod.per_device_bytes(resident_tensors(model, optimizer)),
            "table": rules_mod.placement_bytes(sizes, layout.params, mesh.shape)
            + 2 * rules_mod.placement_bytes(sizes, layout.updates, mesh.shape),
            "replicated": 3 * rules_mod.placement_bytes(sizes, repl, mesh.shape)}


@torch.no_grad()
def gathered_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer | None,
                   layout: rules_mod.TorchLayout | None, mesh: Mesh) -> tuple[dict, dict | None]:
    """(model state dict, optimizer state dict) at full shape on every
    rank: parameters and moments gathered from their shards (a collective:
    every rank calls it). With no layout, the state dicts as they are."""
    model_sd = model.state_dict()
    opt_sd = optimizer.state_dict() if optimizer is not None else None
    if layout is None:
        return model_sd, opt_sd
    model_sd = dict(model_sd)
    for name, p in model.named_parameters():
        pl = layout.params[name]
        if not pl.replicated:
            model_sd[name] = gather_placed(p.data, pl, mesh)
    if opt_sd is not None:
        state = {}
        for idx, name in enumerate(optimizer_names(optimizer, model)):
            entry = dict(opt_sd["state"].get(idx, {}))
            upl = layout.updates[name]
            for m in MOMENTS:
                if m in entry and not upl.replicated:
                    entry[m] = gather_placed(entry[m], upl, mesh)
            if entry:
                state[idx] = entry
        opt_sd = dict(opt_sd, state=state)
    return model_sd, opt_sd


@torch.no_grad()
def distribute_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer | None,
                     mesh: Mesh, layout: rules_mod.TorchLayout | None) -> None:
    """The one placement entry point (first placement, warm start,
    restore): the model at full shape (and the optimizer's moments, when it
    holds any, at full shape) -> rank 0's values on every rank, sliced into
    `layout` (replicated when None)."""
    replicate_state(model, mesh)
    if layout is None:
        return
    for name, p in model.named_parameters():
        pl = layout.params[name]
        if not pl.replicated:
            p.data = local_shard(p.data, pl, mesh).clone()
    if optimizer is None:
        return
    for name, p in zip(optimizer_names(optimizer, model),
                       (p for g in optimizer.param_groups for p in g["params"])):
        upl, state = layout.updates[name], optimizer.state.get(p)
        if state is None or upl.replicated:
            continue
        for m in MOMENTS:
            if m in state:
                state[m] = local_shard(state[m], upl, mesh).clone()


@torch.no_grad()
def load_full_params(model: torch.nn.Module, model_sd: dict) -> None:
    """Give every parameter its full shape from a (gathered) state dict,
    so that load_state_dict and distribute_state can follow."""
    for name, p in model.named_parameters():
        p.data = model_sd[name].to(device=p.device, dtype=p.dtype).clone()
