"""The train and eval steps over the (data, plane) mesh (counterpart of
mine_tpu/parallel/data_parallel.py).

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

The partition-rule table (parallel/rules.py), the fsdp axis and ZeRO-1 wait
for the port to shard state; config.unsupported_training_options refuses
them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mine_tpu_torch.ops.mpi_render import Compositor, compositor_from_config
from mine_tpu_torch.parallel.comm import broadcast_
from mine_tpu_torch.parallel.mesh import (
    DATA_AXIS,
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
    if mesh.shape[FSDP_AXIS] > 1:
        raise NotImplementedError("the fsdp axis waits for ROADMAP queue 1 item 6")
    stage = mesh.world_group if data_replica_count(mesh) * mesh.shape[PLANE_AXIS] > 1 else None
    return {"batch_group": mesh.batch_group, "stage_group": stage}


def _check_planes(cfg, n_plane: int) -> None:
    """The JAX package's _plane_args checks."""
    if cfg.mpi.num_bins_coarse % n_plane:
        raise ValueError(
            f"mpi.num_bins_coarse={cfg.mpi.num_bins_coarse} must divide by "
            f"the plane-axis size {n_plane}"
        )
    if cfg.mpi.num_bins_fine > 0:
        raise NotImplementedError("mpi.num_bins_fine > 0 waits for ROADMAP queue 1 item 5 "
                                  "(coarse-to-fine), under plane sharding too")


@dataclass(frozen=True)
class ParallelPlan:
    """Where one rank's step communicates. `batch_group`: the batch replicas
    (the loss mean, the logged values, the eval sums); `world_group`: every
    rank (the gradient sum, the finite verdict); `plane`: the plane axis.
    `n_batch`/`batch_index` and `plane.size`/`plane.index` place the rank's
    rows and planes in the global draws."""

    mesh: Mesh
    compositor: Compositor
    plane: PlaneAxis
    n_batch: int
    batch_index: int

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
                        data_replica_count(mesh), mesh.coordinate(DATA_AXIS))


def broadcast_state(model: torch.nn.Module, mesh: Mesh) -> None:
    """Rank 0's parameters and buffers to every rank (the DDP initial
    broadcast), so that the replicas begin equal."""
    broadcast_([*model.parameters(), *model.buffers()], mesh.world_group, src=0)
