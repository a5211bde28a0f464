"""The (data, fsdp, plane) process mesh and multi-process bootstrap
(counterpart of mine_tpu/parallel/mesh.py).

One process drives one device, as torchrun launches it. The mesh names
three axes, row-major over the ranks (data outermost, plane innermost):

  data  - batch sharding: each data coordinate owns a contiguous block of
          the global batch rows (DDP data parallel);
  fsdp  - parameter sharding; refused until the port shards state
          (config.unsupported_training_options), so always 1 here;
  plane - MPI plane (S) sharding: each plane coordinate runs the decoder
          and the renderer on its contiguous block of planes.

`init_distributed` is opt-in, as the JAX package's init_multihost: it runs
only when a coordinator is given or the environment names more than one
process (torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
MASTER_PORT). Its backend is explicit: NCCL for a CUDA device, gloo on the
CPU or when asked for (gloo also carries CUDA tensors, which is how two
ranks share one card). A rendezvous that does not complete within its
deadline raises MultihostInitTimeout instead of hanging.

A one-process run without a process group gets a 1x1x1 mesh and no
collectives; a job of one rank launched through torchrun with a backend has
a mesh whose default group carries the gradient sum (a one-rank NCCL run
exercises the backend).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PLANE_AXIS = "plane"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, PLANE_AXIS)
# the batch-replica product: batches shard their rows over both
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


class MultihostInitTimeout(RuntimeError):
    """torch.distributed.init_process_group did not complete within the
    bring-up deadline: the named replacement for the indefinite hang a
    missing peer otherwise produces."""

    def __init__(self, timeout_s: float, coordinator: str | None):
        super().__init__(
            f"multi-host bring-up did not complete within {timeout_s:.0f}s: "
            "torch.distributed.init_process_group() is still waiting for peers. "
            "Check that every host of the job launched the same command, that "
            f"the coordinator {coordinator or '(MASTER_ADDR:MASTER_PORT)'} is "
            "reachable (firewall / DNS), and that WORLD_SIZE or --coordinator "
            "was not set on a single-host run. Extend the deadline with "
            "MINE_TPU_MULTIHOST_TIMEOUT_S."
        )
        self.timeout_s = timeout_s
        self.coordinator = coordinator


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def local_rank() -> int:
    """The rank's index on its host (torchrun's LOCAL_RANK), else 0."""
    return _env_int("LOCAL_RANK") or 0


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """The device of this rank: the one asked for, else cuda:{LOCAL_RANK}
    (no modulo mapping: a LOCAL_RANK past the card count fails at use)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", local_rank())


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
    timeout_s: float | None = None,
    initialize_fn=None,
) -> bool:
    """Join the job's default process group; True when one exists after
    the call (this call's or an earlier one), False on a one-process run.

    Opt-in: runs only with a `coordinator` ("host:port"), when
    num_processes (else $WORLD_SIZE) is above 1, or when a `backend` is
    asked for under a launcher ($WORLD_SIZE set: a one-rank job then runs
    its collectives through that backend). The rank is process_id,
    else $RANK. The rendezvous runs on a worker thread joined for
    `timeout_s` (default $MINE_TPU_MULTIHOST_TIMEOUT_S, else 300); on
    expiry MultihostInitTimeout. `initialize_fn` replaces
    torch.distributed.init_process_group (tests inject a fake)."""
    if dist.is_available() and dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    asked = backend is not None and num_processes is not None
    if coordinator is None and (num_processes is None or num_processes <= 1) and not asked:
        return False
    if process_id is None:
        process_id = _env_int("RANK")
    if timeout_s is None:
        timeout_s = float(os.environ.get("MINE_TPU_MULTIHOST_TIMEOUT_S", 300))
    dev = rank_device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        # before the rendezvous: NCCL binds its communicator to the current
        # device, and the device mesh keeps a device that is already set
        torch.cuda.set_device(dev)
    kwargs: dict[str, Any] = {"backend": backend,
                              "timeout": timedelta(seconds=max(timeout_s, 1.0))}
    kwargs["init_method"] = f"tcp://{coordinator}" if coordinator else "env://"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    fn = initialize_fn or dist.init_process_group
    outcome: list[BaseException | None] = []

    def bring_up():
        try:
            fn(**kwargs)
            outcome.append(None)
        except BaseException as exc:  # noqa: BLE001 - re-raised on the caller
            outcome.append(exc)

    # daemon: a stuck rendezvous cannot be cancelled, but it must not keep
    # the process alive once the caller gives up on it
    worker = threading.Thread(target=bring_up, name="mine-multihost-init", daemon=True)
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        raise MultihostInitTimeout(timeout_s, coordinator)
    if outcome and outcome[0] is not None:
        raise outcome[0]
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclass(frozen=True)
class Mesh:
    """The named mesh of the job's ranks. `device_mesh` is torch's
    DeviceMesh (None on one process); the groups of an axis of size 1 are
    None, which every collective of parallel/comm.py takes as an identity."""

    shape: dict
    rank: int
    device_mesh: Any = None

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis` (row-major, plane innermost)."""
        stride = 1
        for name in reversed(AXIS_NAMES):
            if name == axis:
                return (self.rank // stride) % self.shape[name]
            stride *= self.shape[name]
        raise KeyError(axis)

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        if self.shape[axis] <= 1:
            return None
        return self.device_mesh.get_group(mesh_dim=axis)

    @property
    def batch_group(self):
        """The ranks one logical batch spans (data x fsdp; fsdp is 1)."""
        return self.group(DATA_AXIS)

    @property
    def world_group(self):
        """Every rank: the parameter-gradient sum, the decoder's
        batch x plane BatchNorm and the mesh-wide finite verdict. The
        default group whenever one exists (a one-rank job's collectives
        still run through its backend); None without a process group."""
        return None if self.device_mesh is None else dist.group.WORLD


def make_mesh(data_parallel: int = -1, plane_parallel: int = 1,
              fsdp_parallel: int = 1) -> Mesh:
    """Build the (data, fsdp, plane) mesh over the job's ranks (one device
    each). data_parallel=-1 takes every rank not claimed by fsdp_parallel x
    plane_parallel. The checks and messages are the JAX package's."""
    n = process_count()
    for name, size in (("plane_parallel", plane_parallel),
                       ("fsdp_parallel", fsdp_parallel)):
        if size < 1 or n % size:
            raise ValueError(f"{name}={size} must divide {n} devices")
    claimed = plane_parallel * fsdp_parallel
    if n % claimed:
        raise ValueError(
            f"fsdp_parallel={fsdp_parallel} x plane_parallel="
            f"{plane_parallel} must divide {n} devices"
        )
    if data_parallel == -1:
        data_parallel = n // claimed
    if data_parallel * claimed != n:
        raise ValueError(
            f"mesh {data_parallel}x{fsdp_parallel}x{plane_parallel} != {n} "
            "available devices"
        )
    shape = {DATA_AXIS: data_parallel, FSDP_AXIS: fsdp_parallel, PLANE_AXIS: plane_parallel}
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape, 0)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, (data_parallel, fsdp_parallel, plane_parallel),
                                   mesh_dim_names=AXIS_NAMES)
    return Mesh(shape, dist.get_rank(), device_mesh)


def data_replica_count(mesh: Mesh) -> int:
    """How many batch shards the mesh holds: the data x fsdp product."""
    return mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]


def mesh_shape_str(mesh: Mesh) -> str:
    """Canonical 'DxFxP' label."""
    return "x".join(str(mesh.shape[a]) for a in AXIS_NAMES)


def host_batch_slice(mesh: Mesh, global_rows: int) -> tuple[int, int]:
    """(start, count): the contiguous rows of the global batch this rank
    owns: block `data coordinate` of `data_replica_count` equal blocks. The
    plane ranks of one data group own the same rows. (0, global_rows) on a
    one-process mesh."""
    n = data_replica_count(mesh)
    if n == 1:
        return 0, global_rows
    count = global_rows // n
    if count * n != global_rows:
        raise ValueError(
            f"global batch {global_rows} does not split evenly over "
            f"{n} processes (this host owns {count} rows)"
        )
    replica = mesh.coordinate(DATA_AXIS) * mesh.shape[FSDP_AXIS] + mesh.coordinate(FSDP_AXIS)
    return replica * count, count


def shard_batch(mesh: Mesh, batch: dict, device: str | torch.device,
                global_rows: int | None = None) -> dict[str, torch.Tensor]:
    """This rank's rows of a host batch, as fp32 tensors on `device`. The
    input is either the rank's own slice already (the per-host loader
    path), or, with `global_rows`, the whole global batch, sliced here."""
    if global_rows is None:
        count = None
    else:
        start, count = host_batch_slice(mesh, global_rows)
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        if count is not None and t.shape[0] == global_rows:
            t = t[start:start + count]
        elif count is not None and t.shape[0] != count:
            raise ValueError(f"host batch has {t.shape[0]} rows; this host owns {count} "
                             f"of the global {global_rows} (host_batch_slice)")
        t = t.to(torch.float32)
        out[key] = t.to(device, non_blocking=t.is_pinned())
    return out
