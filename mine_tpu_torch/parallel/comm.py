"""The collectives of the parallel path, with the backward each needs
(counterpart of the lax.psum / all_gather / ppermute transposes that JAX
derives inside shard_map).

Only `all_reduce`, list-form `all_gather` and `broadcast` are called, so
gloo (the CPU transport, and the shared-card runs) takes every one of them
as NCCL does. A group of None (an axis of size 1) makes each an identity.

Three backward rules, and why each:
  * `all_reduce_replicated`: a sum whose result every rank of the group
    consumes identically (a composite, a loss averaged over the batch
    replicas). Each rank back-propagates its own copy of the downstream
    graph, so the local cotangent is already the whole of the summand's
    cotangent: the backward is the identity. torch.distributed.nn's
    all_reduce would all-reduce those n identical cotangents and make every
    gradient through the sum n times too large
    (mine_tpu/parallel/plane_sharding.py _psum_replicated).
  * `all_reduce_sum`: a sum whose result each rank uses on different data
    (BatchNorm's statistics, each rank normalising its own rows). The
    cotangents differ per rank and all of them reach every summand: the
    backward all-reduces them.
  * `all_gather`: a true data dependency across ranks (the exclusive
    transmittance prefix, the halo plane). Rank j's slot receives the sum
    over ranks of their cotangents for it: an all_reduce of the stacked
    cotangent, then the rank's own slot (a reduce-scatter out of all_reduce).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)[dist.get_rank(ctx.group)], None


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the backward passes the local cotangent."""
    return x if group is None else _AllReduceReplicated.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the backward sums the cotangents over it."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(...) -> (n, ...), slot i from the group's rank i; the backward
    reduce-scatters the cotangents."""
    return x[None] if group is None else _AllGather.apply(x, group)


@torch.no_grad()
def all_reduce_(tensors: list[torch.Tensor], group, average: bool = False) -> None:
    """In-place sum (or mean) of a list of tensors over the group, one
    collective per dtype through a flat buffer: the gradient sync and the
    logged values."""
    if group is None or not tensors:
        return
    n = dist.get_world_size(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if average:
            flat /= n
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def broadcast_(tensors: list[torch.Tensor], group=None, src: int = 0) -> None:
    """In-place broadcast of a list of tensors from the group's rank `src`
    (a global rank), one collective per dtype."""
    if group is not None:
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for same in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=src, group=group)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))
