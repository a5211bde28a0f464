"""Dataset registry (the port's own copy of mine_tpu/data/registry.py): ONE
enumerable name -> builder table.

Every consumer (the train CLI, the evaluate CLI, the conformance runner in
data/conformance/) enumerates THIS table, so "which datasets exist" has one
answer and an unknown name errors with the registered list. Builders are
lazy (imports inside), so `registered_names()` costs nothing and a CLI only
pays for the loader it uses. Builder signature:

    builder(cfg, split, global_batch, host_slice) -> dataset

where the dataset speaks the loader protocol (`__len__`, `epoch(n)`,
`num_eval_examples`) and `host_slice=(start, count)` asks for only those
rows of each global batch (every registered loader honours it, the
conformance contract's `host_slice` flag).
"""

from __future__ import annotations

from typing import Any, Callable

from mine_tpu_torch.config import Config

Builder = Callable[[Config, str, int, "tuple[int, int] | None"], Any]


class UnknownDatasetError(KeyError):
    """`data.name` names no registered dataset; the message lists what IS
    registered and points at the conformance runner."""

    def __init__(self, name: str):
        super().__init__(
            f"dataset {name!r} is not registered; registered datasets: "
            f"{', '.join(registered_names())} (mine_tpu_torch/data/registry.py; "
            "mine_tpu_torch.data.conformance.check_loader checks a shipped "
            "config end to end against its fixture)"
        )


_REGISTRY: dict[str, Builder] = {}


def register(name: str) -> Callable[[Builder], Builder]:
    def deco(fn: Builder) -> Builder:
        _REGISTRY[name] = fn
        return fn
    return deco


def registered_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def build_dataset(
    cfg: Config,
    split: str,
    global_batch: int,
    host_slice: tuple[int, int] | None = None,
) -> Any:
    """The dataset `cfg.data.name` names, for `split` ("train" or "val")."""
    try:
        builder = _REGISTRY[cfg.data.name]
    except KeyError:
        raise UnknownDatasetError(cfg.data.name) from None
    return builder(cfg, split, global_batch, host_slice)


# -- the registered families -------------------------------------------------


@register("synthetic")
def _synthetic(cfg, split, global_batch, host_slice):
    # data.num_tgt_views is a no-op here by design: every synthetic batch
    # slot is a fresh procedural scene
    from mine_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(
        cfg.data.img_h, cfg.data.img_w, global_batch,
        steps_per_epoch=12 if split == "train" else 2,
        n_points=cfg.data.visible_point_count,
        seed=cfg.training.seed + (0 if split == "train" else 10_000),
        host_slice=host_slice,
    )


@register("llff")
@register("nocs_llff")
def _llff(cfg, split, global_batch, host_slice):
    from mine_tpu_torch.data.llff import LLFFDataset

    return LLFFDataset(cfg, split, global_batch, host_slice=host_slice)


@register("objectron")
def _objectron(cfg, split, global_batch, host_slice):
    from mine_tpu_torch.data.objectron import ObjectronDataset

    return ObjectronDataset(cfg, split, global_batch, host_slice=host_slice)


@register("realestate10k")
def _realestate(cfg, split, global_batch, host_slice):
    from mine_tpu_torch.data.realestate import RealEstateDataset

    return RealEstateDataset(cfg, split, global_batch, host_slice=host_slice)


@register("kitti_raw")
def _kitti(cfg, split, global_batch, host_slice):
    from mine_tpu_torch.data.kitti import KittiRawDataset

    return KittiRawDataset(cfg, split, global_batch, host_slice=host_slice)


@register("dtu")
def _dtu(cfg, split, global_batch, host_slice):
    from mine_tpu_torch.data.dtu import DTUDataset

    return DTUDataset(cfg, split, global_batch, host_slice=host_slice)


@register("flowers")
def _flowers(cfg, split, global_batch, host_slice):
    from mine_tpu_torch.data.flowers import FlowersDataset

    return FlowersDataset(cfg, split, global_batch, host_slice=host_slice)
