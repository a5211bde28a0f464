"""Dataset registry (counterpart of mine_tpu/data/registry.py): `data.name`
-> the dataset for (cfg, split, batch_size). Only the synthetic scene is
ported; the real loaders are ROADMAP queue 1 item 4."""

from __future__ import annotations

from typing import Any

from mine_tpu_torch.config import Config


def build_dataset(cfg: Config, split: str, batch_size: int) -> Any:
    """The dataset `cfg.data.name` names, for `split` ("train" or "val")."""
    if cfg.data.name != "synthetic":
        raise NotImplementedError(
            f"data.name={cfg.data.name!r}: the port has only the 'synthetic' "
            "dataset; the real loaders are ROADMAP queue 1 item 4"
        )
    from mine_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(
        cfg.data.img_h, cfg.data.img_w, batch_size,
        steps_per_epoch=12 if split == "train" else 2,
        n_points=cfg.data.visible_point_count,
        seed=cfg.training.seed + (0 if split == "train" else 10_000),
    )
