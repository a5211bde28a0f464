"""The configuration the port reads: the `data`, `model` and `mpi` groups of
mine_tpu/config.py's Config, with the same dot-keys and defaults.

Config files are the JAX package's flat dot-key YAML (mine_tpu/configs/*.yaml
are read as data files). Keys of the other groups (lr, loss, training, ...)
belong to parts not ported yet and are skipped on load; an unknown key inside
these three groups is an error, as in the JAX loader.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

import yaml


@dataclass(frozen=True)
class DataConfig:
    name: str = "llff"
    img_h: int = 384
    img_w: int = 512
    img_pre_downsample_ratio: float = 7.875
    per_gpu_batch_size: int = 4
    num_tgt_views: int = 1
    training_set_path: str = ""
    visible_point_count: int = 256
    num_workers: int = 4
    loader_retries: int = 0


@dataclass(frozen=True)
class ModelConfig:
    num_layers: int = 50
    pos_encoding_multires: int = 10
    imagenet_pretrained: bool = True
    pretrained_backbone_path: str = ""
    # "bfloat16" runs encoder and decoder under autocast; "float32" without
    dtype: str = "bfloat16"
    remat_decoder: bool = False
    decoder_width_multiple: int = 1


@dataclass(frozen=True)
class MPIConfig:
    disparity_start: float = 1.0
    disparity_end: float = 0.001
    num_bins_coarse: int = 32
    num_bins_fine: int = 0
    is_bg_depth_inf: bool = False
    valid_mask_threshold: float = 2.0
    fix_disparity: bool = False
    use_alpha: bool = False
    sigma_dropout_rate: float = 0.0
    disparity_list: tuple[float, ...] = ()
    # "dense" warps every plane, then composites; "streaming" runs the fused
    # warp-composite kernel
    compositor: str = "dense"
    stream_chunk_planes: int = 4


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mpi: MPIConfig = field(default_factory=MPIConfig)

    def replace(self, **dot_key_values: Any) -> "Config":
        """Functional update by dot-keys: cfg.replace(**{"mpi.num_bins_coarse": 8})."""
        flat = to_flat_dict(self)
        for k, v in dot_key_values.items():
            if k not in flat:
                raise KeyError(f"unknown config key: {k}")
            flat[k] = v
        return from_flat_dict(flat)


_GROUPS = {f.name: f.default_factory for f in dataclasses.fields(Config)}

# keys the JAX loader tolerates in archived params.yaml files
_RETIRED_KEYS = frozenset({
    "data.val_set_path",
    "data.rotation_pi_ratio",
    "data.is_exclude_views",
    "model.backbone_normalization",
    "model.decoder_normalization",
})


def _coerce(value: Any, target: Any, key: str) -> Any:
    """YAML/JSON scalars -> the field's type (mine_tpu/config.py _coerce)."""
    if target in (float, "float") and isinstance(value, (int, float)) \
            and not isinstance(value, bool):
        return float(value)
    if target in (int, "int"):
        if isinstance(value, bool):
            raise TypeError(f"{key}: expected int, got bool")
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, int):
            return value
        raise TypeError(f"{key}: expected int, got {value!r}")
    if target in (bool, "bool"):
        if isinstance(value, bool):
            return value
        raise TypeError(f"{key}: expected bool, got {value!r}")
    if target in (str, "str"):
        return "" if value is None else str(value)
    if isinstance(target, str) and target.startswith("tuple"):
        if isinstance(value, str):
            value = [v for v in value.replace(" ", "").split(",") if v]
        return tuple(float(v) for v in value)
    return value


def to_flat_dict(cfg: Config) -> dict[str, Any]:
    return {
        f"{gname}.{f.name}": getattr(getattr(cfg, gname), f.name)
        for gname in _GROUPS
        for f in dataclasses.fields(getattr(cfg, gname))
    }


def from_flat_dict(flat: dict[str, Any]) -> Config:
    grouped: dict[str, dict[str, Any]] = {g: {} for g in _GROUPS}
    for key, value in flat.items():
        gname, _, fname = key.partition(".")
        if gname not in _GROUPS:
            raise KeyError(f"unknown config group: {key!r}")
        fields = {f.name: f for f in dataclasses.fields(_GROUPS[gname])}
        if fname not in fields:
            raise KeyError(f"unknown config key: {key!r}")
        grouped[gname][fname] = _coerce(value, fields[fname].type, key)
    return Config(**{g: _GROUPS[g](**kv) for g, kv in grouped.items()})


def load_config(*yaml_paths: str,
                overrides: dict[str, Any] | str | None = None) -> Config:
    """Layered load of flat dot-key YAML files, later layers winning;
    `overrides` (dict or JSON string) last."""
    flat = to_flat_dict(Config())
    layers: list[dict[str, Any]] = []
    for path in yaml_paths:
        with open(path) as fh:
            layers.append(yaml.safe_load(fh) or {})
    if overrides:
        layers.append(json.loads(overrides) if isinstance(overrides, str) else overrides)
    for layer in layers:
        for key, value in layer.items():
            if key in _RETIRED_KEYS or key.partition(".")[0] not in _GROUPS:
                continue
            if key not in flat:
                raise KeyError(f"unknown config key: {key!r}")
            flat[key] = value
    return from_flat_dict(flat)
