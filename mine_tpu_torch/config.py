"""The configuration the port reads: the `data`, `lr`, `model`, `mpi`,
`loss`, `training`, `mesh`, `parallel`, `resilience`, `obs` and `serving`
groups of mine_tpu/config.py's Config, with the same dot-keys and defaults.

Config files are the JAX package's flat dot-key YAML (mine_tpu/configs/*.yaml
are read as data files). Every group is ported whole; an unknown key is an
error, as in the JAX loader. Keys the port reads but does not honour yet
raise where they would take effect (`unsupported_training_options`: the
fsdp axis, ZeRO-1 and the partition-rule rows; coarse-to-fine; warm starts
that are not a converted .npz; and the serving engine's coarse-to-fine
check). `save_config` writes the flat dot-key YAML the loader reads (the
workspace's params.yaml), which the JAX loader reads too.
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
class LRConfig:
    backbone_lr: float = 1.0e-3
    decoder_lr: float = 1.0e-3
    decay_gamma: float = 0.1
    decay_steps: tuple[int, ...] = (5, 10)  # epochs, MultiStep-style
    weight_decay: float = 4.0e-5


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
class LossConfig:
    smoothness_lambda_v1: float = 0.0
    smoothness_lambda_v2: float = 0.01
    smoothness_gmin: float = 2.0
    smoothness_grad_ratio: float = 0.1


@dataclass(frozen=True)
class TrainingConfig:
    epochs: int = 15
    eval_interval: int = 10000
    pretrained_checkpoint_path: str = ""
    pretrained_subtrees: tuple[str, ...] = ("backbone", "decoder")
    src_rgb_blending: bool = True
    use_multi_scale: bool = True
    seed: int = 0
    accum_steps: int = 1
    resume_from: str = "latest"
    # "adam" (two-group Adam) or "sgd" (the same groups, no moments)
    optimizer: str = "adam"
    log_interval: int = 10
    checkpoint_interval: int = 5000
    lpips_weights_path: str = ""


@dataclass(frozen=True)
class MeshConfig:
    data_parallel: int = -1
    fsdp_parallel: int = 1
    plane_parallel: int = 1


@dataclass(frozen=True)
class ParallelConfig:
    # ZeRO-1 optimizer-state sharding over the batch replicas, the leaf size
    # under which a leaf stays replicated, and extra partition-rule rows
    # ("pattern = axes") prepended to the JAX package's table
    # (mine_tpu/parallel/rules.py): read, and refused away from these
    # defaults until the port shards state (unsupported_training_options)
    zero1: bool = False
    zero1_min_size: int = 1024
    rules: tuple[str, ...] = ()


@dataclass(frozen=True)
class ResilienceConfig:
    # the training sentinel (resilience/sentinel.py): "off" | "skip" |
    # "rollback" | "abort"
    sentinel_policy: str = "off"
    sentinel_spike_factor: float = 0.0
    sentinel_spike_window: int = 32
    sentinel_spike_min_history: int = 5
    max_rollbacks: int = 2
    # SIGTERM/SIGUSR2 save a checkpoint of the last completed step before
    # the flight recorder's dump-then-terminate runs (resilience/preempt.py)
    preempt_save: bool = True
    # serving admission control (serving/batcher.py, serving/server.py):
    # the render queue's bound (0 = unbounded), the Retry-After of a 503,
    # the default per-render deadline
    serve_max_queue_requests: int = 64
    serve_retry_after_s: float = 1.0
    serve_deadline_s: float = 30.0
    # the engine's circuit breaker (resilience/breaker.py): consecutive
    # failures that open it (0 disables), the open window, and its seeded
    # +-fraction jitter
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 30.0
    breaker_reset_jitter: float = 0.2
    # the cross-host watchdog (0 = off), the heartbeat directory (default
    # <workspace>/heartbeats) and the retrying bring-up of multi-process
    # training (resilience/multihost.py)
    multihost_watchdog_s: float = 0.0
    multihost_heartbeat_dir: str = ""
    multihost_bringup_attempts: int = 3
    multihost_bringup_backoff_s: float = 2.0


@dataclass(frozen=True)
class ObsConfig:
    # master switch of training's observability: host spans, the counted
    # step and the MFU gauges, the flight recorder's signal handlers
    enabled: bool = False
    # bounded span ring (training's and the server's, obs/trace.py)
    trace_buffer_spans: int = 4096
    # torch.profiler window: start `profile_start_offset` steps after
    # (re)start, run `profile_steps` steps (0 = no device trace), then the
    # component attribution (obs/attrib.py)
    profile_start_offset: int = 5
    profile_steps: int = 0
    # stall watchdog: no completed step for this many seconds => a flight
    # dump (obs/flight.py); 0 disables
    flight_watchdog_s: float = 0.0
    flight_last_k_spans: int = 256
    # one counted step (obs/cost.py) and the MFU gauges
    cost_enabled: bool = True
    # the peak FLOP/s MFU divides by when the card has no table entry
    # (obs/cost.py); 0 = the table
    peak_flops_override: float = 0.0


@dataclass(frozen=True)
class ServingConfig:
    # MPI cache tier (serving/compress.py): "fp32", "bf16" or "int8"
    cache_tier: str = "fp32"
    # transmittance pruning threshold at predict time; 0 disables
    prune_transmittance_eps: float = 0.0
    # the budget of one peer fetch (owner and failover together)
    peer_fetch_timeout_s: float = 2.0
    # the SLO tracker, the elastic fleet and the brownout ladder
    # (obs/slo.py, serving/autoscale.py, serving/degrade.py)
    slo_availability_target: float = 0.995
    slo_p95_ms: float = 2000.0
    slo_window_s: float = 300.0
    autoscale_min_replicas: int = 2
    autoscale_max_replicas: int = 6
    autoscale_interval_s: float = 10.0
    autoscale_up_burn_threshold: float = 1.0
    autoscale_down_burn_threshold: float = 0.25
    autoscale_up_after: int = 2
    autoscale_down_after: int = 5
    autoscale_cooldown_s: float = 60.0
    autoscale_prewarm_keys: int = 64
    autoscale_join_timeout_s: float = 30.0
    autoscale_drain_timeout_s: float = 30.0
    degrade_enabled: bool = False
    degrade_queue_high: float = 0.75
    degrade_queue_low: float = 0.25
    degrade_burn_high: float = 2.0
    degrade_burn_low: float = 0.5
    degrade_engage_after: int = 2
    degrade_relax_after: int = 3
    degrade_dwell_s: float = 5.0
    degrade_max_level: int = 3
    degrade_coalesce_delay_ms: float = 25.0
    degrade_scaleup_level: int = 1


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    lr: LRConfig = field(default_factory=LRConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mpi: MPIConfig = field(default_factory=MPIConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

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
    "training.fine_tune",
    "training.sample_interval",
    "testing.frames_apart",
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
        elem = float if "float" in target else (str if "str" in target else int)
        return tuple(elem(v) for v in value)
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
            if key in _RETIRED_KEYS:
                continue
            if key not in flat:
                raise KeyError(f"unknown config key: {key!r}")
            flat[key] = value
    return from_flat_dict(flat)


def save_config(cfg: Config, path: str) -> None:
    """The config as flat dot-key YAML (mine_tpu/config.py save_config)."""
    flat = {k: (list(v) if isinstance(v, tuple) else v) for k, v in to_flat_dict(cfg).items()}
    with open(path, "w") as fh:
        yaml.safe_dump(flat, fh, sort_keys=True)


def unsupported_training_options(cfg: Config) -> list[str]:
    """The options set away from their defaults that the port's training
    path does not honour yet, each naming its ROADMAP queue 1 item."""
    found = []
    warm = cfg.training.pretrained_checkpoint_path
    if warm and not warm.endswith(".npz"):
        found.append(f"training.pretrained_checkpoint_path={warm!r}: the port warm-starts "
                     "from a converted .npz; other checkpoint formats wait for ROADMAP "
                     "queue 1 item 7")
    if cfg.mpi.num_bins_fine > 0:
        found.append("mpi.num_bins_fine > 0 waits for ROADMAP queue 1 item 5 "
                     "(coarse-to-fine)")
    if cfg.mesh.fsdp_parallel > 1:
        found.append(f"mesh.fsdp_parallel={cfg.mesh.fsdp_parallel}: the fsdp axis waits for "
                     "ROADMAP queue 1 item 6 (slice 10: fsdp, ZeRO-1, parallel/rules.py)")
    if cfg.parallel.zero1:
        found.append("parallel.zero1=True: ZeRO-1 waits for ROADMAP queue 1 item 6 "
                     "(slice 10: fsdp, ZeRO-1, parallel/rules.py)")
    if cfg.parallel.rules:
        found.append(f"parallel.rules={list(cfg.parallel.rules)!r}: the partition-rule table "
                     "waits for ROADMAP queue 1 item 6 (slice 10: fsdp, ZeRO-1, "
                     "parallel/rules.py)")
    return found
