"""The training loop (counterpart of mine_tpu/training/loop.py): epochs of
train steps, the MultiStep schedule stepped per update,
the loss dict logged every `training.log_interval` steps, checkpoints every
`training.checkpoint_interval` steps and at the end (each marked last-good
once the sentinel has vetted it), eval over the val set every
`training.eval_interval` steps and at the reference's first eval step 2000,
auto-resume from the workspace (`training.resume_from`: latest | last_good),
a warm start (a converted .npz, or a workspace: the port's own, or one that
tools/jax_workspace_to_torch.py exported from the JAX package), the
sentinel's rollback loop, and an emergency checkpoint when a run dies (never
masking the error). Batches come
through `staged_batches`: built `data.num_workers` ahead on a host thread, in
page-locked memory, with `data.loader_retries` retries.

Observability (cfg.obs.*, mine_tpu_torch/obs/): when enabled, every step is
broken into host spans (data/step/sync/log/ckpt) on a bounded ring, exported
as Chrome-trace JSON to `<workspace>/profile/host_spans.trace.json` with the
device-memory samples; a flight recorder dumps thread stacks and the last-K
spans on SIGTERM/SIGUSR1 or a stall; and one step runs under a FLOP counter
(obs/cost.py) so that a live MFU gauge is published over each log interval
(`TrainObsMetrics`, the JAX package's names, and `<workspace>/metrics.jsonl`).
Disabled (the default), the spans are a shared no-op context manager. A
torch.profiler window (`obs.profile_start_offset`, `obs.profile_steps`, or
the first `profile_steps` steps when the Trainer is asked for them) is
attributed per component (obs/attrib.py) when it closes.

Resilience: the preemption guard (resilience/preempt.py) saves the last
completed step on SIGTERM/SIGUSR2 (`resilience.preempt_save`), deferring a
signal that lands inside a step or a checkpoint write to its end; the chaos
seams `nan_loss`, `sigterm`, `sigusr2`, `preempt_exit` and (through the
pipeline) `loader_raise` fire here (resilience/chaos.py).

On a mesh (a torch.distributed job, parallel/): one rank per device, each
with its rows of the global batch (per_gpu_batch_size x the batch replicas)
from a loader built with `host_slice`, its planes under plane sharding, and
the step's collectives (parallel/data_parallel.py). Rank 0's weights are
broadcast at the start; every rank restores the same checkpoint; only rank
0 writes checkpoints, params.yaml, train.log, metrics.jsonl and the jsonl
logs. Under a sharded state layout (mesh.fsdp_parallel > 1, or
parallel.zero1 over more than one batch replica; parallel/rules.py) each
rank holds its shards of the parameters and Adam moments between steps:
`distribute_state` places the full state (first placement, warm start,
restore) and a checkpoint gathers it on every rank before rank 0 writes it,
so that checkpoints are layout-free. On more than one rank a preemption
signal is a request that every rank honours together: the guard records it,
each step boundary all-reduces the ranks' requests (one int32 MAX), and when
any rank holds one every rank saves the last completed step (the gathered
checkpoint, rank 0 writing) and takes the signal's disposition (SIGTERM ends
every rank as it ends one process, SIGUSR2 lets all continue). The emergency
checkpoint of a run that dies under a sharded layout on several ranks starts
no collective, since a peer may be dead or blocked: each rank writes the
shards it holds and the replicated rest to a file of its own
(`checkpoints/<step>-r<rank>of<world>`), and the step counts once every
rank's file verifies (training/checkpoint.py). Multi-process survival
(resilience/multihost.py): each rank beats a heartbeat file at its log
intervals, a watchdog turns a dead or wedged peer
into a named abort (exit code 83), and the `host_kill`/`host_stall` chaos
seams fire after a step.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import time
from contextlib import nullcontext
from itertools import islice
from typing import Any, Callable, Iterable, Iterator, Mapping

import torch

from mine_tpu_torch.config import Config, unsupported_training_options
from mine_tpu_torch.data.pipeline import prefetch
from mine_tpu_torch.losses.lpips import load_lpips_params
from mine_tpu_torch.models.convert import load_npz_subtrees
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.obs.attrib import attach_cost_estimates, attribute_events, load_trace_events
from mine_tpu_torch.obs.cost import compute_mfu, counted_cost, resolve_peak_flops
from mine_tpu_torch.obs.flight import FlightRecorder
from mine_tpu_torch.obs.ledger import set_build_info
from mine_tpu_torch.obs.memlog import MemLog
from mine_tpu_torch.obs.trace import Tracer
from mine_tpu_torch.parallel.comm import all_reduce_max_int
from mine_tpu_torch.parallel.data_parallel import (
    distribute_state,
    gathered_state,
    load_full_params,
    make_plan,
    model_groups,
    optimizer_names,
    with_layout,
)
from mine_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    data_replica_count,
    host_batch_slice,
    make_mesh,
    mesh_shape_str,
    process_count,
    process_index,
    rank_device,
)
from mine_tpu_torch.resilience import chaos, multihost
from mine_tpu_torch.resilience.chaos import PreemptedError
from mine_tpu_torch.resilience.preempt import PreemptionGuard
from mine_tpu_torch.resilience.sentinel import SentinelAbort, SentinelRollback, TrainingSentinel
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.training.optimizer import lr_factor, make_optimizer
from mine_tpu_torch.training.step import (
    batch_to_device,
    build_model,
    eval_step,
    pin_batch,
    train_step,
)
from mine_tpu_torch.utils.device import resolve_device
from mine_tpu_torch.utils.logging import (
    LOGGER_NAME,
    MetricWriter,
    make_logger,
    normalize_disparity_for_vis,
)
from mine_tpu_torch.utils.metrics import MetricsRegistry

logger = logging.getLogger(LOGGER_NAME)

LOSS_KEYS = (
    "loss", "loss_rgb_src", "loss_ssim_src", "loss_disp_pt3dsrc",
    "loss_smooth_src", "loss_smooth_tgt", "loss_smooth_src_v2",
    "loss_smooth_tgt_v2", "loss_rgb_tgt", "loss_ssim_tgt", "lpips_tgt",
    "psnr_tgt", "loss_disp_pt3dtgt",
)
# the reference's first eval comes at this step, whatever the interval
FIRST_EVAL_STEP = 2000


class AverageMeter:
    """Running weighted mean of one logged value."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


def staged_batches(epoch_iter: Iterable[dict], device: torch.device, num_workers: int,
                   retries: int = 0,
                   on_retry: Callable[[int, BaseException], None] | None = None,
                   ) -> Iterator[dict]:
    """Pipeline overlap (mine_tpu/training/loop.py staged_batches): host
    batches are built up to `num_workers` ahead on a background thread,
    each into fresh page-locked tensors there, so that the consumer's copy
    to the card (batch_to_device, on the consumer's stream) is issued
    without blocking the host. The JAX package's second stage, which
    bounds the batches staged in device memory, has nothing to bound here:
    no batch reaches the card before its step. `retries`
    (data.loader_retries) bounds transient-error retries (data/pipeline.py).
    num_workers 0 is fully synchronous and copies from pageable memory, as
    does a CPU device (nothing to pin). Each produced batch consults the
    `loader_raise` chaos seam, inside the retries. Close the returned
    generator when abandoning it early: its producer thread then stops."""
    pin = pin_batch if num_workers > 0 and device.type == "cuda" else None
    return prefetch(epoch_iter, num_workers, transfer=pin, retries=retries, on_retry=on_retry,
                    fault_seam="loader_raise")


def _to_host(values: Mapping[str, torch.Tensor]) -> dict[str, float]:
    """Device scalars -> floats in one transfer."""
    keys = list(values)
    host = torch.stack([values[k].detach().reshape(()).double() for k in keys]).cpu().tolist()
    return dict(zip(keys, host))


def run_evaluation(cfg: Config, model: torch.nn.Module, val_ds: Any,
                   device: torch.device, lpips_params: dict | None = None,
                   global_step: int = 0, plan=None,
                   writer: MetricWriter | None = None) -> dict[str, float]:
    """The metric pass over the whole val set (epoch 0), shared by the
    train loop and `python -m mine_tpu_torch.evaluate`: every LOSS_KEYS
    value averaged over the genuine examples (each batch weighted by its
    eval_examples), plus "eval_examples", their count, which must equal the
    dataset's num_eval_examples when it declares one. Disparities come from
    a generator seeded training.seed + 17. Batches are staged as in training
    (staged_batches, data.num_workers ahead, no retries). With a `plan`
    val_ds holds this rank's rows, and the count and the means are the whole
    mesh's (eval_step). A `writer` gets the means as val/ scalars, then the
    last batch's first four synthesized target and source views and target
    disparities (normalised) as the image grids val/tgt_syn, val/src_syn and
    val/tgt_disparity, as the JAX package writes them (under a plan, of this
    rank's rows)."""
    meters = {k: AverageMeter(k) for k in LOSS_KEYS}
    generator = torch.Generator().manual_seed(cfg.training.seed + 17)
    n_examples = 0
    viz = None
    batches = staged_batches(val_ds.epoch(0), torch.device(device), cfg.data.num_workers)
    try:
        for batch in batches:
            loss_dict, viz = eval_step(cfg, model, batch_to_device(batch, device), generator,
                                       lpips_params, plan=plan)
            host = _to_host({k: loss_dict[k] for k in LOSS_KEYS + ("eval_examples",)})
            n_batch = int(round(host.pop("eval_examples")))
            n_examples += n_batch
            for k, v in host.items():
                meters[k].update(v, n=n_batch)
    finally:
        batches.close()
    expected = getattr(val_ds, "num_eval_examples", None)
    if expected is not None and n_examples != expected:
        raise RuntimeError(f"eval example count mismatch: metered {n_examples}, dataset "
                           f"holds {expected}; the eval_weight mask is miscounting")
    result = {k: m.avg for k, m in meters.items()}
    result["eval_examples"] = n_examples
    logger.info("eval @ %d: loss=%.4f loss_rgb_tgt=%.4f psnr_tgt=%.4f lpips_tgt=%.4f "
                "(%d examples)", global_step, result["loss"], result["loss_rgb_tgt"],
                result["psnr_tgt"], result["lpips_tgt"], n_examples)
    if writer is not None:
        writer.scalars(result, global_step, prefix="val/")
        if viz is not None:
            host_viz = {k: viz[k][:4].detach().float().cpu().numpy()
                        for k in ("tgt_imgs_syn", "src_imgs_syn", "tgt_disparity_syn")}
            writer.image_grid("val/tgt_syn", host_viz["tgt_imgs_syn"], global_step)
            writer.image_grid("val/src_syn", host_viz["src_imgs_syn"], global_step)
            writer.image_grid("val/tgt_disparity",
                              normalize_disparity_for_vis(host_viz["tgt_disparity_syn"]),
                              global_step)
        writer.flush()
    return result


class TrainObsMetrics:
    """Training's live gauge set on a utils/metrics.py registry (the JAX
    package's `mine_train_*` names), the queryable twin of the
    MetricWriter scalars."""

    def __init__(self):
        self.registry = MetricsRegistry()
        r = self.registry
        self.mfu = r.gauge(
            "mine_train_mfu",
            "model FLOPs utilization: counted FLOPs per step (obs/cost.py) over "
            "measured step time, divided by the card's published peak")
        self.tflops_per_sec = r.gauge(
            "mine_train_tflops_per_sec", "achieved model TFLOP/s of the train step")
        self.step_flops = r.gauge(
            "mine_train_step_flops", "FLOPs of one train step (FlopCounterMode count)")
        self.hbm_fraction = r.gauge(
            "mine_train_achieved_hbm_fraction",
            "bytes accessed per step over step time, divided by peak HBM bandwidth "
            "(absent: the port counts no bytes, obs/cost.py)")
        self.imgs_per_sec = r.gauge("mine_train_imgs_per_sec", "training throughput")
        self.sync_wait_ms = r.gauge(
            "mine_train_sync_wait_ms",
            "wall time of the log-interval device-to-host sync (labeled by process_index)")
        self.grad_norm = r.gauge(
            "mine_train_grad_norm", "global gradient norm at the latest logged step")
        self.data_retries = r.counter(
            "mine_train_data_retries_total",
            "host batches retried after transient loader/staging errors "
            "(data.loader_retries; labeled by process_index)")
        self.data_host_bytes = r.counter(
            "mine_train_data_host_bytes_total",
            "bytes of batch data this process's loader materialized (labeled "
            "by process_index). Under per-host data sharding each of N "
            "processes counts ~1/N of the global batch bytes")
        self.accum_steps = r.gauge(
            "mine_train_accum_steps", "micro-batches accumulated per optimizer update")
        self.effective_batch = r.gauge(
            "mine_train_effective_batch", "examples per optimizer update")
        self.micro_step_flops = r.gauge(
            "mine_train_flops_per_micro_step",
            "step_flops / accum_steps: FLOPs of one micro-batch forward+backward")
        self.component_time_ms = r.gauge(
            "mine_train_component_time_ms",
            "device time per named component over the last profile window "
            "(obs/attrib.py; labels: component, plus the unattributed remainder)")
        self.attrib_coverage = r.gauge(
            "mine_train_attrib_coverage",
            "fraction of profiled device time attributed to a named component "
            "(the table is only trustworthy >= 0.9)")
        self.hbm_live_bytes = r.gauge(
            "mine_train_hbm_live_bytes",
            "torch.cuda.memory_allocated, sampled each log interval (obs/memlog.py)")
        self.hbm_peak_bytes = r.gauge(
            "mine_train_hbm_peak_bytes", "torch.cuda.max_memory_allocated (obs/memlog.py)")


class Trainer:
    """One model, its optimizer, schedule and generators on one device; on
    a mesh, one rank of it (the module docstring).

    Weights are `state_dict` when given, else seeded random weights
    (training.seed); a workspace checkpoint or a warm start (an .npz, or a
    workspace directory with its optimizer state) replaces them in fit().
    The stratified disparities and the sigma dropout masks come from two
    CPU generators seeded from training.seed. Runs on CUDA
    unless `device="cpu"` is asked for. Options the port does not honour
    yet raise here. `profile_steps` > 0 traces the first that many steps of
    fit() (the CLI's --profile-steps); otherwise obs.profile_steps traces a
    window starting obs.profile_start_offset steps in. Either needs a
    workspace, as do the flight recorder and the metric stream.

    A torch.distributed job (parallel/mesh.py init_distributed, before the
    Trainer) trains on the mesh cfg.mesh describes over its ranks; the
    rank's device is `device`, else cuda:{LOCAL_RANK}.
    """

    def __init__(self, cfg: Config, workspace: str | None = None,
                 device: str | torch.device | None = None,
                 state_dict: Mapping[str, torch.Tensor] | None = None,
                 profile_steps: int = 0):
        problems = unsupported_training_options(cfg)
        if problems:
            raise NotImplementedError("; ".join(problems))
        accum = max(int(cfg.training.accum_steps), 1)
        if cfg.data.per_gpu_batch_size % accum:
            raise ValueError(
                f"training.accum_steps={accum} must divide data.per_gpu_batch_size="
                f"{cfg.data.per_gpu_batch_size} (the per-device batch reshapes to (k, b/k, ...))"
            )
        self.cfg = cfg
        self.workspace = workspace
        self.mesh = make_mesh(cfg.mesh.data_parallel, cfg.mesh.plane_parallel,
                              cfg.mesh.fsdp_parallel)
        # the step's collectives: none without a process group
        self.plan = make_plan(cfg, self.mesh) if self.mesh.device_mesh is not None else None
        self.rank = process_index()
        self.is_main = self.rank == 0
        if device is None and self.plan is not None:
            device = rank_device()
        self.device = resolve_device(device)
        obs = cfg.obs
        self.tracer = Tracer(enabled=obs.enabled, max_spans=obs.trace_buffer_spans)
        self.obs_metrics = TrainObsMetrics()
        set_build_info(self.obs_metrics.registry, backend=self.device.type)
        self.obs_metrics.accum_steps.set(accum)
        # batches shard their rows over the batch replicas (parallel/mesh.py)
        self.global_batch = cfg.data.per_gpu_batch_size * data_replica_count(self.mesh)
        # the rows this rank's loader builds; None: the whole batch
        self.host_slice = (host_batch_slice(self.mesh, self.global_batch)
                           if data_replica_count(self.mesh) > 1 else None)
        self.obs_metrics.effective_batch.set(self.global_batch)
        # device-memory telemetry rides the obs switch, like the tracer
        self.memlog = MemLog(tracer=self.tracer, live_gauge=self.obs_metrics.hbm_live_bytes,
                             peak_gauge=self.obs_metrics.hbm_peak_bytes, device=self.device)
        self._progress: dict[str, Any] = {}
        self.flight: FlightRecorder | None = None
        if obs.enabled and workspace:
            self.flight = FlightRecorder(
                os.path.join(workspace, "flight"), tracer=self.tracer,
                watchdog_timeout_s=obs.flight_watchdog_s, last_k_spans=obs.flight_last_k_spans,
                get_status=self._flight_status,
            )
        self.sentinel = TrainingSentinel(cfg.resilience, logger, flight=self.flight)
        # heartbeats and the cross-host watchdog (None on one process)
        self.multihost = multihost.MultihostSurvival.maybe_create(
            cfg, workspace, flight=self.flight, logger=logger) if workspace else None
        self._host_bytes = 0  # batch bytes this process's loader materialized
        self._last_sync_wait_ms: float | None = None
        # (steps after the start, steps): the torch.profiler window; rank 0's
        if not workspace or not self.is_main:
            self.profile_window = (0, 0)
        elif profile_steps:
            self.profile_window = (0, profile_steps)
        else:
            self.profile_window = (obs.profile_start_offset, obs.profile_steps)
        self.train_cost = None  # obs/cost.py StepCost of the counted step
        self.attribution: dict | None = None  # the last profile window's table
        self.peak_flops = resolve_peak_flops(self.device, obs.peak_flops_override)
        self.writer: MetricWriter | None = None
        self._guard: PreemptionGuard | None = None
        model = build_model(cfg, **model_groups(self.mesh))
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(cfg.training.seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        if self.plan is not None:
            # the partition-rule table's layout of this model (None: replicated)
            self.plan = with_layout(self.plan, cfg, self.model)
        # the step of the checkpoint this trainer last wrote or restored: under
        # a sharded layout every rank decides from it whether to save (a
        # collective), never from a file rank 0 may not have finished writing
        self._saved_step: int | None = None
        self._torn = False  # a failed step had begun its update (Trainer.step)
        self.generator = torch.Generator().manual_seed(cfg.training.seed)
        self.dropout_generator = torch.Generator().manual_seed(cfg.training.seed + 1)
        self.batch_size = cfg.data.per_gpu_batch_size
        self.global_step = 0
        self.optimizer = self.scheduler = None
        self.lpips_params = load_lpips_params(cfg.training.lpips_weights_path, self.device)
        # (global_step, result) of every eval this trainer ran
        self.evals: list[tuple[int, dict[str, float]]] = []
        if workspace and self.is_main:
            ckpt.save_paired_config(cfg, workspace)

    # -- state ----------------------------------------------------------------

    @property
    def layout(self):
        """The sharded state layout (parallel/rules.py TorchLayout), or None."""
        return None if self.plan is None else self.plan.layout

    def state(self) -> dict[str, Any]:
        """The training state a checkpoint holds, at full shape whatever the
        layout (under a sharded one a collective: every rank calls it)."""
        model_sd, opt_sd = gathered_state(self.model, self.optimizer, self.layout, self.mesh)
        return {
            "model": model_sd,
            "optimizer": opt_sd,
            "scheduler": self.scheduler.state_dict(),
            "global_step": self.global_step,
            "generators": {"disparity": self.generator.get_state(),
                           "dropout": self.dropout_generator.get_state()},
        }

    def load_state(self, state: Mapping[str, Any]) -> None:
        """Restore a (layout-free) checkpoint's state into the live layout."""
        if self.layout is not None:
            load_full_params(self.model, state["model"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.global_step = int(state["global_step"])
        self.generator.set_state(state["generators"]["disparity"])
        self.dropout_generator.set_state(state["generators"]["dropout"])
        if self.plan is not None:
            distribute_state(self.model, self.optimizer, self.mesh, self.layout)
        self._saved_step = self.global_step

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict at full shape (a collective under a
        sharded layout)."""
        return gathered_state(self.model, None, self.layout, self.mesh)[0]

    def _sharded_ranks(self) -> bool:
        return self.layout is not None and process_count() > 1

    def rank_shard(self) -> dict[str, Any]:
        """What this rank holds of the training state, on the host, with the
        placements that put it together again (checkpoint.assemble_shards):
        its parameter and Adam-moment shards, the replicated rest, the mesh
        coordinates. No collective: the emergency checkpoint under a sharded
        layout on several ranks."""
        layout, mesh = self.layout, self.mesh

        def placements(table) -> dict:
            return {name: (pl.dim, list(pl.axes)) for name, pl in table.items()}

        host = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
        opt = self.optimizer.state_dict()
        return {
            "rank": self.rank, "world": process_count(), "global_step": self.global_step,
            "mesh": {"shape": dict(mesh.shape),
                     "coords": {ax: mesh.coordinate(ax) for ax in AXIS_NAMES}},
            "layout": {"params": placements(layout.params),
                       "updates": placements(layout.updates)},
            "model": host(self.model.state_dict()),
            "optimizer": dict(opt, state={i: {k: v.detach().cpu() if torch.is_tensor(v) else v
                                              for k, v in entry.items()}
                                          for i, entry in opt["state"].items()}),
            "optimizer_names": optimizer_names(self.optimizer, self.model),
            "scheduler": self.scheduler.state_dict(),
            "generators": {"disparity": self.generator.get_state(),
                           "dropout": self.dropout_generator.get_state()},
        }

    def save_checkpoint(self) -> None:
        """Rank 0 writes; the other ranks hold the same state. Under a
        sharded layout every rank gathers first, and the step counts as
        saved (`_has_checkpoint`) only once the gather has completed."""
        if self.is_main or self.layout is not None:
            state = self.state()
            if self.is_main:
                cfg = self.cfg.training
                ckpt.save(self.workspace, state, self.global_step,
                          keep_period=max(cfg.eval_interval // cfg.checkpoint_interval, 1))
        self._saved_step = self.global_step

    def _has_checkpoint(self, step: int) -> bool:
        """Whether `step` is saved: under a sharded layout on several ranks
        this trainer's own record (every rank agrees on it), else the
        workspace."""
        if self._sharded_ranks():
            return step == self._saved_step
        return step in ckpt.all_steps(self.workspace)

    def _mark_last_good(self, step: int) -> None:
        if self.is_main:
            ckpt.mark_last_good(self.workspace, step)

    def _warm_start_workspace(self, path: str, steps_per_epoch: int) -> None:
        """Warm-start from a workspace's newest step as the JAX package does
        from its own workspaces (mine_tpu/training/loop.py, ckpt.restore of
        the whole train state): the parameters, BatchNorm statistics, Adam
        moments and counts, the schedule's count and the generators carry
        over, while this run counts its steps from 0 and keeps this config's
        learning rates, the schedule's position recomputed for this run's
        epoch length. The workspace is the port's own or one that
        tools/jax_workspace_to_torch.py exported; a JAX workspace raises
        OrbaxWorkspaceError, one with no checkpoint FileNotFoundError."""
        step = ckpt.latest_step(path)
        if step is None:
            raise FileNotFoundError(f"training.pretrained_checkpoint_path={path!r} contains no "
                                    "checkpoint")
        state = ckpt.load(path, step)
        self.model.load_state_dict(state["model"])
        own = self.optimizer.state_dict()
        self.optimizer.load_state_dict(dict(own, state=state["optimizer"]["state"]))
        count = int(state["scheduler"]["last_epoch"])
        self.scheduler.last_epoch = count
        for group in self.optimizer.param_groups:
            group["lr"] = group["initial_lr"] * lr_factor(self.cfg, steps_per_epoch, count)
        self.generator.set_state(state["generators"]["disparity"])
        self.dropout_generator.set_state(state["generators"]["dropout"])
        logger.info("warm-started from %s @ step %d", path, step)

    def _warm_start(self, path: str, subtrees: tuple[str, ...]) -> None:
        """Load the subtrees of a converted .npz into the model (strict)."""
        weights = load_npz_subtrees(path, self.cfg.model.num_layers, subtrees)
        with torch.no_grad():
            own = self.model.state_dict()
            for key, value in weights.items():
                own[key].copy_(value)
        logger.info("warm-started %s from %s", "+".join(subtrees), path)

    def _start(self, steps_per_epoch: int) -> int:
        """Build the optimizer, then resume from the workspace
        (training.resume_from), else warm-start; returns the start step."""
        cfg = self.cfg
        if cfg.training.resume_from not in ("latest", "last_good"):
            raise ValueError(f"training.resume_from={cfg.training.resume_from!r} "
                             "(known: latest, last_good)")
        self.optimizer, self.scheduler = make_optimizer(cfg, self.model, steps_per_epoch)
        step = None
        if self.workspace:
            if cfg.training.resume_from == "last_good":
                try:
                    step = ckpt.last_good_target(self.workspace)
                except FileNotFoundError:
                    step = None  # a fresh workspace: nothing to trust yet
            else:
                step = ckpt.latest_step(self.workspace)
        if step is not None:
            self.load_state(ckpt.load(self.workspace, step))
            logger.info("resumed from step %d (epoch %d)", step, step // steps_per_epoch + 1)
            return step
        self.global_step = 0
        warm = cfg.training.pretrained_checkpoint_path
        if warm and warm.endswith(".npz"):
            # backbone + decoder from a converted MINE checkpoint; the
            # optimizer, schedule and step start fresh
            self._warm_start(warm, tuple(cfg.training.pretrained_subtrees))
        elif warm:
            self._warm_start_workspace(warm, steps_per_epoch)
        elif cfg.model.imagenet_pretrained and cfg.model.pretrained_backbone_path:
            self._warm_start(cfg.model.pretrained_backbone_path, ("backbone",))
        if self.plan is not None:
            distribute_state(self.model, self.optimizer, self.mesh, self.layout)
        return 0

    # -- steps ----------------------------------------------------------------

    def step(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """One update on a loader batch (numpy arrays); returns the detached
        loss dict, still on the device. A step that raises leaves the
        generators where they were."""
        if self.optimizer is None:
            raise RuntimeError("Trainer.step before fit(): the optimizer needs the epoch length")
        states = self.generator.get_state(), self.dropout_generator.get_state()
        count = self.scheduler.last_epoch
        try:
            out = train_step(self.cfg, self.model, self.optimizer, self.scheduler,
                             batch_to_device(batch, self.device), self.generator,
                             self.dropout_generator, plan=self.plan)
        except BaseException:
            self.generator.set_state(states[0])
            self.dropout_generator.set_state(states[1])
            # an update that began (the schedule stepped) and failed in its
            # gathers has left no completed step in memory
            self._torn = self.scheduler.last_epoch != count
            raise
        self.global_step += 1
        return out

    def evaluate(self, val_ds: Any) -> dict[str, float]:
        """run_evaluation at the current weights; the model returns to train
        mode after it."""
        try:
            result = run_evaluation(self.cfg, self.model, val_ds, self.device,
                                    self.lpips_params, self.global_step, plan=self.plan,
                                    writer=self.writer)
        finally:
            self.model.train()
        self.evals.append((self.global_step, result))
        if self.workspace and self.is_main:
            with open(os.path.join(self.workspace, "eval_log.jsonl"), "a") as fh:
                fh.write(json.dumps({"global_step": self.global_step, **result}) + "\n")
        return result

    # -- preemption and evidence ----------------------------------------------

    def _deferring(self):
        """A step or checkpoint write: a preemption signal inside it saves at
        its end (resilience/preempt.py)."""
        return self._guard.deferring() if self._guard is not None else nullcontext()

    def _preempt_save(self, reason: str) -> None:
        """The preemption guard's save (resilience/preempt.py), on the main
        thread outside any step: the last completed step, unless it is on
        disk already; the last-good pointer moves only when the sentinel
        vets the step (vet() never raises: a bad verdict waits for the next
        check()). On several ranks every rank runs it together at a step
        boundary (`_preempt_boundary`): the checkpoint's gather is a
        collective, and rank 0 writes."""
        if not self.workspace or self.optimizer is None:
            return
        step = self.global_step
        logger.warning("preemption save (%s): persisting step %d", reason, step)
        if not self._has_checkpoint(step):
            self.save_checkpoint()
        if self.sentinel.vet(step):
            self._mark_last_good(step)
        else:
            logger.warning("preemption save: step %d saved but NOT marked last-good "
                           "(unvetted non-finite flags)", step)

    def _preempt_boundary(self) -> None:
        """On several ranks, at a step boundary: the ranks' recorded
        preemption requests all-reduced (MAX, one int32), and when any rank
        holds one, every rank saves and takes its disposition together
        (PreemptionGuard.resolve). Every rank calls it at the same points."""
        guard = self._guard
        if guard is None or not guard.collective:
            return
        agreed = all_reduce_max_int(guard.pending(), self.mesh.world_group, self.device)
        if agreed:
            guard.resolve(agreed)

    def _flight_status(self) -> dict:
        """What a flight dump's meta.json records about this trainer: the
        progress counters, the last logged gauges and memory sample. A copy
        of one dict the loop keeps: a dump runs in a signal handler on the
        loop's own thread, which may be holding the registry's or the memory
        log's lock at that moment."""
        return dict(self._progress)

    def _export_host_trace(self) -> None:
        """The host spans (and the memory samples as counter events) next
        to the torch.profiler traces."""
        if not self.workspace or not self.tracer.enabled or not len(self.tracer):
            return
        # one file a process on a multi-process run (obs/collect.py
        # training_timeline merges them)
        name = (f"host_spans_p{self.rank}.trace.json" if process_count() > 1
                else "host_spans.trace.json")
        try:
            self.tracer.export(os.path.join(self.workspace, "profile", name),
                               extra_events=self.memlog.counter_events())
        except OSError:
            logger.exception("host trace export failed")

    # -- cost and attribution ---------------------------------------------------

    def _counted_step(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """One step under the FLOP counter (obs/cost.py); it is left out of
        every timing window."""
        loss_dict, cost = counted_cost(self.step, batch)
        self.train_cost = cost
        self._progress["step_flops"] = cost.flops
        m = self.obs_metrics
        if cost.flops:
            m.step_flops.set(cost.flops)
            m.micro_step_flops.set(cost.flops / max(int(self.cfg.training.accum_steps), 1))
            if self.writer is not None:
                self.writer.scalar("obs/step_flops", cost.flops, self.global_step)
        logger.info("obs cost accounting: step flops=%s peak memory=%s peak_flops=%s",
                    cost.flops, cost.peak_memory_bytes, self.peak_flops)
        return loss_dict

    def _publish_mfu(self, step_seconds: float) -> None:
        cost = self.train_cost
        if cost is None or not cost.flops or step_seconds <= 0:
            return
        achieved = cost.flops / step_seconds
        self.obs_metrics.tflops_per_sec.set(achieved / 1e12)
        mfu = compute_mfu(cost.flops, step_seconds, self.peak_flops)
        if self.writer is not None:
            self.writer.scalar("obs/tflops_per_sec", achieved / 1e12, self.global_step)
            self.writer.scalar("obs/step_flops", cost.flops, self.global_step)
            if mfu is not None:
                self.writer.scalar("obs/mfu", mfu, self.global_step)
        if mfu is not None:
            self.obs_metrics.mfu.set(mfu)
        self._progress.update(mfu=mfu, tflops_per_sec=achieved / 1e12)

    def _publish_phases(self) -> None:
        if self.writer is None:
            return
        for phase, stats in self.tracer.phase_summary(reset=True).items():
            if phase.startswith("train."):
                self.writer.scalar(f"obs/phase_{phase[len('train.'):]}_ms", stats["mean_ms"],
                                   self.global_step)

    def _start_profile(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _finish_profile(self, profiler: torch.profiler.profile) -> None:
        """Close the window: the trace to <workspace>/profile, the host spans
        beside it, then the component table into the gauges (the heartbeat
        beats around the export and the parse, which take seconds)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        path = os.path.join(self.workspace, "profile", "train_steps.trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        profiler.export_chrome_trace(path)
        self._export_host_trace()
        logger.info("profile trace of %d steps written to %s", self.profile_window[1], path)
        if self.flight is not None:
            self.flight.heartbeat(step=self.global_step)
        try:
            table = attribute_events(load_trace_events(path))
        except Exception:  # noqa: BLE001 - an instrument, never a crash
            logger.exception("profile attribution failed")
            return
        finally:
            if self.flight is not None:
                self.flight.heartbeat(step=self.global_step)
        if not table["rows"]:
            logger.info("profile attribution: no op events in the captured trace")
            return
        table["trace"] = path
        if self.train_cost is not None:
            attach_cost_estimates(table, self.train_cost.flops, None)
        self.attribution = table
        m = self.obs_metrics
        for row in table["rows"]:
            m.component_time_ms.set(row["time_ms"], component=row["component"])
            if self.writer is not None:
                self.writer.scalar(f"obs/component_{row['component']}_ms", row["time_ms"],
                                   self.global_step)
        m.attrib_coverage.set(table["coverage"])
        if self.writer is not None:
            self.writer.scalar("obs/attrib_coverage", table["coverage"], self.global_step)
        logger.info("profile attribution (coverage %.1f%%%s): %s", 100.0 * table["coverage"],
                    "" if table["covered"] else ", BELOW the 90% accounting bar",
                    " ".join(f"{r['component']}={r['time_ms']:.1f}ms({r['pct']}%)"
                             for r in table["rows"]))

    # -- the loop -------------------------------------------------------------

    def fit(self, train_ds: Any, val_ds: Any | None = None,
            max_steps: int | None = None) -> dict[str, float]:
        """Train for training.epochs epochs of len(train_ds) steps (or stop
        once `max_steps` updates are done in all), resuming from the
        workspace when it holds a checkpoint. Returns the last logged loss
        dict as floats; eval results are in `self.evals`."""
        steps_per_epoch = len(train_ds)
        start = self._start(steps_per_epoch)
        if self.workspace and self.is_main:
            make_logger(self.workspace)
            self.writer = MetricWriter(self.workspace)
        if self.plan is not None:
            logger.info("rank %d of mesh %s (data x fsdp x plane), global batch %d, rows %s, "
                        "device %s", self.rank, mesh_shape_str(self.mesh), self.global_batch,
                        self.host_slice, self.device)
        if self.flight is not None:
            self.flight.start()
        if self.multihost is not None:
            self.multihost.start()
        # after the flight recorder, so that its SIGTERM handler chains:
        # save -> flight dump -> re-delivered termination
        if self.cfg.resilience.preempt_save:
            self._guard = PreemptionGuard(self._preempt_save, logger=logger,
                                          collective=process_count() > 1).install()
        guard = self._guard
        fit_ok = False
        try:
            out = self._fit_epochs(train_ds, val_ds, start, max_steps)
            fit_ok = True
            return out
        except (KeyboardInterrupt, Exception):
            if self.multihost is not None:
                # what is left may wait on a dead peer: bound it first
                self.multihost.arm_failsafe()
            if self.flight is not None:
                self.flight.dump("train_exception")
            # persist the last completed step so that the next run resumes;
            # a failing save must not mask the original error
            try:
                if not self.workspace or self.optimizer is None \
                        or self._has_checkpoint(self.global_step):
                    pass
                elif not self._sharded_ranks():
                    logger.exception("training interrupted at step %d; writing an emergency "
                                     "checkpoint", self.global_step)
                    self.save_checkpoint()
                elif self._torn:
                    logger.exception("training interrupted inside step %d's update; this rank "
                                     "holds no completed step to save", self.global_step + 1)
                else:
                    # no collective: each rank writes what it holds
                    logger.exception("training interrupted at step %d; writing rank %d's "
                                     "emergency shards", self.global_step, self.rank)
                    ckpt.save_rank_shard(self.workspace, self.rank_shard(), self.global_step,
                                         self.rank, process_count())
            except BaseException:  # noqa: BLE001 - incl. a second interrupt
                logger.exception("emergency checkpoint failed")
            if self.multihost is not None and self.multihost.peer_aborted():
                # a collective whose peer took the named abort: exit under
                # its verdict (exit code 83), not as a crash
                self.multihost.abort_after_peer(sys.exc_info()[1])
            raise
        finally:
            if self._guard is not None:
                self._guard.uninstall()
                self._guard = None
            if self.multihost is not None:
                # done only on a clean end: a failing host's silence is what
                # its peers' watchdogs must see
                self.multihost.stop(done=fit_ok, step=self.global_step,
                                    data_bytes=self._host_bytes,
                                    sync_wait_ms=self._last_sync_wait_ms)
            if self.flight is not None:
                self.flight.stop()
            self._export_host_trace()
            if self.writer is not None:
                self.writer.close()
                self.writer = None
            if self.workspace and self.is_main:
                make_logger(None)  # closes train.log
            if guard is not None:
                guard.redeliver()  # a SIGTERM recorded but never resolved

    def _fit_epochs(self, train_ds, val_ds, start: int, max_steps: int | None) -> dict:
        """The rollback loop: a SentinelRollback restores the last-good
        checkpoint and resumes the data stream there, at most
        resilience.max_rollbacks times before aborting."""
        rollbacks = 0
        while True:
            try:
                return self._run_epochs(train_ds, val_ds, start, max_steps)
            except SentinelRollback as trip:
                rollbacks += 1
                self.sentinel.rollbacks += 1
                if rollbacks > self.cfg.resilience.max_rollbacks:
                    raise SentinelAbort(f"{rollbacks} sentinel rollbacks exceed "
                                        f"resilience.max_rollbacks="
                                        f"{self.cfg.resilience.max_rollbacks}: {trip}") from trip
                try:
                    if not self.workspace:
                        raise FileNotFoundError("no workspace to hold a checkpoint")
                    start = ckpt.last_good_target(self.workspace)
                except FileNotFoundError as exc:
                    raise SentinelAbort(f"rollback impossible ({exc}); trip: {trip}") from trip
                self.load_state(ckpt.load(self.workspace, start))
                logger.warning("sentinel rollback #%d (%s): restored last-good step %d",
                               rollbacks, trip, start)
                self.sentinel.reset_after_rollback()

    def _run_epochs(self, train_ds, val_ds, start: int, max_steps: int | None) -> dict:
        cfg = self.cfg
        tcfg = cfg.training
        tracer = self.tracer
        chaos_sched = chaos.active()
        steps_per_epoch = len(train_ds)
        start_epoch = start // steps_per_epoch + 1
        skip = start % steps_per_epoch
        meters = {k: AverageMeter(k) for k in LOSS_KEYS}
        logged: dict[str, float] = {}
        cost_pending = cfg.obs.enabled and cfg.obs.cost_enabled and self.train_cost is None
        profile_at = start + self.profile_window[0]
        profiler = None
        # since_log weighs the meters; the timing (imgs/s, MFU) counts only
        # the steps of its window, which leaves out the counted step and a
        # profile window
        t_log, since_log, timed = time.perf_counter(), 0, 0
        done = max_steps is not None and self.global_step >= max_steps
        for epoch in range(start_epoch, tcfg.epochs + 1):
            if done:
                break
            for m in meters.values():
                m.reset()
            self._progress.update(epoch=epoch, global_step=self.global_step)
            epoch_iter, step_in_epoch = train_ds.epoch(epoch), 0
            if epoch == start_epoch and skip:
                # loaders are deterministic in (epoch, step): a mid-epoch
                # start skips the batches the run already trained on, on the
                # host, before they enter the pipeline
                epoch_iter, step_in_epoch = islice(epoch_iter, skip, None), skip
            batches = staged_batches(self._count_host_bytes(epoch_iter), self.device,
                                     cfg.data.num_workers, cfg.data.loader_retries,
                                     self._on_loader_retry)
            try:
                while True:
                    with tracer.span("data", cat="train"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    step_in_epoch += 1
                    if self.profile_window[1] and self.global_step == profile_at:
                        profiler = self._start_profile()
                    if chaos_sched is not None and chaos_sched.should(
                            "nan_loss", at=self.global_step + 1):
                        # poison through the real graph: NaN pixels make the
                        # loss and gradients non-finite as a corrupt shard would
                        logger.warning("chaos: poisoning step %d's batch with NaNs",
                                       self.global_step + 1)
                        batch = dict(batch)
                        batch["src_img"] = batch["src_img"] * float("nan")
                    counted = cost_pending
                    with tracer.span("step", cat="train", step=self.global_step + 1), \
                            self._deferring():
                        if counted:
                            cost_pending = False
                            loss_dict = self._counted_step(batch)
                        else:
                            loss_dict = self.step(batch)
                        # inside the region: a save deferred to its end vets
                        # this step's flag too
                        self.sentinel.observe(self.global_step, loss_dict["update_skipped"])
                    self._progress["global_step"] = self.global_step
                    if self.flight is not None:
                        self.flight.heartbeat(step=self.global_step)
                    if chaos_sched is not None:
                        if chaos_sched.should("preempt_exit", at=self.global_step):
                            raise PreemptedError(
                                f"chaos preempt_exit after step {self.global_step}")
                        if chaos_sched.should("sigusr2", at=self.global_step):
                            os.kill(os.getpid(), signal.SIGUSR2)
                        if chaos_sched.should("sigterm", at=self.global_step):
                            os.kill(os.getpid(), signal.SIGTERM)
                        if chaos_sched.should("host_kill", at=self.global_step):
                            # a host dying: no dump, no save; the survivors'
                            # watchdogs are what this proves
                            logger.warning("chaos: host_kill after step %d", self.global_step)
                            os.kill(os.getpid(), signal.SIGKILL)
                        if chaos_sched.should("host_stall", at=self.global_step):
                            # a wedged host: alive, no progress; every
                            # host's watchdog, this one's too, must abort
                            logger.warning("chaos: host_stall after step %d, sleeping until "
                                           "the watchdog aborts this process", self.global_step)
                            while True:
                                time.sleep(3600.0)
                    since_log += 1
                    if counted:
                        t_log, timed = time.perf_counter(), 0
                    else:
                        timed += 1
                    if profiler is not None and \
                            self.global_step == profile_at + self.profile_window[1]:
                        profiler, window = None, profiler
                        self._finish_profile(window)
                        t_log, timed = time.perf_counter(), 0
                    done = max_steps is not None and self.global_step >= max_steps
                    if step_in_epoch % tcfg.log_interval == 0 or done:
                        t_sync = time.perf_counter()
                        with tracer.span("sync", cat="train", step=self.global_step):
                            logged = _to_host(loss_dict)
                        sync_wait_ms = (time.perf_counter() - t_sync) * 1e3
                        self._last_sync_wait_ms = sync_wait_ms
                        self.obs_metrics.sync_wait_ms.set(sync_wait_ms,
                                                          process_index=str(self.rank))
                        with tracer.span("log", cat="train", step=self.global_step):
                            for k in LOSS_KEYS:
                                meters[k].update(logged[k], since_log)
                            interval = time.perf_counter() - t_log
                            rate = timed * self.global_batch / interval if timed else None
                            self._log(epoch, step_in_epoch, steps_per_epoch, logged, rate)
                            if timed:
                                self._publish_mfu(interval / timed)
                            if cfg.obs.enabled:
                                self.memlog.sample(step=self.global_step)
                                self._progress["hbm"] = self.memlog.last()
                            if self.multihost is not None:
                                self._beat(sync_wait_ms)
                        t_log, since_log, timed = time.perf_counter(), 0, 0
                        if tracer.enabled:
                            # after the log span closes, so that this
                            # interval's own sync/log phases are in it
                            self._publish_phases()
                        self.sentinel.check(logged["loss"], self.global_step)
                    if self.workspace and self.global_step % tcfg.checkpoint_interval == 0:
                        # resolve the pending flags first: a trip rolls back or
                        # aborts instead of blessing a suspect step
                        self.sentinel.flush(self.global_step)
                        with tracer.span("ckpt", cat="train", step=self.global_step), \
                                self._deferring():
                            self.save_checkpoint()
                            self._mark_last_good(self.global_step)
                        logger.info("checkpoint saved @ step %d", self.global_step)
                    if val_ds is not None and (self.global_step == FIRST_EVAL_STEP
                                               or self.global_step % tcfg.eval_interval == 0):
                        self.evaluate(val_ds)
                    # the step's boundary: its log, checkpoint and eval are done
                    self._preempt_boundary()
                    if done:
                        break
            finally:
                # a rollback or an error abandons the epoch: stop its threads
                batches.close()
                if profiler is not None:  # the window outlived the run
                    profiler.stop()
                    profiler = None
            if any(m.count for m in meters.values()):
                epoch_avg = {k: m.avg for k, m in meters.items()}
                logger.info("epoch [%03d] avg: loss=%.4f rgb_tgt=%.4f ssim_tgt=%.4f psnr=%.2f",
                            epoch, epoch_avg["loss"], epoch_avg["loss_rgb_tgt"],
                            epoch_avg["loss_ssim_tgt"], epoch_avg["psnr_tgt"])
                if self.writer is not None:
                    self.writer.scalars(epoch_avg, self.global_step, prefix="train_epoch/")
        self.sentinel.flush(self.global_step)
        if self.workspace:
            # a resumed run, or one that stopped on a checkpoint step, may
            # hold this step already
            with tracer.span("ckpt", cat="train", step=self.global_step), self._deferring():
                if not self._has_checkpoint(self.global_step):
                    self.save_checkpoint()
                self._mark_last_good(self.global_step)
        self._preempt_boundary()  # a request that came in after the last step
        if self.writer is not None:
            self.writer.flush()
        return logged

    def _beat(self, sync_wait_ms: float) -> None:
        """The heartbeat, on the log interval's sync; rank 0 also reads the
        straggler table and names a host two steps behind."""
        self.multihost.beat(self.global_step, data_bytes=self._host_bytes,
                            sync_wait_ms=sync_wait_ms)
        if self.is_main:
            table = self.multihost.stragglers()
            if table["suspect"] is not None and any(r["behind_steps"] >= 2
                                                    for r in table["rows"]):
                logger.warning("straggler: host %s is %.0f%% behind; table %s",
                               table["suspect"], 100.0 * table["skew_fraction"], table["rows"])

    def _count_host_bytes(self, epoch_iter: Iterable[dict]) -> Iterator[dict]:
        """The loader's batches, their bytes counted into
        mine_train_data_host_bytes_total (labeled by process_index) and the
        heartbeat's data_bytes. A delegating iterator, not a generator, so
        that a source's retry_safe_iter contract survives (data/pipeline.py)."""
        trainer, label = self, str(self.rank)

        class _Counting:
            retry_safe_iter = getattr(epoch_iter, "retry_safe_iter", False)

            def __init__(self):
                self._src = iter(epoch_iter)

            def __iter__(self):
                return self

            def __next__(self):
                batch = next(self._src)
                n = sum(int(getattr(v, "nbytes", 0)) for v in batch.values())
                trainer._host_bytes += n
                trainer.obs_metrics.data_host_bytes.inc(n, process_index=label)
                return batch

        return _Counting()

    def _on_loader_retry(self, attempt: int, exc: BaseException) -> None:
        self.obs_metrics.data_retries.inc(process_index=str(self.rank))
        logger.warning("loader retry %d after %s: %s", attempt, type(exc).__name__, exc)

    def _log(self, epoch: int, step_in_epoch: int, steps_per_epoch: int,
             losses: dict[str, float], imgs_per_sec: float | None) -> None:
        """One log interval: the log line, train_log.jsonl, the metric
        stream's train/ scalars and the gauges. imgs_per_sec is None when
        no timed step fell in the interval."""
        lrs = {g["name"]: g["lr"] for g in self.optimizer.param_groups}
        logger.info(
            "epoch [%03d] step [%d/%d] global_step=%d loss=%.4f grad_norm=%.4f %s imgs/s",
            epoch, step_in_epoch, steps_per_epoch, self.global_step, losses["loss"],
            losses["grad_norm"], "n/a" if imgs_per_sec is None else f"{imgs_per_sec:.2f}",
        )
        m = self.obs_metrics
        m.grad_norm.set(losses["grad_norm"])
        if imgs_per_sec is not None:
            m.imgs_per_sec.set(imgs_per_sec)
            self._progress["imgs_per_sec"] = imgs_per_sec
        if self.writer is not None:
            step = self.global_step
            self.writer.scalars({k: losses[k] for k in LOSS_KEYS}, step, prefix="train/")
            if imgs_per_sec is not None:
                self.writer.scalar("train/imgs_per_sec", imgs_per_sec, step)
            self.writer.scalar("train/backbone_lr", lrs["backbone"], step)
            self.writer.scalar("train/grad_norm", losses["grad_norm"], step)
        if self.workspace and self.is_main:
            os.makedirs(self.workspace, exist_ok=True)
            with open(os.path.join(self.workspace, "train_log.jsonl"), "a") as fh:
                fh.write(json.dumps({"epoch": epoch, "global_step": self.global_step,
                                     "imgs_per_sec": imgs_per_sec, "lr": lrs,
                                     **losses}) + "\n")
