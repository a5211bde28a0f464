"""The training loop (counterpart of mine_tpu/training/loop.py on one
device): epochs of train steps, the MultiStep schedule stepped per update,
the loss dict logged every `training.log_interval` steps, checkpoints every
`training.checkpoint_interval` steps and at the end (each marked last-good
once the sentinel has vetted it), eval over the val set every
`training.eval_interval` steps and at the reference's first eval step 2000,
auto-resume from the workspace (`training.resume_from`: latest | last_good),
a warm start from a converted .npz, the sentinel's rollback loop, and an
emergency checkpoint when a run dies (never masking the error), and a
torch.profiler trace of the first `profile_steps` steps. Batches come through
`staged_batches`: built `data.num_workers` ahead on a host thread, in
page-locked memory, with `data.loader_retries` retries. The rest of
observability, the flight recorder, the preemption guard and the multi-host
layers are not ported (ROADMAP queue 1).
"""

from __future__ import annotations

import json
import logging
import os
import time
from itertools import islice
from typing import Any, Callable, Iterable, Iterator, Mapping

import torch

from mine_tpu_torch.config import Config, unsupported_training_options
from mine_tpu_torch.data.pipeline import prefetch
from mine_tpu_torch.losses.lpips import load_lpips_params
from mine_tpu_torch.models.convert import load_npz_subtrees
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.resilience.sentinel import SentinelAbort, SentinelRollback, TrainingSentinel
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.training.optimizer import make_optimizer
from mine_tpu_torch.training.step import (
    batch_to_device,
    build_model,
    eval_step,
    pin_batch,
    train_step,
)
from mine_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mine_tpu_torch")

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
    does a CPU device (nothing to pin). Close the returned generator when
    abandoning it early: its producer thread then stops."""
    pin = pin_batch if num_workers > 0 and device.type == "cuda" else None
    return prefetch(epoch_iter, num_workers, transfer=pin, retries=retries, on_retry=on_retry)


def _to_host(values: Mapping[str, torch.Tensor]) -> dict[str, float]:
    """Device scalars -> floats in one transfer."""
    keys = list(values)
    host = torch.stack([values[k].detach().reshape(()).double() for k in keys]).cpu().tolist()
    return dict(zip(keys, host))


def run_evaluation(cfg: Config, model: torch.nn.Module, val_ds: Any,
                   device: torch.device, lpips_params: dict | None = None,
                   global_step: int = 0) -> dict[str, float]:
    """The metric pass over the whole val set (epoch 0), shared by the
    train loop and `python -m mine_tpu_torch.evaluate`: every LOSS_KEYS
    value averaged over the genuine examples (each batch weighted by its
    eval_examples), plus "eval_examples", their count, which must equal the
    dataset's num_eval_examples when it declares one. Disparities come from
    a generator seeded training.seed + 17. Batches are staged as in training
    (staged_batches, data.num_workers ahead, no retries)."""
    meters = {k: AverageMeter(k) for k in LOSS_KEYS}
    generator = torch.Generator().manual_seed(cfg.training.seed + 17)
    n_examples = 0
    batches = staged_batches(val_ds.epoch(0), torch.device(device), cfg.data.num_workers)
    try:
        for batch in batches:
            loss_dict, _ = eval_step(cfg, model, batch_to_device(batch, device), generator,
                                     lpips_params)
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
    return result


class Trainer:
    """One model, its optimizer, schedule and generators on one device.

    Weights are `state_dict` when given, else seeded random weights
    (training.seed); a workspace checkpoint or an .npz warm start replaces
    them in fit(). The stratified disparities and the sigma dropout masks
    come from two CPU generators seeded from training.seed. Runs on CUDA
    unless `device="cpu"` is asked for. Options the port does not honour
    yet raise here.
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
        self.device = resolve_device(device)
        self.sentinel = TrainingSentinel(cfg.resilience, logger)
        model = build_model(cfg)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(cfg.training.seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        self.generator = torch.Generator().manual_seed(cfg.training.seed)
        self.dropout_generator = torch.Generator().manual_seed(cfg.training.seed + 1)
        self.batch_size = cfg.data.per_gpu_batch_size
        self.global_step = 0
        self.optimizer = self.scheduler = None
        self.lpips_params = load_lpips_params(cfg.training.lpips_weights_path, self.device)
        # (global_step, result) of every eval this trainer ran
        self.evals: list[tuple[int, dict[str, float]]] = []
        # trace the first `profile_steps` steps of fit() (needs a workspace)
        self.profile_steps = profile_steps if workspace else 0
        if workspace:
            ckpt.save_paired_config(cfg, workspace)

    # -- state ----------------------------------------------------------------

    def state(self) -> dict[str, Any]:
        """The training state a checkpoint holds."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "global_step": self.global_step,
            "generators": {"disparity": self.generator.get_state(),
                           "dropout": self.dropout_generator.get_state()},
        }

    def load_state(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.global_step = int(state["global_step"])
        self.generator.set_state(state["generators"]["disparity"])
        self.dropout_generator.set_state(state["generators"]["dropout"])

    def save_checkpoint(self) -> None:
        cfg = self.cfg.training
        ckpt.save(self.workspace, self.state(), self.global_step,
                  keep_period=max(cfg.eval_interval // cfg.checkpoint_interval, 1))

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
        if cfg.training.pretrained_checkpoint_path:
            # backbone + decoder from a converted MINE checkpoint; the
            # optimizer, schedule and step start fresh
            self._warm_start(cfg.training.pretrained_checkpoint_path,
                             tuple(cfg.training.pretrained_subtrees))
        elif cfg.model.imagenet_pretrained and cfg.model.pretrained_backbone_path:
            self._warm_start(cfg.model.pretrained_backbone_path, ("backbone",))
        return 0

    # -- steps ----------------------------------------------------------------

    def step(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """One update on a loader batch (numpy arrays); returns the detached
        loss dict, still on the device. A step that raises leaves the
        generators where they were."""
        if self.optimizer is None:
            raise RuntimeError("Trainer.step before fit(): the optimizer needs the epoch length")
        states = self.generator.get_state(), self.dropout_generator.get_state()
        try:
            out = train_step(self.cfg, self.model, self.optimizer, self.scheduler,
                             batch_to_device(batch, self.device), self.generator,
                             self.dropout_generator)
        except BaseException:
            self.generator.set_state(states[0])
            self.dropout_generator.set_state(states[1])
            raise
        self.global_step += 1
        return out

    def evaluate(self, val_ds: Any) -> dict[str, float]:
        """run_evaluation at the current weights; the model returns to train
        mode after it."""
        try:
            result = run_evaluation(self.cfg, self.model, val_ds, self.device,
                                    self.lpips_params, self.global_step)
        finally:
            self.model.train()
        self.evals.append((self.global_step, result))
        if self.workspace:
            with open(os.path.join(self.workspace, "eval_log.jsonl"), "a") as fh:
                fh.write(json.dumps({"global_step": self.global_step, **result}) + "\n")
        return result

    # -- the loop -------------------------------------------------------------

    def fit(self, train_ds: Any, val_ds: Any | None = None,
            max_steps: int | None = None) -> dict[str, float]:
        """Train for training.epochs epochs of len(train_ds) steps (or stop
        once `max_steps` updates are done in all), resuming from the
        workspace when it holds a checkpoint. Returns the last logged loss
        dict as floats; eval results are in `self.evals`."""
        steps_per_epoch = len(train_ds)
        start = self._start(steps_per_epoch)
        try:
            return self._fit_epochs(train_ds, val_ds, start, max_steps)
        except (KeyboardInterrupt, Exception):
            # persist the last completed step so that the next run resumes;
            # a failing save must not mask the original error
            try:
                if self.workspace and self.global_step not in ckpt.all_steps(self.workspace):
                    logger.exception("training interrupted at step %d; writing an emergency "
                                     "checkpoint", self.global_step)
                    self.save_checkpoint()
            except BaseException:  # noqa: BLE001 - incl. a second interrupt
                logger.exception("emergency checkpoint failed")
            raise

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
        steps_per_epoch = len(train_ds)
        start_epoch = start // steps_per_epoch + 1
        skip = start % steps_per_epoch
        meters = {k: AverageMeter(k) for k in LOSS_KEYS}
        logged: dict[str, float] = {}
        t_log, since_log = time.perf_counter(), 0
        done = max_steps is not None and self.global_step >= max_steps
        for epoch in range(start_epoch, tcfg.epochs + 1):
            if done:
                break
            for m in meters.values():
                m.reset()
            epoch_iter, step_in_epoch = train_ds.epoch(epoch), 0
            if epoch == start_epoch and skip:
                # loaders are deterministic in (epoch, step): a mid-epoch
                # start skips the batches the run already trained on, on the
                # host, before they enter the pipeline
                epoch_iter, step_in_epoch = islice(epoch_iter, skip, None), skip
            batches = staged_batches(epoch_iter, self.device, cfg.data.num_workers,
                                     cfg.data.loader_retries, self._on_loader_retry)
            try:
                for batch in batches:
                    step_in_epoch += 1
                    if self.global_step == start and self.profile_steps:
                        activities = [torch.profiler.ProfilerActivity.CPU]
                        if self.device.type == "cuda":
                            activities.append(torch.profiler.ProfilerActivity.CUDA)
                        profiler = torch.profiler.profile(activities=activities)
                        profiler.start()
                    loss_dict = self.step(batch)
                    if self.global_step == start + self.profile_steps and self.profile_steps:
                        profiler.stop()
                        path = os.path.join(self.workspace, "profile", "train_steps.trace.json")
                        os.makedirs(os.path.dirname(path), exist_ok=True)
                        profiler.export_chrome_trace(path)
                        logger.info("profile trace of %d steps written to %s",
                                    self.profile_steps, path)
                    self.sentinel.observe(self.global_step, loss_dict["update_skipped"])
                    since_log += 1
                    done = max_steps is not None and self.global_step >= max_steps
                    if step_in_epoch % tcfg.log_interval == 0 or done:
                        logged = _to_host(loss_dict)
                        for k in LOSS_KEYS:
                            meters[k].update(logged[k], since_log)
                        rate = since_log * self.batch_size / (time.perf_counter() - t_log)
                        self._log(epoch, step_in_epoch, steps_per_epoch, logged, rate)
                        t_log, since_log = time.perf_counter(), 0
                        self.sentinel.check(logged["loss"], self.global_step)
                    if self.workspace and self.global_step % tcfg.checkpoint_interval == 0:
                        # resolve the pending flags first: a trip rolls back or
                        # aborts instead of blessing a suspect step
                        self.sentinel.flush(self.global_step)
                        self.save_checkpoint()
                        ckpt.mark_last_good(self.workspace, self.global_step)
                        logger.info("checkpoint saved @ step %d", self.global_step)
                    if val_ds is not None and (self.global_step == FIRST_EVAL_STEP
                                               or self.global_step % tcfg.eval_interval == 0):
                        self.evaluate(val_ds)
                    if done:
                        break
            finally:
                # a rollback or an error abandons the epoch: stop its threads
                batches.close()
            if any(m.count for m in meters.values()):
                logger.info("epoch [%03d] avg: loss=%.4f rgb_tgt=%.4f ssim_tgt=%.4f psnr=%.2f",
                            epoch, meters["loss"].avg, meters["loss_rgb_tgt"].avg,
                            meters["loss_ssim_tgt"].avg, meters["psnr_tgt"].avg)
        self.sentinel.flush(self.global_step)
        if self.workspace:
            # a resumed run, or one that stopped on a checkpoint step, may
            # hold this step already
            if self.global_step not in ckpt.all_steps(self.workspace):
                self.save_checkpoint()
            ckpt.mark_last_good(self.workspace, self.global_step)
        return logged

    def _on_loader_retry(self, attempt: int, exc: BaseException) -> None:
        logger.warning("loader retry %d after %s: %s", attempt, type(exc).__name__, exc)

    def _log(self, epoch: int, step_in_epoch: int, steps_per_epoch: int,
             losses: dict[str, float], imgs_per_sec: float) -> None:
        lrs = {g["name"]: g["lr"] for g in self.optimizer.param_groups}
        logger.info(
            "epoch [%03d] step [%d/%d] global_step=%d loss=%.4f grad_norm=%.4f "
            "%.2f imgs/s", epoch, step_in_epoch, steps_per_epoch, self.global_step,
            losses["loss"], losses["grad_norm"], imgs_per_sec,
        )
        if self.workspace:
            os.makedirs(self.workspace, exist_ok=True)
            with open(os.path.join(self.workspace, "train_log.jsonl"), "a") as fh:
                fh.write(json.dumps({"epoch": epoch, "global_step": self.global_step,
                                     "imgs_per_sec": imgs_per_sec, "lr": lrs,
                                     **losses}) + "\n")
