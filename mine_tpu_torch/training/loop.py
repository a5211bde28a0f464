"""The training loop (counterpart of the core of
mine_tpu/training/loop.py::Trainer.fit): epochs of train steps on one
device, the MultiStep schedule stepped per update, and the loss dict logged
every `training.log_interval` steps. Checkpoints, eval, obs and resilience
are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping

import torch

from mine_tpu_torch.config import Config, unsupported_training_options
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.training.optimizer import make_optimizer
from mine_tpu_torch.training.step import batch_to_device, build_model, train_step
from mine_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mine_tpu_torch")


class Trainer:
    """One model, its optimizer and its disparity generator on one device.

    Weights are `state_dict` when given, else seeded random weights
    (training.seed). The stratified disparities come from a CPU generator
    seeded with training.seed. Runs on CUDA unless `device="cpu"` is asked
    for. Options the port does not honour yet raise here.
    """

    def __init__(self, cfg: Config, workspace: str | None = None,
                 device: str | torch.device | None = None,
                 state_dict: Mapping[str, torch.Tensor] | None = None):
        problems = unsupported_training_options(cfg)
        if problems:
            raise NotImplementedError("; ".join(problems))
        self.cfg = cfg
        self.workspace = workspace
        self.device = resolve_device(device)
        model = build_model(cfg)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(cfg.training.seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        self.generator = torch.Generator().manual_seed(cfg.training.seed)
        self.batch_size = cfg.data.per_gpu_batch_size
        self.global_step = 0
        self.optimizer = self.scheduler = None

    def step(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """One update on a loader batch (numpy arrays); returns the detached
        loss dict, still on the device."""
        if self.optimizer is None:
            raise RuntimeError("Trainer.step before fit(): the optimizer needs the epoch length")
        out = train_step(self.cfg, self.model, self.optimizer, self.scheduler,
                         batch_to_device(batch, self.device), self.generator)
        self.global_step += 1
        return out

    def fit(self, train_ds: Any, max_steps: int | None = None) -> dict[str, float]:
        """Train for training.epochs epochs of len(train_ds) steps (or stop
        after `max_steps` updates in all). Returns the last logged loss dict
        as floats."""
        cfg = self.cfg
        steps_per_epoch = len(train_ds)
        if self.optimizer is None:
            self.optimizer, self.scheduler = make_optimizer(cfg, self.model, steps_per_epoch)
        logged: dict[str, float] = {}
        t_log, since_log = time.perf_counter(), 0
        for epoch in range(1, cfg.training.epochs + 1):
            for step_in_epoch, batch in enumerate(train_ds.epoch(epoch), start=1):
                loss_dict = self.step(batch)
                since_log += 1
                done = max_steps is not None and self.global_step >= max_steps
                if step_in_epoch % cfg.training.log_interval == 0 or done:
                    logged = {k: float(v) for k, v in loss_dict.items()}
                    rate = since_log * self.batch_size / (time.perf_counter() - t_log)
                    self._log(epoch, step_in_epoch, steps_per_epoch, logged, rate)
                    t_log, since_log = time.perf_counter(), 0
                if done:
                    return logged
        return logged

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
