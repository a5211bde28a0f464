"""Optimizer and LR schedule (counterpart of mine_tpu/training/optimizer.py).

Two parameter groups, `backbone` and `decoder` (the two halves of
MPINetwork), with their own learning rates. "adam" is torch's Adam with
`weight_decay` as L2 added to the gradient before the moments, which is
optax's add_decayed_weights before scale_by_adam (b1, b2 and eps at the
defaults both share); "sgd" is L2 plus the learning rate, no momentum. The
MultiStep schedule multiplies both rates by `decay_gamma` at each epoch of
`lr.decay_steps`, counted in updates as epoch * steps_per_epoch: update k
(from 0) runs at base * gamma ** #{boundaries <= k}, as optax's
piecewise_constant_schedule.
"""

from __future__ import annotations

import torch
from torch import nn

from mine_tpu_torch.config import Config

GROUPS = ("backbone", "decoder")


def lr_factor(cfg: Config, steps_per_epoch: int, step: int) -> float:
    """The schedule's multiplier for update `step` (counted from 0)."""
    factor = 1.0
    for epoch in cfg.lr.decay_steps:
        if step >= int(epoch) * steps_per_epoch:
            factor *= cfg.lr.decay_gamma
    return factor


def make_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int):
    """(optimizer, scheduler) for `model`'s two groups; call
    scheduler.step() after every optimizer.step()."""
    groups = []
    for name in GROUPS:
        params = list(getattr(model, name).parameters())
        groups.append({"params": params, "lr": getattr(cfg.lr, f"{name}_lr"), "name": name})
    if cfg.training.optimizer == "adam":
        opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=cfg.lr.weight_decay)
    elif cfg.training.optimizer == "sgd":
        opt = torch.optim.SGD(groups, momentum=0.0, weight_decay=cfg.lr.weight_decay)
    else:
        raise ValueError(f"training.optimizer={cfg.training.optimizer!r} (known: adam, sgd)")
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: lr_factor(cfg, steps_per_epoch, step)
    )
    return opt, sched
