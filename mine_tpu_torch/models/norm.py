"""BatchNorm with the JAX package's train-mode semantics (counterpart of
mine_tpu/models/norm.py::SyncBatchNorm without the cross-replica axis).

flax's BatchNorm, as the JAX package configures it: momentum 0.9 in flax's
terms (0.1 in torch's), eps 1e-5, normalisation by the biased batch
variance, and the running variance updated with that same BIASED variance.
nn.BatchNorm2d updates it with the unbiased one, n/(n-1) larger, n being the
N*H*W values per channel. The train-mode forward here is torch's fused batch
norm; the running variance it wrote is then corrected to the biased update:
new = (1-m) old + m var_b, from torch's (1-m) old + m var_b n/(n-1).
Parameter and buffer names are nn.BatchNorm2d's.

Under activation recompute (torch.utils.checkpoint, model.remat_decoder) a
train-mode forward runs twice per step. `checkpoint_contexts` is the
checkpoint's context_fn: inside the recompute the statistics stay as the
first forward left them, so they move exactly once a step. The output does
not depend on them in train mode (the batch's own moments normalise).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

# set inside a checkpoint's recompute, per thread of execution
_STATS_FROZEN = contextvars.ContextVar("mine_tpu_torch_bn_stats_frozen", default=False)


@contextlib.contextmanager
def _frozen_statistics():
    token = _STATS_FROZEN.set(True)
    try:
        yield
    finally:
        _STATS_FROZEN.reset(token)


def checkpoint_contexts():
    """context_fn for a non-reentrant torch.utils.checkpoint: the forward as
    usual, the recompute with the running statistics left alone."""
    return contextlib.nullcontext(), _frozen_statistics()


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1.0e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        # the fused kernel updates copies: autograd keeps the statistics it
        # was given for the backward, so the buffers must not change under
        # it. torch.batch_norm, unlike F.batch_norm, also takes one value
        # per channel (flax does: the variance is 0, the output the shift)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = torch.batch_norm(x, self.weight, self.bias, mean, var, True, self.momentum,
                               self.eps, torch.backends.cudnn.enabled)
        if _STATS_FROZEN.get():
            return out
        with torch.no_grad():
            keep = (1.0 - self.momentum) * self.running_var
            if n > 1:
                keep = keep + (var - keep) * ((n - 1) / n)
            self.running_var.copy_(keep)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return out
