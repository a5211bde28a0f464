"""BatchNorm with the JAX package's train-mode semantics (counterpart of
mine_tpu/models/norm.py::SyncBatchNorm, flax BatchNorm with its axis_name).

flax's BatchNorm, as the JAX package configures it: momentum 0.9 in flax's
terms (0.1 in torch's), eps 1e-5, normalisation by the biased batch
variance, and the running variance updated with that same BIASED variance.
nn.BatchNorm2d updates it with the unbiased one, n/(n-1) larger, n being the
N*H*W values per channel. The train-mode forward here is torch's fused batch
norm; the running variance it wrote is then corrected to the biased update:
new = (1-m) old + m var_b, from torch's (1-m) old + m var_b n/(n-1).
Parameter and buffer names are nn.BatchNorm2d's.

With a process `group` the train-mode statistics are the group's: each rank
all-reduces its per-channel count and sum, then the sum of squared
deviations from the global mean, and every rank normalises its own rows by
the global mean and biased variance, in fp32 at least. flax pools the mean
and the mean square (var = E[x^2] - E[x]^2); the port centres first,
because with few values a channel (two at the decoder extension's 1x1 maps
of a batch of 2) that difference cancels and moved an fp32 step's gradient
norm 2e-4 away from the one-process step's. Both all-reduces carry the
gradient (their backward sums the cotangents over the group, as flax's
pmean inside autodiff does), and the running statistics update with the
global biased variance. nn.SyncBatchNorm would update them with the
unbiased one. Eval mode emits no collective.

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
    def __init__(self, num_features: int, group=None):
        super().__init__(num_features, eps=1.0e-5, momentum=0.1)
        # not a module attribute torch knows: the state dict is unchanged
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._synced(x)
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

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        from mine_tpu_torch.parallel.comm import all_reduce_sum

        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = (1, c, 1, 1)
        count = xf.new_full((1,), x.numel() // c)
        stats = all_reduce_sum(torch.cat([count, xf.sum(dim=(0, 2, 3))]), self.group)
        n, mean = stats[0], stats[1:] / stats[0]
        centered = xf - mean.view(shape)
        var = all_reduce_sum((centered * centered).sum(dim=(0, 2, 3)), self.group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        out = centered * scale.view(shape) + self.bias.to(xf.dtype).view(shape)
        if not _STATS_FROZEN.get():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1.0 - m).add_(m * var.to(self.running_var.dtype))
                self.num_batches_tracked.add_(1)
        return out.to(x.dtype)
