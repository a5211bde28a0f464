"""Disparity-conditioned MPI decoder (counterpart of
mine_tpu/models/decoder.py), with the reference DepthDecoder's module names:
conv_down1/2, conv_up1/2 and convs.<tuple_to_str(key)>, the keys the
reference MINE checkpoints carry.

Every skip feature gets the positional encoding of each plane's disparity
concatenated on ([feature, embedding]), and the batch becomes the b-major
B*S plane batch, so one decoder pass produces all planes.

With `remat`, the encoder extension and each up-stage (with its MPI head)
run under a non-reentrant activation checkpoint: the backward recomputes one
stage at a time instead of keeping every stage's activations (the JAX
package checkpoints the whole network apply; the numbers are the same, only
what is kept differs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mine_tpu_torch.models.embedder import embed_dim, positional_encode
from mine_tpu_torch.models.norm import BatchNorm2d, checkpoint_contexts


def run_checkpointed(remat: bool, fn, *args):
    """fn(*args); with `remat` (and autograd recording) under a non-reentrant
    checkpoint whose recompute leaves the BatchNorm statistics alone. Nothing
    inside draws random numbers (the dropout mask comes in as an argument),
    so no RNG state is stashed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=checkpoint_contexts)
    return fn(*args)

NUM_CH_DEC = (16, 32, 64, 128, 256)


def tuple_to_str(key: tuple) -> str:
    """The reference ModuleDict key codec: '-'.join over str(tuple)."""
    return "-".join(str(key))


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


# CUDA's reflection pad indexes in 32 bits
_MAX_PAD_ELEMENTS = 2**31 - 1


class Conv3x3(nn.Module):
    """Reflection-pad 3x3 conv with bias. A plane batch whose padded tensor
    would pass 2^31 elements (the 768x1024, S=128 recipe's scale-1 skip
    concat) is padded and convolved in slices along the batch: both ops are
    per sample."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        per_sample = c * (h + 2) * (w + 2)
        if n * per_sample <= _MAX_PAD_ELEMENTS:
            return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        step = max(1, _MAX_PAD_ELEMENTS // per_sample)
        return torch.cat([self.conv(F.pad(part, (1, 1, 1, 1), mode="reflect"))
                          for part in x.split(step)])


class ConvBlock(nn.Module):
    """Conv3x3 -> BN -> ELU."""

    def __init__(self, c_in: int, c_out: int, group=None):
        super().__init__()
        self.conv = Conv3x3(c_in, c_out)
        self.bn = BatchNorm2d(c_out, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.bn(self.conv(x)))


def _conv_bn_leaky(c_in: int, c_out: int, kernel: int, group=None) -> nn.Sequential:
    """k x k zero-padded conv (no bias) -> BN -> LeakyReLU(0.1)."""
    return nn.Sequential(
        nn.Conv2d(c_in, c_out, kernel, padding=(kernel - 1) // 2, bias=False),
        BatchNorm2d(c_out, group),
        nn.LeakyReLU(0.1),
    )


class MPIDecoder(nn.Module):
    """features (5 x NCHW) + disparity (B, S) -> {scale: (B, S, h, w, 4)}
    fp32 rgb + sigma MPIs.

    Sigma dropout (mpi.sigma_dropout_rate = p, train mode only): each output
    scale's sigma is multiplied by a per-(b, s) plane keep mask and scaled by
    1 / (1 - p). The caller draws the masks, `sigma_keep` (len(scales), B, S)
    in the order of `scales`, so that the draw comes from its own generator
    and a recompute sees the same mask.

    BatchNorm statistics (train mode) sync over process groups as the JAX
    decoder's axes: the encoder extension, which sees the batch's /32
    feature, over `batch_group` (the batch replicas); the up-stages, whose
    batch is B*S with the planes split over the plane axis, over
    `stage_group` (batch replicas x plane)."""

    def __init__(self, num_ch_enc: tuple[int, ...], multires: int = 10,
                 use_alpha: bool = False, scales: tuple[int, ...] = (0, 1, 2, 3),
                 width_multiple: int = 1, sigma_dropout_rate: float = 0.0,
                 batch_group=None, stage_group=None):
        super().__init__()
        self.multires = multires
        self.use_alpha = use_alpha
        self.scales = tuple(scales)
        self.sigma_dropout_rate = float(sigma_dropout_rate)
        e = embed_dim(multires)
        m = max(width_multiple, 1)
        dec = [-(-c // m) * m for c in NUM_CH_DEC]
        top = num_ch_enc[-1]
        self.conv_down1 = _conv_bn_leaky(top, 512, 1, batch_group)
        self.conv_down2 = _conv_bn_leaky(512, 256, 3, batch_group)
        self.conv_up1 = _conv_bn_leaky(256, 256, 3, batch_group)
        self.conv_up2 = _conv_bn_leaky(256, top, 1, batch_group)
        self.pool = nn.MaxPool2d(3, 2, 1)
        convs = {}
        for i in range(4, -1, -1):
            c_in = top + e if i == 4 else dec[i + 1]
            convs[tuple_to_str(("upconv", i, 0))] = ConvBlock(c_in, dec[i], stage_group)
            c_in = dec[i] + (num_ch_enc[i - 1] + e if i > 0 else 0)
            convs[tuple_to_str(("upconv", i, 1))] = ConvBlock(c_in, dec[i], stage_group)
        for s in self.scales:
            convs[tuple_to_str(("dispconv", s))] = Conv3x3(dec[s], 4)
        self.convs = nn.ModuleDict(convs)

    def forward(self, features: list[torch.Tensor], disparity: torch.Tensor,
                sigma_keep: torch.Tensor | None = None,
                remat: bool = False) -> dict[int, torch.Tensor]:
        b, s = disparity.shape
        dropout = self.training and self.sigma_dropout_rate > 0.0
        if dropout and (sigma_keep is None or sigma_keep.shape != (len(self.scales), b, s)):
            raise ValueError(
                f"sigma dropout in train mode needs sigma_keep of shape "
                f"{(len(self.scales), b, s)}, got "
                f"{None if sigma_keep is None else tuple(sigma_keep.shape)}"
            )
        embed = positional_encode(disparity.reshape(b * s, 1), self.multires)
        x = run_checkpointed(remat, self._extension, features[-1])
        outputs: dict[int, torch.Tensor] = {}
        for i in range(4, -1, -1):
            keep = sigma_keep[self.scales.index(i)] if dropout and i in self.scales else None
            x, mpi = run_checkpointed(remat, self._stage, i, x,
                                      features[i - 1] if i > 0 else None, embed, keep, b)
            if mpi is not None:
                outputs[i] = mpi
        return outputs

    def _extension(self, top: torch.Tensor) -> torch.Tensor:
        """The encoder extension: pool, pool, up, up over the /32 feature."""
        x = self.conv_down1(self.pool(top))
        x = self.conv_down2(self.pool(x))
        x = self.conv_up1(nearest_up2(x))
        return self.conv_up2(nearest_up2(x))

    @staticmethod
    def _plane_batch(feat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        """(B, C, h, w) -> (B*S, C+E, h, w), b-major; embed is (B*S, E)."""
        b, c, h, w = feat.shape
        s = embed.shape[0] // b
        tiled = feat[:, None].expand(b, s, c, h, w).reshape(b * s, c, h, w)
        e = embed[:, :, None, None].expand(b * s, embed.shape[1], h, w)
        return torch.cat([tiled, e.to(tiled.dtype)], dim=1)

    def _stage(self, i: int, x: torch.Tensor, skip: torch.Tensor | None,
               embed: torch.Tensor, keep: torch.Tensor | None, b: int):
        """Up-stage i of a batch of b images: (x, this scale's MPI or None).
        The stage-4 input and the skip are tiled over the planes here, inside
        the stage; keep (B, S) is this scale's sigma keep mask, or None."""
        if i == 4:
            x = self._plane_batch(x, embed)
        x = nearest_up2(self.convs[tuple_to_str(("upconv", i, 0))](x))
        if skip is not None:
            x = torch.cat([x, self._plane_batch(skip, embed)], dim=1)
        x = self.convs[tuple_to_str(("upconv", i, 1))](x)
        if i not in self.scales:
            return x, None
        raw = self.convs[tuple_to_str(("dispconv", i))](x)
        # the MPI is fp32 under bf16 autocast; a float64 model keeps float64
        raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
        _, _, h, w = raw.shape
        mpi = raw.reshape(b, -1, 4, h, w).permute(0, 1, 3, 4, 2)
        rgb = torch.sigmoid(mpi[..., 0:3])
        if self.use_alpha:
            sigma = torch.sigmoid(mpi[..., 3:4])
        else:
            sigma = torch.abs(mpi[..., 3:4]) + 1.0e-4
        if keep is not None:
            sigma = sigma * keep[:, :, None, None, None].to(sigma.dtype) \
                / (1.0 - self.sigma_dropout_rate)
        return x, torch.cat([rgb, sigma], dim=-1)
