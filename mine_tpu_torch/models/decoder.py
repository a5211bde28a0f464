"""Disparity-conditioned MPI decoder (counterpart of
mine_tpu/models/decoder.py), with the reference DepthDecoder's module names:
conv_down1/2, conv_up1/2 and convs.<tuple_to_str(key)>, the keys the
reference MINE checkpoints carry.

Every skip feature gets the positional encoding of each plane's disparity
concatenated on ([feature, embedding]), and the batch becomes the b-major
B*S plane batch, so one decoder pass produces all planes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mine_tpu_torch.models.embedder import embed_dim, positional_encode
from mine_tpu_torch.models.norm import BatchNorm2d

NUM_CH_DEC = (16, 32, 64, 128, 256)


def tuple_to_str(key: tuple) -> str:
    """The reference ModuleDict key codec: '-'.join over str(tuple)."""
    return "-".join(str(key))


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Conv3x3(nn.Module):
    """Reflection-pad 3x3 conv with bias."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """Conv3x3 -> BN -> ELU."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = Conv3x3(c_in, c_out)
        self.bn = BatchNorm2d(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.bn(self.conv(x)))


def _conv_bn_leaky(c_in: int, c_out: int, kernel: int) -> nn.Sequential:
    """k x k zero-padded conv (no bias) -> BN -> LeakyReLU(0.1)."""
    return nn.Sequential(
        nn.Conv2d(c_in, c_out, kernel, padding=(kernel - 1) // 2, bias=False),
        BatchNorm2d(c_out),
        nn.LeakyReLU(0.1),
    )


class MPIDecoder(nn.Module):
    """features (5 x NCHW) + disparity (B, S) -> {scale: (B, S, h, w, 4)}
    fp32 rgb + sigma MPIs."""

    def __init__(self, num_ch_enc: tuple[int, ...], multires: int = 10,
                 use_alpha: bool = False, scales: tuple[int, ...] = (0, 1, 2, 3),
                 width_multiple: int = 1):
        super().__init__()
        self.multires = multires
        self.use_alpha = use_alpha
        self.scales = tuple(scales)
        e = embed_dim(multires)
        m = max(width_multiple, 1)
        dec = [-(-c // m) * m for c in NUM_CH_DEC]
        top = num_ch_enc[-1]
        self.conv_down1 = _conv_bn_leaky(top, 512, 1)
        self.conv_down2 = _conv_bn_leaky(512, 256, 3)
        self.conv_up1 = _conv_bn_leaky(256, 256, 3)
        self.conv_up2 = _conv_bn_leaky(256, top, 1)
        self.pool = nn.MaxPool2d(3, 2, 1)
        convs = {}
        for i in range(4, -1, -1):
            c_in = top + e if i == 4 else dec[i + 1]
            convs[tuple_to_str(("upconv", i, 0))] = ConvBlock(c_in, dec[i])
            c_in = dec[i] + (num_ch_enc[i - 1] + e if i > 0 else 0)
            convs[tuple_to_str(("upconv", i, 1))] = ConvBlock(c_in, dec[i])
        for s in self.scales:
            convs[tuple_to_str(("dispconv", s))] = Conv3x3(dec[s], 4)
        self.convs = nn.ModuleDict(convs)

    def forward(self, features: list[torch.Tensor],
                disparity: torch.Tensor) -> dict[int, torch.Tensor]:
        b, s = disparity.shape
        embed = positional_encode(disparity.reshape(b * s, 1), self.multires)

        x = self.conv_down1(self.pool(features[-1]))
        x = self.conv_down2(self.pool(x))
        x = self.conv_up1(nearest_up2(x))
        x = self.conv_up2(nearest_up2(x))

        def to_plane_batch(feat: torch.Tensor) -> torch.Tensor:
            """(B, C, h, w) -> (B*S, C+E, h, w), b-major."""
            _, c, h, w = feat.shape
            tiled = feat[:, None].expand(b, s, c, h, w).reshape(b * s, c, h, w)
            e = embed[:, :, None, None].expand(b * s, embed.shape[1], h, w)
            return torch.cat([tiled, e.to(tiled.dtype)], dim=1)

        skips = [to_plane_batch(f) for f in features[:-1]]
        x = to_plane_batch(x)
        outputs: dict[int, torch.Tensor] = {}
        for i in range(4, -1, -1):
            x = nearest_up2(self.convs[tuple_to_str(("upconv", i, 0))](x))
            if i > 0:
                x = torch.cat([x, skips[i - 1]], dim=1)
            x = self.convs[tuple_to_str(("upconv", i, 1))](x)
            if i in self.scales:
                raw = self.convs[tuple_to_str(("dispconv", i))](x)
                # the MPI is fp32 under bf16 autocast; a float64 model keeps float64
                raw = raw.to(torch.promote_types(raw.dtype, torch.float32))
                h, w = raw.shape[2], raw.shape[3]
                mpi = raw.reshape(b, s, 4, h, w).permute(0, 1, 3, 4, 2)
                rgb = torch.sigmoid(mpi[..., 0:3])
                if self.use_alpha:
                    sigma = torch.sigmoid(mpi[..., 3:4])
                else:
                    sigma = torch.abs(mpi[..., 3:4]) + 1.0e-4
                outputs[i] = torch.cat([rgb, sigma], dim=-1)
        return outputs
