"""ResNet pyramid encoder (counterpart of mine_tpu/models/encoder.py).

torchvision's module names (conv1, bn1, layer{k}.{b}.conv{c}/bn{c},
downsample.{0,1}) nested under `encoder.`, the layout of the reference MINE
checkpoints. ImageNet normalisation runs inline on the [0, 1] input;
BatchNorm (models/norm.py) has the JAX package's semantics, its train-mode
statistics synced over `group` when one is given (the batch replicas).
Returns the 5-feature pyramid at strides 2/4/8/16/32, NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from mine_tpu_torch.models.norm import BatchNorm2d

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
BOTTLENECK = {50}


def encoder_channels(num_layers: int) -> tuple[int, ...]:
    base = (64, 64, 128, 256, 512)
    if num_layers in BOTTLENECK:
        return (base[0],) + tuple(c * 4 for c in base[1:])
    return base


def _downsample(c_in: int, c_out: int, stride: int, group=None) -> nn.Sequential | None:
    if stride == 1 and c_in == c_out:
        return None
    return nn.Sequential(
        nn.Conv2d(c_in, c_out, 1, stride, bias=False), BatchNorm2d(c_out, group)
    )


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, group=None):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(c_out, group)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(c_out, group)
        self.downsample = _downsample(c_in, c_out, stride, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, group=None):
        super().__init__()
        squeeze = c_out // 4
        self.conv1 = nn.Conv2d(c_in, squeeze, 1, bias=False)
        self.bn1 = BatchNorm2d(squeeze, group)
        self.conv2 = nn.Conv2d(squeeze, squeeze, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(squeeze, group)
        self.conv3 = nn.Conv2d(squeeze, c_out, 1, bias=False)
        self.bn3 = BatchNorm2d(c_out, group)
        self.downsample = _downsample(c_in, c_out, stride, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """The headless torchvision ResNet, returning every stage's output."""

    def __init__(self, num_layers: int, group=None):
        super().__init__()
        if num_layers not in STAGE_BLOCKS:
            raise ValueError(f"{num_layers} is not a supported resnet depth "
                             f"({sorted(STAGE_BLOCKS)})")
        block = Bottleneck if num_layers in BOTTLENECK else BasicBlock
        widths = encoder_channels(num_layers)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, group)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        c_in = 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[num_layers]):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(block(c_in, widths[stage + 1], stride, group))
                c_in = widths[stage + 1]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = self.maxpool(x)
        for k in range(1, 5):
            x = getattr(self, f"layer{k}")(x)
            feats.append(x)
        return feats


class ResNetEncoder(nn.Module):
    """NHWC [0, 1] images -> 5 NCHW features (strides 2/4/8/16/32)."""

    def __init__(self, num_layers: int = 50, group=None):
        super().__init__()
        self.num_ch_enc = encoder_channels(num_layers)
        self.encoder = ResNet(num_layers, group)
        # float64, rounded to the input's dtype at use: a float64 model gets
        # the constants unrounded
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float64
                                                  ).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD, dtype=torch.float64
                                                 ).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = (x.permute(0, 3, 1, 2) - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        return self.encoder(x)
