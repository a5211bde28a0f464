"""The MPI prediction network: ResNet encoder + disparity-conditioned decoder
(counterpart of mine_tpu/models/mpi.py::MPINetwork).

State-dict layout: `backbone.encoder.<torchvision names>` and
`decoder.<reference DepthDecoder names>`, the two halves of a reference MINE
checkpoint under one module. Input H and W must be multiples of 128.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mine_tpu_torch.models.decoder import MPIDecoder, run_checkpointed
from mine_tpu_torch.obs.attrib import scope
from mine_tpu_torch.models.encoder import ResNetEncoder


class MPINetwork(nn.Module):
    """src images (B, H, W, 3) in [0, 1] + plane disparities (B, S) ->
    {scale: (B, S, H/2^s, W/2^s, 4)} fp32 rgb + sigma MPIs.

    `remat` (model.remat_decoder) recomputes activations in the backward: the
    encoder as one checkpointed region, the decoder stage by stage (see
    decoder.py). `sigma_keep`: the decoder's sigma dropout masks."""

    def __init__(self, num_layers: int = 50, multires: int = 10, use_alpha: bool = False,
                 scales: tuple[int, ...] = (0, 1, 2, 3), decoder_width_multiple: int = 1,
                 sigma_dropout_rate: float = 0.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.backbone = ResNetEncoder(num_layers)
        self.decoder = MPIDecoder(
            self.backbone.num_ch_enc, multires=multires, use_alpha=use_alpha,
            scales=scales, width_multiple=decoder_width_multiple,
            sigma_dropout_rate=sigma_dropout_rate,
        )

    def forward(self, src_imgs: torch.Tensor, disparity: torch.Tensor,
                sigma_keep: torch.Tensor | None = None) -> dict[int, torch.Tensor]:
        # component scopes (obs/attrib.py), the JAX package's named_scopes
        with scope("encoder"):
            features = run_checkpointed(self.remat, self.backbone, src_imgs)
        with scope("decoder"):
            return self.decoder(features, disparity, sigma_keep, remat=self.remat)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights from `generator`, in place: convolutions take
    PyTorch's default kaiming-uniform law, BatchNorm layers non-trivial
    affine parameters and running statistics (scale and variance in
    [0.5, 1.5], shift and mean ~ N(0, 0.1)) so that eval-mode BN is not the
    identity. Draws happen on the CPU, then move to each tensor's device."""

    def fill(t: torch.Tensor, draw) -> None:
        t.copy_(draw(torch.empty(t.shape, dtype=t.dtype)))

    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            fan_in = module.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            fill(module.weight, lambda t: t.uniform_(-bound, bound, generator=generator))
            if module.bias is not None:
                fill(module.bias, lambda t: t.uniform_(-bound, bound, generator=generator))
        elif isinstance(module, nn.BatchNorm2d):
            fill(module.weight, lambda t: t.uniform_(0.5, 1.5, generator=generator))
            fill(module.bias, lambda t: t.normal_(0.0, 0.1, generator=generator))
            fill(module.running_mean, lambda t: t.normal_(0.0, 0.1, generator=generator))
            fill(module.running_var, lambda t: t.uniform_(0.5, 1.5, generator=generator))
    return model
