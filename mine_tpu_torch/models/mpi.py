"""The MPI prediction network: ResNet encoder + disparity-conditioned decoder
(counterpart of mine_tpu/models/mpi.py::MPINetwork), and the coarse-to-fine
plane placement around it (predict_mpi_coarse_to_fine,
merge_fine_disparity).

State-dict layout: `backbone.encoder.<torchvision names>` and
`decoder.<reference DepthDecoder names>`, the two halves of a reference MINE
checkpoint under one module. Input H and W must be multiples of 128.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from mine_tpu_torch.models.decoder import MPIDecoder, run_checkpointed
from mine_tpu_torch.obs.attrib import scope
from mine_tpu_torch.models.encoder import ResNetEncoder
from mine_tpu_torch.ops.mpi_render import plane_volume_rendering
from mine_tpu_torch.ops.sampling import sample_pdf


class MPINetwork(nn.Module):
    """src images (B, H, W, 3) in [0, 1] + plane disparities (B, S) ->
    {scale: (B, S, H/2^s, W/2^s, 4)} fp32 rgb + sigma MPIs.

    `remat` (model.remat_decoder) recomputes activations in the backward: the
    encoder as one checkpointed region, the decoder stage by stage (see
    decoder.py). `sigma_keep`: the decoder's sigma dropout masks.

    On a mesh (parallel/data_parallel.py model_groups) the train-mode
    BatchNorm statistics sync over process groups: the encoder's and the
    decoder extension's over `batch_group`, the decoder up-stages' over
    `stage_group`. The state dict does not change."""

    def __init__(self, num_layers: int = 50, multires: int = 10, use_alpha: bool = False,
                 scales: tuple[int, ...] = (0, 1, 2, 3), decoder_width_multiple: int = 1,
                 sigma_dropout_rate: float = 0.0, remat: bool = False,
                 batch_group=None, stage_group=None):
        super().__init__()
        self.remat = remat
        self.backbone = ResNetEncoder(num_layers, batch_group)
        self.decoder = MPIDecoder(
            self.backbone.num_ch_enc, multires=multires, use_alpha=use_alpha,
            scales=scales, width_multiple=decoder_width_multiple,
            sigma_dropout_rate=sigma_dropout_rate, batch_group=batch_group,
            stage_group=stage_group,
        )

    def forward(self, src_imgs: torch.Tensor, disparity: torch.Tensor,
                sigma_keep: torch.Tensor | None = None) -> dict[int, torch.Tensor]:
        # component scopes (obs/attrib.py), the JAX package's named_scopes
        with scope("encoder"):
            features = run_checkpointed(self.remat, self.backbone, src_imgs)
        with scope("decoder"):
            return self.decoder(features, disparity, sigma_keep, remat=self.remat)


def merge_fine_disparity(disparity_coarse: torch.Tensor, w: torch.Tensor, s_fine: int,
                         generator: torch.Generator | None = None,
                         u: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S) coarse disparities + (B, S) per-plane weights -> the (B, S +
    s_fine) merged list: s_fine draws from the weights' PDF (sample_pdf, its
    uniforms `u` (B, 1, s_fine) or drawn from `generator`) joined to the
    coarse list, sorted descending (the compositing order), with no
    gradient. The plane-sharded path gathers `w` and must merge
    identically."""
    fine = sample_pdf(disparity_coarse[:, None, :], w.detach()[:, None, :], s_fine,
                      generator, u)[:, 0, :]
    merged = torch.cat([disparity_coarse, fine], dim=1)
    return torch.sort(merged, dim=1, descending=True).values.detach()


def predict_mpi_coarse_to_fine(predictor: Callable[[torch.Tensor, torch.Tensor], dict],
                               src_imgs: torch.Tensor, xyz_src_coarse: torch.Tensor,
                               disparity_coarse: torch.Tensor, s_fine: int,
                               generator: torch.Generator | None = None,
                               u: torch.Tensor | None = None,
                               is_bg_depth_inf: bool = False):
    """Refine plane placement with a second pass: a coarse pass without
    gradient gives per-plane compositing weights (their mean over pixels),
    whose PDF is sampled for s_fine more disparities, and the predictor runs
    again on the sorted union. Returns (mpis, merged disparity); with
    s_fine 0 one pass on the coarse list. The predictor runs in the model's
    mode: in train mode both passes move the BatchNorm statistics."""
    if s_fine <= 0:
        return predictor(src_imgs, disparity_coarse), disparity_coarse
    with torch.no_grad():
        mpi0 = predictor(src_imgs, disparity_coarse)[0]
        _, _, _, weights = plane_volume_rendering(mpi0[..., 0:3], mpi0[..., 3:4],
                                                  xyz_src_coarse, is_bg_depth_inf)
    w = torch.mean(weights, dim=(2, 3, 4))  # (B, S)
    disparity_all = merge_fine_disparity(disparity_coarse, w, s_fine, generator, u)
    return predictor(src_imgs, disparity_all), disparity_all


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
