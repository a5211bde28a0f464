"""Model construction, plane placement and the novel-view render
(counterpart of those parts of mine_tpu/training/step.py; the loss and the
train step come with the training port)."""

from __future__ import annotations

import numpy as np
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.ops.mpi_render import compositor_from_config
from mine_tpu_torch.ops.sampling import fixed_disparity_linspace


def build_model(cfg: Config) -> MPINetwork:
    """The MPINetwork cfg describes, in eval mode, on the CPU.

    The decoder's receptive-field extension pools the /32 feature twice and
    upsamples twice, so the round trip restores H/32 only when H and W are
    multiples of 128; fail here with that reason instead of a shape
    mismatch deep inside the forward."""
    for dim, name in ((cfg.data.img_h, "data.img_h"), (cfg.data.img_w, "data.img_w")):
        if dim % 128 != 0:
            raise ValueError(
                f"{name}={dim} is not a multiple of 128; the MPI decoder's "
                "encoder extension (pool x2 + up x2 over the /32 feature) "
                "requires it"
            )
    return MPINetwork(
        num_layers=cfg.model.num_layers,
        multires=cfg.model.pos_encoding_multires,
        use_alpha=cfg.mpi.use_alpha,
        decoder_width_multiple=cfg.model.decoder_width_multiple,
    ).eval()


def make_disparity_list(cfg: Config, batch_size: int,
                        device: torch.device | str | None = None) -> torch.Tensor:
    """Deterministic plane disparities (B, S_coarse), descending: the explicit
    bin list when configured, else a linspace. Only the fixed placement is
    ported; stratified sampling comes with training."""
    m = cfg.mpi
    if not m.fix_disparity:
        raise NotImplementedError(
            "stratified disparity sampling (mpi.fix_disparity: false) comes "
            "with the training port; inference uses fixed planes"
        )
    if len(m.disparity_list) == m.num_bins_coarse + 1:
        edges = torch.from_numpy(np.asarray(m.disparity_list[1:], np.float32))
        return edges.to(device)[None].expand(batch_size, m.num_bins_coarse)
    return fixed_disparity_linspace(
        batch_size, m.num_bins_coarse, m.disparity_start, m.disparity_end, device
    )


def render_novel_view(cfg: Config, mpi_rgb, mpi_sigma, disparity, g_tgt_src,
                      k_src_inv, k_tgt) -> dict[str, torch.Tensor]:
    """Warp + composite the source MPI into the target camera with the
    compositor cfg.mpi.compositor names."""
    rgb, depth, mask = compositor_from_config(cfg).render_tgt_rgb_depth(
        mpi_rgb, mpi_sigma, disparity, g_tgt_src, k_src_inv, k_tgt,
        use_alpha=cfg.mpi.use_alpha, is_bg_depth_inf=cfg.mpi.is_bg_depth_inf,
    )
    return {"tgt_imgs_syn": rgb, "tgt_disparity_syn": 1.0 / depth, "tgt_mask_syn": mask}
