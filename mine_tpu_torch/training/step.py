"""The training step: the network forward, the 4-scale loss graph, the
backward and the optimizer update (counterpart of
mine_tpu/training/step.py at training.accum_steps 1, sentinel off, one
device).

Batch contract (the JAX package's): src_img, tgt_img (B, H, W, 3) fp32 in
[0, 1]; k_src, k_tgt (B, 3, 3); g_tgt_src (B, 4, 4) source-to-target rigid
transform; pt3d_src, pt3d_tgt (B, N, 3) sparse points in each camera frame.
Only the network runs under bf16 autocast (model.dtype "bfloat16"); its MPIs
come out fp32 and the render and the losses run in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.losses.metrics import compute_scale_factor, log_disparity_loss, psnr
from mine_tpu_torch.losses.smoothness import edge_aware_loss, edge_aware_loss_v2
from mine_tpu_torch.losses.ssim import ssim
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.ops.geometry import inverse_3x3, scale_intrinsics
from mine_tpu_torch.ops.mpi_render import compositor_from_config
from mine_tpu_torch.ops.sampling import (
    fixed_disparity_linspace,
    gather_pixel_by_pxpy,
    uniform_disparity_from_bins,
    uniform_disparity_from_linspace_bins,
)

# datasets without metric sparse points: disparity point losses are off and
# the scale factor is 1
NO_DISP_SUPERVISION = ("flowers", "kitti_raw", "dtu")


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
                        device: torch.device | str | None = None,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Plane disparities (B, S_coarse), descending. With mpi.fix_disparity
    the explicit bin list (when configured) or a linspace; otherwise one
    stratified draw per bin from `generator`."""
    m = cfg.mpi
    has_list = len(m.disparity_list) == m.num_bins_coarse + 1
    if m.fix_disparity:
        if has_list:
            edges = torch.from_numpy(np.asarray(m.disparity_list[1:], np.float32))
            return edges.to(device)[None].expand(batch_size, m.num_bins_coarse)
        return fixed_disparity_linspace(
            batch_size, m.num_bins_coarse, m.disparity_start, m.disparity_end, device
        )
    if has_list:
        return uniform_disparity_from_bins(
            batch_size, m.disparity_list, generator, device=device
        )
    return uniform_disparity_from_linspace_bins(
        batch_size, m.num_bins_coarse, m.disparity_start, m.disparity_end,
        generator, device=device,
    )


def predict_mpis(cfg: Config, model: torch.nn.Module, img: torch.Tensor,
                 disparity: torch.Tensor) -> dict[int, torch.Tensor]:
    """{scale: (B, S, H/2^s, W/2^s, 4)} fp32 MPIs, the network run under the
    model.dtype rule: bf16 autocast for "bfloat16", none for "float32"."""
    if cfg.model.dtype == "bfloat16":
        with torch.autocast(device_type=img.device.type, dtype=torch.bfloat16):
            return model(img, disparity)
    if cfg.model.dtype == "float32":
        return model(img, disparity)
    raise ValueError(f"model.dtype={cfg.model.dtype!r} must be bfloat16 or float32")


def render_novel_view(cfg: Config, mpi_rgb, mpi_sigma, disparity, g_tgt_src,
                      k_src_inv, k_tgt, scale_factor: torch.Tensor | None = None,
                      ) -> dict[str, torch.Tensor]:
    """Warp + composite the source MPI into the target camera with the
    compositor cfg.mpi.compositor names. `scale_factor` (B,) divides the pose
    translation, detached: it calibrates the pose, it is not trained through
    it."""
    if scale_factor is not None:
        g_tgt_src = g_tgt_src.clone()
        g_tgt_src[:, :3, 3] = g_tgt_src[:, :3, 3] / scale_factor.detach()[:, None]
    rgb, depth, mask = compositor_from_config(cfg).render_tgt_rgb_depth(
        mpi_rgb, mpi_sigma, disparity, g_tgt_src, k_src_inv, k_tgt,
        use_alpha=cfg.mpi.use_alpha, is_bg_depth_inf=cfg.mpi.is_bg_depth_inf,
    )
    return {"tgt_imgs_syn": rgb, "tgt_disparity_syn": 1.0 / depth, "tgt_mask_syn": mask}


def _project_points(k: torch.Tensor, pt3d: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (B, N, 3) -> pixel coords (B, N, 2), the 3x3
    product written out in fp32 (never TF32)."""
    uvw = torch.sum(k[:, None, :, :] * pt3d[:, :, None, :], dim=-1)
    return uvw[..., :2] / uvw[..., 2:3]


def loss_fcn_per_scale(cfg: Config, scale: int, batch: dict[str, torch.Tensor],
                       mpi: torch.Tensor, disparity: torch.Tensor,
                       scale_factor: torch.Tensor | None):
    """One scale of the supervision graph. mpi (B, S, h, w, 4) at this
    scale's resolution. Returns (loss_dict, visualization, scale_factor):
    the scale factor is computed at the first scale from the sparse points
    and reused, with its gradient, at the others."""
    compositor = compositor_from_config(cfg)
    stride = 2**scale
    # nearest downsample == strided slice: out[i] = in[i * 2^s]
    src_img = batch["src_img"][:, ::stride, ::stride]
    tgt_img = batch["tgt_img"][:, ::stride, ::stride]
    b = src_img.shape[0]
    k_src = scale_intrinsics(batch["k_src"], scale)
    k_tgt = scale_intrinsics(batch["k_tgt"], scale)
    k_src_inv = inverse_3x3(k_src)
    if tuple(mpi.shape[2:4]) != tuple(src_img.shape[1:3]):
        raise ValueError(f"MPI spatial dims {tuple(mpi.shape[2:4])} != scale-{scale} "
                         f"image dims {tuple(src_img.shape[1:3])}")
    mpi_rgb, mpi_sigma = mpi[..., 0:3], mpi[..., 3:4]

    src_syn, src_depth, blend_weights, weights = compositor.render_src(
        mpi_rgb, mpi_sigma, disparity, k_src_inv,
        use_alpha=cfg.mpi.use_alpha, is_bg_depth_inf=cfg.mpi.is_bg_depth_inf,
    )
    if cfg.training.src_rgb_blending:
        # visible-from-source parts take the real pixels; occluded parts keep
        # the network's rgb
        mpi_rgb = blend_weights * src_img[:, None] + (1.0 - blend_weights) * mpi_rgb
        src_syn, src_depth = compositor.weighted_sum_src(
            mpi_rgb, disparity, weights, is_bg_depth_inf=cfg.mpi.is_bg_depth_inf
        )
    src_disparity_syn = 1.0 / src_depth

    # sparse-point disparity supervision + scale calibration
    disp_supervised = cfg.data.name not in NO_DISP_SUPERVISION
    zero = torch.zeros((), device=src_img.device)
    if disp_supervised:
        src_pt_disp = 1.0 / batch["pt3d_src"][..., 2:3]
        src_pt_disp_syn = gather_pixel_by_pxpy(
            src_disparity_syn, _project_points(k_src, batch["pt3d_src"])
        )
        if scale_factor is None:
            scale_factor = compute_scale_factor(src_pt_disp_syn, src_pt_disp)
        loss_disp_src = log_disparity_loss(src_pt_disp_syn, src_pt_disp, scale_factor)
    else:
        if scale_factor is None:
            scale_factor = torch.ones((b,), device=src_img.device)
        loss_disp_src = zero

    render = render_novel_view(cfg, mpi_rgb, mpi_sigma, disparity, batch["g_tgt_src"],
                               k_src_inv, k_tgt, scale_factor=scale_factor)
    tgt_syn = render["tgt_imgs_syn"]
    tgt_disparity_syn = render["tgt_disparity_syn"]
    tgt_mask = render["tgt_mask_syn"]

    if disp_supervised:
        tgt_pt_disp = 1.0 / batch["pt3d_tgt"][..., 2:3]
        tgt_pt_disp_syn = gather_pixel_by_pxpy(
            tgt_disparity_syn, _project_points(k_tgt, batch["pt3d_tgt"])
        )
        loss_disp_tgt = log_disparity_loss(tgt_pt_disp_syn, tgt_pt_disp, scale_factor)
    else:
        loss_disp_tgt = zero

    lc = cfg.loss
    valid_mask = (tgt_mask >= cfg.mpi.valid_mask_threshold).float()
    loss_rgb_tgt = torch.mean(torch.abs(tgt_syn - tgt_img) * valid_mask)
    loss_ssim_tgt = 1.0 - ssim(tgt_syn, tgt_img)
    loss_smooth_tgt = lc.smoothness_lambda_v1 * edge_aware_loss(
        tgt_img, tgt_disparity_syn, gmin=lc.smoothness_gmin,
        grad_ratio=lc.smoothness_grad_ratio,
    )
    loss_smooth_tgt_v2 = lc.smoothness_lambda_v2 * edge_aware_loss_v2(tgt_img, tgt_disparity_syn)
    loss_smooth_src_v2 = lc.smoothness_lambda_v2 * edge_aware_loss_v2(src_img, src_disparity_syn)

    # logged, not trained: computed on detached tensors
    src_syn_ng, src_disp_ng = src_syn.detach(), src_disparity_syn.detach()
    loss_rgb_src = torch.mean(torch.abs(src_syn_ng - src_img))
    loss_ssim_src = 1.0 - ssim(src_syn_ng, src_img)
    loss_smooth_src = edge_aware_loss(
        src_img, src_disp_ng, gmin=lc.smoothness_gmin, grad_ratio=lc.smoothness_grad_ratio,
    )
    psnr_tgt = psnr(tgt_syn.detach(), tgt_img)

    loss = (loss_disp_tgt + loss_disp_src + loss_rgb_tgt + loss_ssim_tgt
            + loss_smooth_tgt + loss_smooth_src_v2 + loss_smooth_tgt_v2)
    loss_dict = {
        "loss": loss,
        "loss_rgb_src": loss_rgb_src,
        "loss_ssim_src": loss_ssim_src,
        "loss_disp_pt3dsrc": loss_disp_src,
        "loss_smooth_src": loss_smooth_src,
        "loss_smooth_tgt": loss_smooth_tgt,
        "loss_smooth_src_v2": loss_smooth_src_v2,
        "loss_smooth_tgt_v2": loss_smooth_tgt_v2,
        "loss_rgb_tgt": loss_rgb_tgt,
        "loss_ssim_tgt": loss_ssim_tgt,
        "psnr_tgt": psnr_tgt,
        "loss_disp_pt3dtgt": loss_disp_tgt,
    }
    visualization = {
        "src_disparity_syn": src_disparity_syn,
        "tgt_disparity_syn": tgt_disparity_syn,
        "tgt_imgs_syn": tgt_syn,
        "tgt_mask_syn": tgt_mask,
        "src_imgs_syn": src_syn,
    }
    return loss_dict, visualization, scale_factor


def loss_fcn(cfg: Config, model: MPINetwork, batch: dict[str, torch.Tensor],
             generator: torch.Generator | None = None,
             disparity: torch.Tensor | None = None):
    """The network forward (in the model's current mode; train mode updates
    the BatchNorm running statistics) and the losses of every scale the
    model predicts, summed into the multi-scale total. Disparities are drawn
    with `generator` unless given. Returns (total, loss_dict,
    scale-0 visualization); loss_dict["loss"] is the total."""
    src_img = batch["src_img"]
    if disparity is None:
        disparity = make_disparity_list(cfg, src_img.shape[0], src_img.device, generator)
    mpis = predict_mpis(cfg, model, src_img, disparity)
    scales = sorted(mpis)
    if not scales or scales[0] != 0:
        raise ValueError("the loss needs scale 0: it drives the calibration")
    scale_factor = None
    loss_dicts, vizs = [], []
    for scale in scales:
        ld, viz, scale_factor = loss_fcn_per_scale(
            cfg, scale, batch, mpis[scale], disparity, scale_factor
        )
        loss_dicts.append(ld)
        vizs.append(viz)
    loss_dict = dict(loss_dicts[0])
    total = loss_dict["loss"]
    for ld in loss_dicts[1:]:
        if cfg.training.use_multi_scale:
            total = total + ld["loss_rgb_tgt"] + ld["loss_ssim_tgt"]
        total = total + ld["loss_disp_pt3dsrc"] + ld["loss_disp_pt3dtgt"]
        total = total + ld["loss_smooth_src_v2"] + ld["loss_smooth_tgt_v2"]
    loss_dict["loss"] = total
    return total, loss_dict, vizs[0]


def train_step(cfg: Config, model: MPINetwork, optimizer: torch.optim.Optimizer,
               scheduler, batch: dict[str, torch.Tensor],
               generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """One update: loss, backward, the optimizer step and the schedule's
    step; BatchNorm statistics update in place. Returns the detached loss
    dict with the global gradient norm (before weight decay) as
    "grad_norm"."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    total, loss_dict, _ = loss_fcn(cfg, model, batch, generator)
    total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    grad_norm = torch.nn.utils.get_total_norm(grads)
    optimizer.step()
    scheduler.step()
    out = {k: v.detach() for k, v in loss_dict.items()}
    out["grad_norm"] = grad_norm.detach()
    return out


def batch_to_device(batch: dict, device: torch.device | str) -> dict[str, torch.Tensor]:
    """A loader batch of numpy arrays -> fp32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}
