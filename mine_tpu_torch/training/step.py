"""The training and eval steps: the network forward, the 4-scale loss graph,
the backward and the optimizer update (counterpart of
mine_tpu/training/step.py): gradient accumulation over micro-batches, the
sentinel's skip of a non-finite update, and the eval step's per-example
metrics weighted by `eval_weight`. With a `plan`
(parallel/data_parallel.py) the same steps run as one rank of a mesh: its
rows of the batch, its planes of the MPI, and the step's collectives.

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
from mine_tpu_torch.losses.lpips import lpips
from mine_tpu_torch.losses.metrics import compute_scale_factor, log_disparity_loss, psnr
from mine_tpu_torch.losses.smoothness import edge_aware_loss, edge_aware_loss_v2
from mine_tpu_torch.losses.ssim import ssim
from mine_tpu_torch.models.mpi import MPINetwork
from mine_tpu_torch.obs.attrib import scope
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


def build_model(cfg: Config, batch_group=None, stage_group=None) -> MPINetwork:
    """The MPINetwork cfg describes, in eval mode, on the CPU; on a mesh its
    BatchNorm statistics sync over the groups of
    parallel/data_parallel.py model_groups.

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
        sigma_dropout_rate=cfg.mpi.sigma_dropout_rate,
        remat=cfg.model.remat_decoder,
        batch_group=batch_group,
        stage_group=stage_group,
    ).eval()


def make_disparity_list(cfg: Config, batch_size: int,
                        device: torch.device | str | None = None,
                        generator: torch.Generator | None = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plane disparities (B, S_coarse), descending. With mpi.fix_disparity
    the explicit bin list (when configured) or a linspace, in `dtype`;
    otherwise one fp32 stratified draw per bin from `generator`."""
    m = cfg.mpi
    has_list = len(m.disparity_list) == m.num_bins_coarse + 1
    if m.fix_disparity:
        if has_list:
            edges = torch.tensor(m.disparity_list[1:], dtype=dtype)
            return edges.to(device)[None].expand(batch_size, m.num_bins_coarse)
        return fixed_disparity_linspace(
            batch_size, m.num_bins_coarse, m.disparity_start, m.disparity_end, device, dtype
        )
    if has_list:
        return uniform_disparity_from_bins(
            batch_size, m.disparity_list, generator, device=device
        )
    return uniform_disparity_from_linspace_bins(
        batch_size, m.num_bins_coarse, m.disparity_start, m.disparity_end,
        generator, device=device,
    )


def sigma_keep_masks(cfg: Config, model: MPINetwork, disparity: torch.Tensor,
                     generator: torch.Generator | None) -> torch.Tensor | None:
    """The decoder's sigma dropout masks for the (B, S) planes of
    `disparity`, (n_scales, B, S): one Bernoulli keep (probability
    1 - mpi.sigma_dropout_rate) per plane and output scale, drawn from
    `generator` on the CPU. None unless the model is in train mode with a
    positive rate."""
    rate = cfg.mpi.sigma_dropout_rate
    if rate <= 0.0 or not model.training:
        return None
    shape = (len(model.decoder.scales),) + tuple(disparity.shape)
    return torch.bernoulli(torch.full(shape, 1.0 - rate), generator=generator).to(
        disparity.device)


def predict_mpis(cfg: Config, model: torch.nn.Module, img: torch.Tensor,
                 disparity: torch.Tensor,
                 sigma_keep: torch.Tensor | None = None) -> dict[int, torch.Tensor]:
    """{scale: (B, S, H/2^s, W/2^s, 4)} fp32 MPIs, the network run under the
    model.dtype rule: bf16 autocast for "bfloat16", none for "float32"."""
    if cfg.model.dtype == "bfloat16":
        with torch.autocast(device_type=img.device.type, dtype=torch.bfloat16):
            return model(img, disparity, sigma_keep)
    if cfg.model.dtype == "float32":
        return model(img, disparity, sigma_keep)
    raise ValueError(f"model.dtype={cfg.model.dtype!r} must be bfloat16 or float32")


def render_novel_view(cfg: Config, mpi_rgb, mpi_sigma, disparity, g_tgt_src,
                      k_src_inv, k_tgt, scale_factor: torch.Tensor | None = None,
                      compositor=None) -> dict[str, torch.Tensor]:
    """Warp + composite the source MPI into the target camera with
    `compositor`, by default the one cfg.mpi.compositor names. `scale_factor`
    (B,) divides the pose translation, detached: it calibrates the pose, it
    is not trained through it."""
    compositor = compositor or compositor_from_config(cfg)
    if scale_factor is not None:
        g_tgt_src = g_tgt_src.clone()
        g_tgt_src[:, :3, 3] = g_tgt_src[:, :3, 3] / scale_factor.detach()[:, None]
    rgb, depth, mask = compositor.render_tgt_rgb_depth(
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
                       scale_factor: torch.Tensor | None, is_val: bool = False,
                       lpips_params: dict | None = None, per_example: bool = False,
                       compositor=None):
    """One scale of the supervision graph. mpi (B, S, h, w, 4) at this
    scale's resolution. Returns (loss_dict, visualization, scale_factor):
    the scale factor is computed at the first scale from the sparse points
    and reused, with its gradient, at the others. With `per_example` every
    loss_dict entry is a (B,) vector of per-example means (every term
    decomposes exactly); LPIPS runs at scale 0 of an eval (`is_val`) with
    weights, and is 0 otherwise. `compositor` defaults to the one
    cfg.mpi.compositor names (a plane shard passes its sharded one)."""
    compositor = compositor or compositor_from_config(cfg)
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
    sa = not per_example  # size_average for every decomposable term
    zero = torch.zeros((b,) if per_example else (), device=src_img.device)
    if disp_supervised:
        src_pt_disp = 1.0 / batch["pt3d_src"][..., 2:3]
        src_pt_disp_syn = gather_pixel_by_pxpy(
            src_disparity_syn, _project_points(k_src, batch["pt3d_src"])
        )
        if scale_factor is None:
            scale_factor = compute_scale_factor(src_pt_disp_syn, src_pt_disp)
        loss_disp_src = log_disparity_loss(src_pt_disp_syn, src_pt_disp, scale_factor,
                                           size_average=sa)
    else:
        if scale_factor is None:
            scale_factor = torch.ones((b,), device=src_img.device)
        loss_disp_src = zero

    render = render_novel_view(cfg, mpi_rgb, mpi_sigma, disparity, batch["g_tgt_src"],
                               k_src_inv, k_tgt, scale_factor=scale_factor, compositor=compositor)
    tgt_syn = render["tgt_imgs_syn"]
    tgt_disparity_syn = render["tgt_disparity_syn"]
    tgt_mask = render["tgt_mask_syn"]

    if disp_supervised:
        tgt_pt_disp = 1.0 / batch["pt3d_tgt"][..., 2:3]
        tgt_pt_disp_syn = gather_pixel_by_pxpy(
            tgt_disparity_syn, _project_points(k_tgt, batch["pt3d_tgt"])
        )
        loss_disp_tgt = log_disparity_loss(tgt_pt_disp_syn, tgt_pt_disp, scale_factor,
                                           size_average=sa)
    else:
        loss_disp_tgt = zero

    def image_mean(x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x) if sa else torch.mean(x, dim=(1, 2, 3))

    lc = cfg.loss
    valid_mask = (tgt_mask >= cfg.mpi.valid_mask_threshold).to(tgt_syn.dtype)
    loss_rgb_tgt = image_mean(torch.abs(tgt_syn - tgt_img) * valid_mask)
    loss_ssim_tgt = 1.0 - ssim(tgt_syn, tgt_img, size_average=sa)
    loss_smooth_tgt = lc.smoothness_lambda_v1 * edge_aware_loss(
        tgt_img, tgt_disparity_syn, gmin=lc.smoothness_gmin,
        grad_ratio=lc.smoothness_grad_ratio, size_average=sa,
    )
    loss_smooth_tgt_v2 = lc.smoothness_lambda_v2 * edge_aware_loss_v2(
        tgt_img, tgt_disparity_syn, size_average=sa)
    loss_smooth_src_v2 = lc.smoothness_lambda_v2 * edge_aware_loss_v2(
        src_img, src_disparity_syn, size_average=sa)

    # logged, not trained: computed on detached tensors
    src_syn_ng, src_disp_ng = src_syn.detach(), src_disparity_syn.detach()
    loss_rgb_src = image_mean(torch.abs(src_syn_ng - src_img))
    loss_ssim_src = 1.0 - ssim(src_syn_ng, src_img, size_average=sa)
    loss_smooth_src = edge_aware_loss(
        src_img, src_disp_ng, gmin=lc.smoothness_gmin, grad_ratio=lc.smoothness_grad_ratio,
        size_average=sa,
    )
    tgt_syn_ng = tgt_syn.detach()
    psnr_tgt = psnr(tgt_syn_ng, tgt_img, size_average=sa)
    if is_val and scale == 0 and lpips_params is not None:
        lpips_tgt = lpips(lpips_params, tgt_syn_ng, tgt_img, size_average=sa)
    else:
        lpips_tgt = zero

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
        "lpips_tgt": lpips_tgt,
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
             disparity: torch.Tensor | None = None,
             dropout_generator: torch.Generator | None = None, is_val: bool = False,
             lpips_params: dict | None = None, per_example: bool = False, plan=None):
    """The network forward (in the model's current mode; train mode updates
    the BatchNorm running statistics and applies sigma dropout with masks
    from `dropout_generator`) and the losses of every scale the model
    predicts, summed into the multi-scale total. Disparities are drawn with
    `generator` unless given. Returns (total, loss_dict, scale-0
    visualization); loss_dict["loss"] is the total, a (B,) vector like every
    entry with `per_example`.

    With a `plan` the batch is this rank's rows: the disparities (drawn, or
    given) and the dropout masks are the global (B_global, S) ones, of which
    the rank takes its rows and planes, and the render goes through the
    plan's compositor. The losses are this rank's rows' (replicated over
    the plane ranks)."""
    src_img = batch["src_img"]
    b = src_img.shape[0]
    if disparity is None:
        rows = b if plan is None else b * plan.n_batch
        disparity = make_disparity_list(cfg, rows, src_img.device, generator,
                                        torch.promote_types(src_img.dtype, torch.float32))
    keep = sigma_keep_masks(cfg, model, disparity, dropout_generator)
    compositor = None
    if plan is not None:
        disparity = plan.local(disparity)
        keep = None if keep is None else plan.local(keep)
        compositor = plan.compositor
    mpis = predict_mpis(cfg, model, src_img, disparity, keep)
    scales = sorted(mpis)
    if not scales or scales[0] != 0:
        raise ValueError("the loss needs scale 0: it drives the calibration")
    scale_factor = None
    loss_dicts, vizs = [], []
    for scale in scales:
        # component scope (obs/attrib.py): everything per scale outside the
        # render's own warp and composite scopes
        with scope("losses"):
            ld, viz, scale_factor = loss_fcn_per_scale(
                cfg, scale, batch, mpis[scale], disparity, scale_factor,
                is_val=is_val, lpips_params=lpips_params, per_example=per_example,
                compositor=compositor,
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


class _BufferSnapshot:
    """A copy of a model's buffers (the BatchNorm running statistics and
    counts) taken in one concatenation per dtype, to put back when a step's
    update is dropped or the step fails."""

    def __init__(self, model: torch.nn.Module):
        groups: dict[torch.dtype, list[torch.Tensor]] = {}
        for buf in model.buffers():
            groups.setdefault(buf.dtype, []).append(buf)
        self._groups = [(bufs, torch.cat([t.reshape(-1) for t in bufs]))
                        for bufs in groups.values()]

    @torch.no_grad()
    def restore(self) -> None:
        for bufs, flat in self._groups:
            for buf, saved in zip(bufs, flat.split([t.numel() for t in bufs])):
                buf.copy_(saved.view_as(buf))


def train_step(cfg: Config, model: MPINetwork, optimizer: torch.optim.Optimizer,
               scheduler, batch: dict[str, torch.Tensor],
               generator: torch.Generator | None = None,
               dropout_generator: torch.Generator | None = None,
               plan=None) -> dict[str, torch.Tensor]:
    """One update; returns the detached loss dict with "grad_norm" (the
    global gradient norm, before weight decay) and "update_skipped".

    With training.accum_steps = k > 1 the batch splits into k micro-batches
    of B/k rows, each one forward and backward (disparities and dropout
    masks drawn anew for each); the gradients accumulate in fp32 (or the
    parameters' wider dtype) and are divided by k, the loss dict is the
    mean over micro-batches, and the BatchNorm statistics move once per
    micro-batch, as k steps would move them.

    With any resilience.sentinel_policy but "off", a non-finite loss or
    gradient norm (in any micro-batch) skips the update: parameters,
    optimizer and schedule state and BatchNorm statistics keep their values
    (update_skipped 1) while the generators have advanced. That check waits
    for the card once a step.

    With a `plan` (one rank of a mesh): each micro-batch's scalar loss is
    averaged over the batch replicas before the backward (an all-reduce
    whose backward passes the local cotangent), the gradients are summed
    over every rank once (after the accumulation), the logged loss dict is
    averaged over the batch replicas, and the finite verdict is the whole
    mesh's, so every rank keeps or skips the same update."""
    from mine_tpu_torch.parallel.comm import all_reduce_, all_reduce_replicated

    model.train()
    k = max(int(cfg.training.accum_steps), 1)
    b = batch["src_img"].shape[0]
    if b % k:
        raise ValueError(f"training.accum_steps={k} must divide the per-device batch size "
                         f"{b} (batch reshapes to (k, b/k, ...))")
    params = [p for p in model.parameters() if p.requires_grad]
    sentinel = cfg.resilience.sentinel_policy != "off"
    snapshot = _BufferSnapshot(model)
    try:
        grads, loss_dict, finite = None, {}, None
        m = b // k
        for i in range(k):
            micro = batch if k == 1 else {key: v[i * m:(i + 1) * m] for key, v in batch.items()}
            total, ld, _ = loss_fcn(cfg, model, micro, generator,
                                    dropout_generator=dropout_generator, plan=plan)
            if plan is not None:
                total = all_reduce_replicated(total, plan.batch_group) / plan.n_batch
            g = torch.autograd.grad(total, params, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x for p, x in zip(params, g)]
            if k == 1:
                grads, loss_dict = g, {key: v.detach() for key, v in ld.items()}
                continue
            if sentinel:
                ok = torch.isfinite(total.detach()) & torch.isfinite(
                    torch.nn.utils.get_total_norm(g))
                finite = ok if finite is None else finite & ok
            g = [x.to(torch.promote_types(x.dtype, torch.float32)) for x in g]
            grads = g if grads is None else [a + x for a, x in zip(grads, g)]
            for key, v in ld.items():
                loss_dict[key] = v.detach() if i == 0 else loss_dict[key] + v.detach()
        if k > 1:
            grads = [a / k for a in grads]
            loss_dict = {key: v / k for key, v in loss_dict.items()}
        if plan is not None:
            all_reduce_(grads, plan.world_group)
            all_reduce_(list(loss_dict.values()), plan.batch_group, average=True)
    except BaseException:
        snapshot.restore()
        raise
    grad_norm = torch.nn.utils.get_total_norm(grads)
    out = dict(loss_dict, grad_norm=grad_norm.detach())
    if sentinel:
        ok = torch.isfinite(loss_dict["loss"]) & torch.isfinite(grad_norm)
        finite = ok if finite is None else finite & ok
        if plan is not None:
            # a NaN on one rank's micro-batch poisons every rank's verdict
            verdict = [finite.to(torch.float32).reshape(1)]
            all_reduce_(verdict, plan.world_group, average=True)
            finite = verdict[0][0] == 1.0
        skipped = not bool(finite)
    else:
        skipped = False
    out["update_skipped"] = torch.tensor(float(skipped), device=grad_norm.device)
    for p, g in zip(params, grads):  # left in .grad for inspection until the next step
        p.grad = g.to(p.dtype)
    if skipped:
        snapshot.restore()
        return out
    with scope("optimizer"):
        optimizer.step()
        scheduler.step()
    return out


@torch.no_grad()
def eval_step(cfg: Config, model: MPINetwork, batch: dict[str, torch.Tensor],
              generator: torch.Generator | None = None, lpips_params: dict | None = None,
              plan=None):
    """The loss graph in eval mode (running BatchNorm statistics, no
    dropout, no update): (loss_dict, scale-0 visualization). Every entry is
    the batch's mean over its genuine examples: the per-example values
    weighted by batch["eval_weight"] (0 on padded slots; all ones when
    absent), with "eval_examples" their count. With a `plan` the batch is
    this rank's rows, and the weighted sums and the count are summed over
    the batch replicas before the division, so the mean is exact whichever
    rank's rows the padded slots fell on."""
    from mine_tpu_torch.parallel.comm import all_reduce_

    model.eval()
    batch = dict(batch)
    weight = batch.pop("eval_weight", None)
    _, loss_dict, viz = loss_fcn(cfg, model, batch, generator, is_val=True,
                                 lpips_params=lpips_params, per_example=True, plan=plan)
    if weight is None:
        weight = torch.ones_like(loss_dict["psnr_tgt"])
    num = {key: torch.sum(v * weight) for key, v in loss_dict.items()}
    den = torch.sum(weight)
    if plan is not None:
        all_reduce_([*num.values(), den], plan.batch_group)
    out = {key: v / torch.clamp(den, min=1.0) for key, v in num.items()}
    out["eval_examples"] = den
    return out, viz


def pin_batch(batch: dict) -> dict[str, torch.Tensor]:
    """A loader batch of numpy arrays -> fp32 host tensors in fresh
    page-locked memory, so that batch_to_device's copy does not block the
    host. Each batch gets its own buffers: torch's pinned-memory allocator
    reuses a buffer only after the copies issued from it have finished."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).pin_memory() for k, v in batch.items()}


def batch_to_device(batch: dict, device: torch.device | str) -> dict[str, torch.Tensor]:
    """A loader batch (numpy arrays, or pin_batch's tensors) -> fp32 tensors
    on `device`. A pinned tensor's copy is issued on the current stream
    without waiting for it (non_blocking); a pageable one waits."""
    out = {}
    for k, v in batch.items():
        t = (v.to(torch.float32) if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v, np.float32)))
        out[k] = t.to(device, non_blocking=t.is_pinned())
    return out
