"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; without them each test skips with its
reason. The file imports no JAX, so on a machine without JAX it runs apart
from the suite's conftest (which sets up JAX devices):
`PYTHONPATH=. python -m pytest tests/test_torch_cuda.py -q --noconftest`.
Tolerance 1e-5: kernel
and plain version do the same fp32 arithmetic, the kernel with fused
multiply-adds. The backward kernel adds into the source cotangent with
atomics, in an order that changes from run to run: it is held at rtol 1e-5
and atol 1e-5 of the largest |grad_src|. The warp-composite kernel computes
its coordinates with the plain version's rounding, op for op, and combines
its plane segments in another order than the plain sweep: 1e-5.
"""

import math

import pytest
import torch

from mine_tpu_torch.ops.geometry import inverse_3x3
from mine_tpu_torch.ops.kernels import warp as kw
from mine_tpu_torch.ops.mpi_render import streaming_matrices

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _coords(n, ho, wo, h, w, gen, dev):
    cx = torch.rand((n, ho, wo), generator=gen, device=dev) * (w + 10) - 5
    cy = torch.rand((n, ho, wo), generator=gen, device=dev) * (h + 10) - 5
    return cx, cy


@pytest.mark.parametrize("n,c,h,w,ho,wo", [
    (2, 3, 24, 136, 16, 130),  # edge shapes of the Pallas tests
    (1, 4, 1, 136, 8, 20),     # one-pixel rows
    (1, 4, 24, 1, 8, 20),      # one-pixel columns
    (3, 1, 33, 65, 7, 300),    # odd sizes, upsampled output
])
def test_warp_bilinear_kernel_matches_plain(cuda, n, c, h, w, ho, wo):
    gen = torch.Generator(device=cuda).manual_seed(0)
    src = torch.rand((n, c, h, w), generator=gen, device=cuda)
    cx, cy = _coords(n, ho, wo, h, w, gen, cuda)
    kw.reset_launches()
    got = kw.warp_bilinear(src, cx, cy)
    torch.cuda.synchronize()
    assert kw.launches["warp_bilinear"] == 1
    torch.testing.assert_close(got, kw.warp_bilinear_plain(src, cx, cy),
                               rtol=1e-5, atol=1e-5)


COMPOSITE_POSES = {  # (tx, ty, tz, yaw) of G_tgt_src
    "gentle": (0.05, -0.02, 0.01, 0.03),
    "plane_behind": (0.1, 0.05, -1.3, 0.3),  # the nearest plane behind the camera
    "edge_on": (0.02, 0.0, 0.1, 0.95),  # the planes' vanishing line in the image
    "out_of_fov": (6.0, -4.0, 0.2, 0.1),  # most planes land outside the view
}


@pytest.mark.parametrize("s,pose", [(1, "gentle"), (5, "gentle"), (32, "gentle"),
                                    (5, "plane_behind"), (5, "edge_on"),
                                    (32, "out_of_fov")])
def test_warp_composite_kernel_matches_plain(cuda, s, pose):
    gen = torch.Generator(device=cuda).manual_seed(1)
    n, h, w = 2, 40, 72
    rgb = torch.rand((n, s, h, w, 3), generator=gen, device=cuda)
    sigma = torch.rand((n, s, h, w, 1), generator=gen, device=cuda) * 3
    k = torch.tensor([[36.0, 0, w / 2], [0, 36.0, h / 2], [0, 0, 1]], device=cuda).expand(n, 3, 3)
    tx, ty, tz, yaw = COMPOSITE_POSES[pose]
    g = torch.eye(4, device=cuda).repeat(n, 1, 1)
    g[:, 0, 0], g[:, 0, 2], g[:, 2, 0], g[:, 2, 2] = (math.cos(yaw), math.sin(yaw),
                                                      -math.sin(yaw), math.cos(yaw))
    g[:, :3, 3] = torch.tensor([tx, ty, tz], device=cuda)
    g[1, :3, 3] *= 0.5  # the second pose differs from the first
    disparity = torch.linspace(1.0, 0.1, s, device=cuda)[None].repeat(n, 1)
    operands = (rgb, sigma, *streaming_matrices(disparity, g, inverse_3x3(k), k))
    kw.reset_launches()
    got = kw.warp_composite(*operands)
    torch.cuda.synchronize()
    assert kw.launches["warp_composite"] == 1
    torch.testing.assert_close(got, kw.warp_composite_matrix_plain(*operands),
                               rtol=1e-5, atol=1e-5)
    z = kw.composite_operands(*operands[2:], h, w)[3]
    if pose == "plane_behind":  # in the first pose
        assert bool((z[0, 0] < 0).all())
    if pose == "edge_on":
        assert bool((z < 0).any() and (z > 0).any())
    if pose == "out_of_fov":
        assert float(got[:, 5].mean()) < 0.5 * s  # fewer than half the planes in view


@pytest.mark.parametrize("s,pose", [(1, "gentle"), (16, "gentle"), (16, "plane_behind"),
                                    (16, "edge_on")])
def test_warp_composite_with_a_halo_plane_matches_plain(cuda, s, pose):
    """S + 1 planes of matrices for an S-plane payload (a plane shard but the
    last): the last plane's distance runs to the halo plane's point."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    n, h, w = 2, 40, 72
    rgb = torch.rand((n, s, h, w, 3), generator=gen, device=cuda)
    sigma = torch.rand((n, s, h, w, 1), generator=gen, device=cuda) * 3
    k = torch.tensor([[36.0, 0, w / 2], [0, 36.0, h / 2], [0, 0, 1]], device=cuda).expand(n, 3, 3)
    tx, ty, tz, yaw = COMPOSITE_POSES[pose]
    g = torch.eye(4, device=cuda).repeat(n, 1, 1)
    g[:, 0, 0], g[:, 0, 2], g[:, 2, 0], g[:, 2, 2] = (math.cos(yaw), math.sin(yaw),
                                                      -math.sin(yaw), math.cos(yaw))
    g[:, :3, 3] = torch.tensor([tx, ty, tz], device=cuda)
    disparity = torch.linspace(1.0, 0.1, s + 1, device=cuda)[None].repeat(n, 1)
    mats = streaming_matrices(disparity[:, :s], g, inverse_3x3(k), k,
                              halo_depth=1.0 / disparity[:, s])
    assert mats[0].shape == (n, s + 1, 3, 3)
    kw.reset_launches()
    got = kw.warp_composite(rgb, sigma, *mats)
    torch.cuda.synchronize()
    assert kw.launches["warp_composite"] == 1
    torch.testing.assert_close(got, kw.warp_composite_matrix_plain(rgb, sigma, *mats),
                               rtol=1e-5, atol=1e-5)
    no_halo = kw.warp_composite(rgb, sigma, *streaming_matrices(disparity[:, :s], g,
                                                                inverse_3x3(k), k))
    assert not torch.allclose(got[:, 6], no_halo[:, 6])  # the last distance differs


def test_warp_composite_refuses_a_strided_mpi(cuda):
    mpi = torch.rand((1, 2, 8, 16, 4), device=cuda)
    mats = torch.eye(3, device=cuda).expand(1, 2, 3, 3).contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kw.warp_composite(mpi[..., :3], mpi[..., 3:], mats, mats, torch.zeros((1, 3), device=cuda))


def test_kernels_refuse_what_they_cannot_take(cuda):
    src = torch.rand((1, 4, 8, 16), device=cuda)
    cx = torch.rand((1, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kw.warp_bilinear(src.double(), cx.double(), cx.double())
    with pytest.raises(ValueError, match="contiguous"):
        kw.warp_bilinear(src.transpose(2, 3).contiguous().transpose(2, 3), cx, cx)
    with pytest.raises(ValueError, match="several devices"):
        kw.warp_bilinear(src.cpu(), cx, cx)


@pytest.mark.parametrize("n,c,h,w,ho,wo", [
    (2, 3, 24, 136, 16, 130),
    (1, 4, 1, 136, 8, 20),
    (1, 4, 24, 1, 8, 20),
    (3, 4, 33, 65, 7, 300),
])
@pytest.mark.parametrize("with_coords", [False, True], ids=["src-only", "with-coords"])
def test_warp_bilinear_grad_kernel_matches_plain(cuda, n, c, h, w, ho, wo, with_coords):
    gen = torch.Generator(device=cuda).manual_seed(2)
    src = torch.rand((n, c, h, w), generator=gen, device=cuda)
    cx, cy = _coords(n, ho, wo, h, w, gen, cuda)
    g = torch.randn((n, c, ho, wo), generator=gen, device=cuda)
    kw.reset_launches()
    got = kw.warp_bilinear_grad(g, cx, cy, h, w, src if with_coords else None)
    torch.cuda.synchronize()
    assert kw.launches["warp_bilinear_grad"] == 1
    want = kw.warp_bilinear_grad_plain(g, cx, cy, h, w, src if with_coords else None)
    scale = float(want[0].abs().max())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5 * scale)
    if with_coords:
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    else:
        assert got[1] is None and got[2] is None


def test_warp_bilinear_autograd_on_the_card_matches_the_cpu(cuda):
    """grid_sample_pixel's backward on CUDA tensors (the kernel) against the
    same call on the CPU (the plain version), both cotangents."""
    from mine_tpu_torch.ops.grid_sample import grid_sample_pixel

    gen = torch.Generator().manual_seed(3)
    src = torch.rand((2, 24, 136, 3), generator=gen)
    coords = torch.rand((2, 16, 130, 2), generator=gen) * 150 - 5
    g = torch.randn((2, 16, 130, 3), generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        s = src.detach().to(dev).requires_grad_()
        c = coords.detach().to(dev).requires_grad_()
        grid_sample_pixel(s, c).backward(g.to(dev))
        grads[str(dev)] = (s.grad.cpu(), c.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_backward_kernel_refuses_what_it_cannot_take(cuda):
    g = torch.rand((1, 4, 8, 16), device=cuda)
    cx = torch.rand((1, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kw.warp_bilinear_grad(g.bfloat16(), cx, cx, 8, 16)
    with pytest.raises(ValueError, match="several devices"):
        kw.warp_bilinear_grad(g, cx.cpu(), cx, 8, 16)


def _grad_case(name, gen, dev):
    """(n, c, h, w, coords_x, coords_y, expected path) of one backward case;
    the output is 64x96 and each 64x4 tile of it (the kernel's) is one block."""
    ho, wo = 64, 96
    oy, ox = torch.meshgrid(torch.arange(ho, dtype=torch.float32, device=dev),
                            torch.arange(wo, dtype=torch.float32, device=dev), indexing="ij")
    jitter = torch.rand((2, ho, wo), generator=gen, device=dev) * 0.2
    smooth_x, smooth_y = 0.97 * ox + 0.05 * oy + 1.3 + jitter[0], 1.01 * oy - 0.03 * ox + 0.7
    h, w, path = 64, 96, "shared"
    if name == "smooth":
        cx, cy = smooth_x, smooth_y
    elif name == "minified":  # a tile's footprint is ~128x32 source pixels
        h, w, path = 256, 384, "direct"
        cx, cy = 4.0 * ox + 0.5 + jitter[0], 4.0 * oy + 0.5
    elif name == "all_clamped":  # every tap on one corner pixel
        cx, cy = -3.0 - jitter[0], h + 2.0 + jitter[1]
    elif name == "one_pixel_rows":
        h, cx, cy = 1, smooth_x, smooth_y
    elif name == "one_pixel_cols":
        w, cx, cy = 1, smooth_x, smooth_y
    elif name == "straddles_clamp":  # tiles half clamped to column 0, rows past the bottom
        cx, cy = ox - 40.0 + jitter[0], oy + 20.0
    elif name == "scattered_band":  # smooth, but 8 rows of random far-out coords
        cx, cy, path = smooth_x.clone(), smooth_y.clone(), "both"
        band = torch.rand((2, 8, wo), generator=gen, device=dev) * 300 - 100
        cx[24:32], cy[24:32] = band[0], band[1]
    n, c = 2, 4
    return n, c, h, w, cx.expand(n, ho, wo).contiguous(), cy.expand(n, ho, wo).contiguous(), path


@pytest.mark.parametrize("case", ["smooth", "minified", "all_clamped", "one_pixel_rows",
                                  "one_pixel_cols", "straddles_clamp", "scattered_band"])
@pytest.mark.parametrize("with_coords", [False, True], ids=["src-only", "with-coords"])
def test_warp_bilinear_grad_paths_match_plain(cuda, case, with_coords):
    """Each case against the plain scatter, and the path its blocks took:
    the shared-memory tile where a tile's footprint fits, global atomics
    where it does not, both in one launch for the scattered band."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    n, c, h, w, cx, cy, path = _grad_case(case, gen, cuda)
    src = torch.rand((n, c, h, w), generator=gen, device=cuda)
    g = torch.randn((n, c) + tuple(cx.shape[1:]), generator=gen, device=cuda)
    kw.reset_launches()
    got = kw.warp_bilinear_grad(g, cx, cy, h, w, src if with_coords else None)
    blocks = kw.grad_path_blocks()
    want = kw.warp_bilinear_grad_plain(g, cx, cy, h, w, src if with_coords else None)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                               atol=1e-5 * float(want[0].abs().max()))
    if with_coords:
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    assert blocks["shared"] + blocks["direct"] == n * 16 * 2  # 64x96 in 64x4 tiles
    if path == "shared":
        assert blocks["direct"] == 0, blocks
    elif path == "direct":
        assert blocks["shared"] == 0, blocks
    else:
        assert blocks["shared"] > 0 and blocks["direct"] > 0, blocks


@pytest.mark.parametrize("pose,use_alpha", [("gentle", False), ("edge_on", False),
                                            ("gentle", True)])
def test_streaming_render_gradients_match_the_plain_scan(cuda, pose, use_alpha):
    """The streaming render's backward on the card (its chunked scan through
    the warp and its backward kernels) against the same scan on their plain
    versions, and the launches it made: K5 once for a sigma MPI's forward
    (the scan for an alpha MPI's), K1 2 S/chunk - 1 times, K2 S/chunk times.
    The backward kernel's atomics reorder sums: atol 1e-5 of max |grad|."""
    from mine_tpu_torch.ops import mpi_render as mr

    gen = torch.Generator(device=cuda).manual_seed(5)
    n, s, h, w, chunk = 2, 8, 40, 72, 4
    k = torch.tensor([[36.0, 0, w / 2], [0, 36.0, h / 2], [0, 0, 1]], device=cuda).expand(n, 3, 3)
    tx, ty, tz, yaw = COMPOSITE_POSES[pose]
    g = torch.eye(4, device=cuda).repeat(n, 1, 1)
    g[:, 0, 0], g[:, 0, 2], g[:, 2, 0], g[:, 2, 2] = (math.cos(yaw), math.sin(yaw),
                                                      -math.sin(yaw), math.cos(yaw))
    g[:, :3, 3] = torch.tensor([tx, ty, tz], device=cuda)
    rest = (torch.linspace(1.0, 0.1, s, device=cuda)[None].repeat(n, 1), g,
            inverse_3x3(k).contiguous(), k.contiguous())
    rgb = torch.rand((n, s, h, w, 3), generator=gen, device=cuda)
    sigma = torch.rand((n, s, h, w, 1), generator=gen, device=cuda) * (0.9 if use_alpha else 3)
    c_rgb = torch.randn((n, h, w, 3), generator=gen, device=cuda)

    def grads():
        r, sg = rgb.clone().requires_grad_(), sigma.clone().requires_grad_()
        out = mr.render_tgt_rgb_depth_streaming(r, sg, *rest, use_alpha=use_alpha,
                                                chunk_planes=chunk)
        (torch.sum(out[0] * c_rgb) + torch.sum(out[1])).backward()
        return r.grad, sg.grad

    kw.reset_launches()
    got = grads()
    torch.cuda.synchronize()
    n_chunks = s // chunk
    assert kw.launches == {
        "warp_composite": 0 if use_alpha else 1,
        "warp_bilinear": 2 * n_chunks - 1 + (n_chunks if use_alpha else 0),
        "warp_bilinear_grad": n_chunks}
    kernels = kw._warp_bilinear_forward, kw.warp_bilinear_grad
    kw._warp_bilinear_forward, kw.warp_bilinear_grad = (kw.warp_bilinear_plain,
                                                        kw.warp_bilinear_grad_plain)
    try:
        want = grads()
    finally:
        kw._warp_bilinear_forward, kw.warp_bilinear_grad = kernels
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_one_llff_fixture_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One Trainer step on the LLFF fixture (the port's own writer, read by
    the port's loader), small configuration (128x128, ResNet-18, S=4, B=2,
    fp32, TF32 off), batches staged in page-locked memory
    (data.num_workers 2): K1 and K2 launch 4 times (one render per scale)
    and the loss agrees with the same step on the CPU to rel 1e-4 (cuDNN's
    and the CPU's convolutions sum in other orders)."""
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.data.conformance.fixtures import write_fixture
    from mine_tpu_torch.data.registry import build_dataset
    from mine_tpu_torch.models.mpi import init_weights
    from mine_tpu_torch.training.loop import Trainer, staged_batches
    from mine_tpu_torch.training.step import build_model

    path = write_fixture("llff", str(tmp_path), n_views=4)
    cfg = Config().replace(**{
        "data.training_set_path": path, "data.img_h": 128, "data.img_w": 128,
        "data.img_pre_downsample_ratio": 1.0, "data.per_gpu_batch_size": 2,
        "data.visible_point_count": 32, "data.num_workers": 2, "model.num_layers": 18,
        "model.dtype": "float32", "mpi.num_bins_coarse": 4})
    ds = build_dataset(cfg, "train", 2)
    batches = staged_batches(ds.epoch(1), cuda, 2)
    assert all(v.is_pinned() for v in next(batches).values())
    batches.close()
    state = init_weights(build_model(cfg), torch.Generator().manual_seed(4)).state_dict()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        losses = {}
        for where in ("cuda", "cpu"):
            kw.reset_launches()
            losses[where] = Trainer(cfg, device=where, state_dict=state).fit(ds, max_steps=1)
            if where == "cuda":
                torch.cuda.synchronize()
                assert kw.launches == {"warp_bilinear": 4, "warp_bilinear_grad": 4,
                                       "warp_composite": 0}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert math.isfinite(losses["cuda"]["loss"])
    assert losses["cuda"]["loss"] == pytest.approx(losses["cpu"]["loss"], rel=1e-4)
