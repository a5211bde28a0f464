"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; without them each test skips with its
reason. The file imports no JAX, so on a machine without JAX it runs apart
from the suite's conftest (which sets up JAX devices):
`PYTHONPATH=. python -m pytest tests/test_torch_cuda.py -q --noconftest`.
Tolerance 1e-5: kernel
and plain version do the same fp32 arithmetic, the kernel with fused
multiply-adds. The backward kernel adds into the source cotangent with
atomics, in an order that changes from run to run: it is held at rtol 1e-5
and atol 1e-5 of the largest |grad_src|.
"""

import pytest
import torch

from mine_tpu_torch.ops.kernels import warp as kw

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


def test_warp_composite_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    n, s, c, h, w, ho, wo = 2, 5, 4, 24, 136, 16, 130
    src = torch.rand((n, s, c, h, w), generator=gen, device=cuda) * 2
    cx, cy = (t.reshape(n, s, ho, wo) for t in _coords(n * s, ho, wo, h, w, gen, cuda))
    dist = torch.rand((n, s, ho, wo), generator=gen, device=cuda) + 0.05
    z = torch.rand((n, s, ho, wo), generator=gen, device=cuda) * 3.5 - 0.5
    got = kw.warp_composite(src, cx, cy, dist, z)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kw.warp_composite_plain(src, cx, cy, dist, z),
                               rtol=1e-5, atol=1e-5)


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
