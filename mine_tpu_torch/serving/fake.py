"""FakeEngine: the serving stack with the network and the compositor stubbed
(the port's own copy of mine_tpu/serving/fake.py).

Hot swaps, digest routing, health-gated membership, failover, peer fetch,
the brownout ladder and autoscaling are control-plane logic whose
correctness has nothing to do with the model. `FakeEngine` subclasses the
port's RenderEngine, so bucket validation, the weight-generation machinery
(`swap_weights`' validate, place, verify, flip), compression, first-dispatch
accounting and metrics are the real code; only the dispatches are replaced:

    app = make_fake_app(checkpoint_step=3, device="cpu",
                        swap_source=lambda: fake_checkpoint(4))
    server = make_server(app)   # the real HTTP surface

The slabs are the JAX fake's, bit for bit: digest-seeded and not constant.
Sigma carries a fronto-parallel surface at a random plane (a Gaussian plane
profile times a low-frequency spatial bump), so compression and
transmittance pruning have real work. rgb carries the generation marker:
every plane's pixel (0, 0) channel 0 is the checkpoint step the weights came
from, and a fake render fills its frames with it (clipped to [0, 1]), read
from the entry's last plane, which pruning always keeps: exact under the
fp32 and bf16 tiers, within a quantization step under int8.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.serving.cache import MPIEntry
from mine_tpu_torch.serving.compress import CompressedMPI
from mine_tpu_torch.serving.engine import RenderEngine


def fake_variables(checkpoint_step: int = 0) -> dict[str, torch.Tensor]:
    """A FakeEngine's state dict: one fixed-shape tensor whose value is the
    step, so that swaps between fake checkpoints validate like real
    same-architecture ones and the generations stay distinguishable."""
    return {"w": torch.full((4,), float(checkpoint_step))}


def fake_checkpoint(checkpoint_step: int) -> tuple[dict[str, torch.Tensor], int]:
    """A swap source's payload: (state_dict, step)."""
    return fake_variables(checkpoint_step), checkpoint_step


class _FakeNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.zeros(4))


def fake_slabs(image: np.ndarray, h: int, w: int, s: int,
               fill: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mpi_rgb (1,S,H,W,3), mpi_sigma (1,S,H,W,1), disparity (1,S)) fp32 for
    one image: the same image always gives the same slabs."""
    seed = int.from_bytes(hashlib.sha256(
        np.ascontiguousarray(np.asarray(image)).tobytes()).digest()[:8], "big")
    rng = np.random.default_rng(seed)
    planes = np.arange(s, dtype=np.float32)
    # in front of the surface alpha is tiny, behind it the transmittance is
    # about 0: both prunable; the bump gives quantization structure
    surface = float(rng.uniform(0.25, 0.75)) * max(s - 1, 1)
    width = max(s / 8.0, 0.75)
    profile = np.exp(-(((planes - surface) / width) ** 2))
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, h), np.linspace(0.0, 1.0, w), indexing="ij")
    bump = 0.5 + 0.5 * np.sin(2.0 * np.pi * (xx * rng.uniform(1.0, 3.0)
                                             + yy * rng.uniform(1.0, 3.0) + rng.uniform()))
    mpi_sigma = (8.0 * profile[None, :, None, None, None]
                 * (0.25 + 0.75 * bump[None, None, :, :, None])).astype(np.float32)
    mpi_rgb = (fill + 0.05 * rng.standard_normal((1, s, h, w, 3))).astype(np.float32)
    mpi_rgb[0, :, 0, 0, 0] = fill
    disparity = np.linspace(1.0, 0.01, s, dtype=np.float32)[None]
    return mpi_rgb, mpi_sigma, disparity


class FakeEngine(RenderEngine):
    """RenderEngine whose predict makes `fake_slabs` and whose render fills
    constant frames. `render_delay_s` / `predict_delay_s` are mutable knobs
    for overload scenarios; a pruned entry's render delay shrinks with its
    planes, as a smaller plane bucket's would."""

    def __init__(self, cfg: Config | None = None, checkpoint_step: int = 0,
                 render_delay_s: float = 0.0, predict_delay_s: float = 0.0, **kwargs: Any):
        if cfg is None:
            cfg = Config().replace(**{"data.img_h": 128, "data.img_w": 128,
                                      "mpi.num_bins_coarse": 2})
        super().__init__(cfg, fake_variables(checkpoint_step),
                         checkpoint_step=checkpoint_step, **kwargs)
        self.render_delay_s = render_delay_s
        self.predict_delay_s = predict_delay_s

    def _place(self, state_dict: Mapping[str, torch.Tensor]) -> torch.nn.Module:
        model = _FakeNet()
        model.load_state_dict(state_dict)
        return model.to(self.device)

    def _dispatch_predict(self, bucket, image: np.ndarray, model: torch.nn.Module):
        """(mpi_rgb, mpi_sigma, disparity) on the device; the first call per
        bucket counts as its first dispatch."""
        self._first_dispatch(bucket, "predict", None)
        if self.predict_delay_s:
            time.sleep(self.predict_delay_s)
        h, w, s = bucket.spec
        slabs = fake_slabs(image, h, w, s, float(model.w[0]))
        return tuple(torch.from_numpy(a).to(self.device) for a in slabs)

    def _dispatch_render(self, bucket, rgb, sigma, disparity, k, padded: np.ndarray):
        """Frames filled with the entry's marker, read from its last plane
        (the front planes may be padding)."""
        self._first_dispatch(bucket, "render", (int(rgb.shape[1]), padded.shape[0]))
        n = padded.shape[0]
        h, w, _ = bucket.spec
        fill = float(torch.clamp(rgb[0, -1, 0, 0, 0], 0.0, 1.0))
        return (torch.full((n, h, w, 3), fill, device=rgb.device),
                torch.full((n, h, w, 1), 0.5, device=rgb.device))

    def render(self, entry: MPIEntry | CompressedMPI,
               poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self.render_delay_s:
            delay = self.render_delay_s
            if isinstance(entry, CompressedMPI) and entry.num_planes_full:
                delay *= entry.planes_kept / entry.num_planes_full
            time.sleep(delay)
        return super().render(entry, poses)


def make_fake_app(checkpoint_step: int = 0, swap_source: Callable | str | None = None,
                  render_delay_s: float = 0.0, predict_delay_s: float = 0.0,
                  cfg: Config | None = None, device: torch.device | str | None = None,
                  **app_kwargs: Any):
    """A full ServingApp (the real cache, batcher, breaker, metrics, ladder
    and HTTP wiring) over a FakeEngine. Extra kwargs go to ServingApp."""
    from mine_tpu_torch.serving.server import ServingApp

    engine = FakeEngine(cfg=cfg, checkpoint_step=checkpoint_step,
                        render_delay_s=render_delay_s, predict_delay_s=predict_delay_s,
                        device=device)
    app_kwargs.setdefault("max_delay_ms", 0.0)
    return ServingApp(engine.base_cfg, engine=engine, swap_source=swap_source, **app_kwargs)
