"""The port's serving slice end to end against the JAX package: predict once
(network + source-RGB blending), render many, through both compositors, the
RenderEngine and the VideoGenerator, at 128x128, S=4, ResNet-18, fp32.

Tolerances: rendered rgb atol 1e-3 and disparity rtol 1e-3 — the network's
fp32 convolutions sum in another order than XLA's (see test_torch_model.py),
and that difference reaches the frames through sigmoid and exp. The image
goes in at the bucket size, so no resize enters; resizing has its own test.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mine_tpu.config import Config as JaxConfig
from mine_tpu.config import load_config as jax_load_config
from mine_tpu.config import to_flat_dict as jax_flat_dict
from mine_tpu.inference import video as jvideo
from mine_tpu.inference.trajectory import camera_trajectories
from mine_tpu.training.step import build_model as jax_build_model
from mine_tpu.training.step import make_disparity_list as jax_disparity
from mine_tpu_torch.config import Config, load_config, to_flat_dict
from mine_tpu_torch.inference import video
from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
from mine_tpu_torch.serving import engine as engine_mod
from mine_tpu_torch.serving.engine import RenderEngine
from mine_tpu_torch.training.step import build_model
from tests.test_torch_model import random_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
S = 4
TINY = {"data.img_h": H, "data.img_w": W, "model.num_layers": 18,
        "model.dtype": "float32", "mpi.num_bins_coarse": S}
CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "mine_tpu", "configs")


@pytest.fixture(scope="module")
def weights():
    """(JAX variables, the same weights as a port state dict)."""
    jcfg = JaxConfig().replace(**TINY)
    variables = random_jax_variables(
        jax_build_model(jcfg), jnp.zeros((1, H, W, 3)), jnp.ones((1, S)), seed=11
    )
    return variables, jax_variables_to_torch(flatten_variables(variables), 18)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).integers(0, 256, (H, W, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def poses():
    (_, zoom), (_, swing) = camera_trajectories("llff")[0]
    return np.stack([zoom[30], swing[10], swing[50]])


def _jax_slice(compositor, variables, image, poses):
    cfg = JaxConfig().replace(**TINY, **{"mpi.compositor": compositor})
    img = jvideo.prepare_image(image, H, W)
    k = jnp.asarray(jvideo.fov_intrinsics(H, W))[None]
    disparity = jax_disparity(cfg.replace(**{"mpi.fix_disparity": True}),
                              jax.random.PRNGKey(0), 1)
    rgb, sigma = jvideo.predict_blended_mpi(cfg, variables, img, disparity, k)
    out = jvideo.render_many(cfg, rgb, sigma, disparity, k, jnp.asarray(poses))
    return np.asarray(rgb), np.asarray(sigma), np.asarray(out[0]), np.asarray(out[1])


def _assert_frames(got_rgb, got_disp, want_rgb, want_disp):
    np.testing.assert_allclose(got_rgb, want_rgb, rtol=0, atol=1e-3, err_msg="rgb")
    np.testing.assert_allclose(got_disp, want_disp, rtol=1e-3, atol=1e-6,
                               err_msg="disparity")


@pytest.mark.parametrize("compositor", ["dense", "streaming"])
def test_predict_and_render_match_jax(weights, image, poses, compositor):
    variables, state = weights
    want = _jax_slice(compositor, variables, image, poses)

    cfg = Config().replace(**TINY, **{"mpi.compositor": compositor})
    model = build_model(cfg)
    model.load_state_dict(state)
    img = video.prepare_image(image, H, W, "cpu")
    k = torch.from_numpy(video.fov_intrinsics(H, W))[None]
    disparity = torch.from_numpy(np.array(jax_disparity(
        JaxConfig().replace(**TINY, **{"mpi.fix_disparity": True}), jax.random.PRNGKey(0), 1)))
    rgb, sigma = video.predict_blended_mpi(cfg, model, img, disparity, k)
    np.testing.assert_allclose(rgb.numpy(), want[0], rtol=1e-3, atol=1e-4, err_msg="mpi rgb")
    np.testing.assert_allclose(sigma.numpy(), want[1], rtol=1e-3,
                               atol=1e-4 * max(1.0, float(np.abs(want[1]).max())),
                               err_msg="mpi sigma")
    out_rgb, out_disp = video.render_many(cfg, rgb, sigma, disparity, k,
                                          torch.from_numpy(poses))
    _assert_frames(out_rgb.numpy(), out_disp.numpy(), want[2], want[3])


def test_render_engine_matches_jax(weights, image, poses, monkeypatch):
    variables, state = weights
    want = _jax_slice("streaming", variables, image, poses)
    cfg = Config().replace(**TINY)
    engine = RenderEngine(cfg, state, device="cpu")
    assert engine.compositor == "streaming"

    dispatched = []
    real = engine_mod.render_many

    def spy(cfg_, *args):
        dispatched.append((cfg_.mpi.compositor, args[-1].shape[0]))
        return real(cfg_, *args)

    monkeypatch.setattr(engine_mod, "render_many", spy)
    entry = engine.predict(image)
    assert entry.bucket == (H, W, S) and entry.mpi_rgb.shape == (1, S, H, W, 3)
    assert entry.nbytes == 4 * (S * H * W * 4 + S + 9)
    rgb, disp = engine.render(entry, poses)
    assert dispatched == [("streaming", 4)]  # 3 poses ride the padded 4-bucket
    assert rgb.shape == (3, H, W, 3) and disp.shape == (3, H, W, 1)
    _assert_frames(rgb, disp, want[2], want[3])


def test_render_engine_chunks_past_the_largest_bucket(weights, image, poses):
    _, state = weights
    engine = RenderEngine(Config().replace(**TINY), state, pose_buckets=(1, 2),
                          device="cpu")
    entry = engine.predict(image)
    many = np.concatenate([poses, poses[:2]])  # 5 poses -> chunks of 2, 2, 1
    rgb, disp = engine.render(entry, many)
    one_rgb, one_disp = engine.render(entry, poses[:1])
    assert rgb.shape == (5, H, W, 3)
    np.testing.assert_allclose(rgb[3], one_rgb[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(disp[3], one_disp[0], rtol=1e-6, atol=0)
    empty_rgb, _ = engine.render(entry, np.zeros((0, 4, 4), np.float32))
    assert empty_rgb.shape == (0, H, W, 3)
    with pytest.raises(ValueError, match="multiples of 128"):
        engine.bucket((100, 128, 4))
    with pytest.raises(ValueError, match=r"\(N, 4, 4\)"):
        engine.render(entry, np.zeros((2, 3, 4), np.float32))


def test_video_generator_matches_jax(weights, image, poses):
    variables, state = weights
    want = _jax_slice("dense", variables, image, poses)
    cfg = Config().replace(**TINY)
    gen = video.VideoGenerator(cfg, state, image, device="cpu")
    rgb, disp = gen.render_poses(poses)
    _assert_frames(rgb, disp, want[2], want[3])


def test_bf16_network_gives_fp32_mpis(weights, image):
    """model.dtype bfloat16 runs the network under autocast; the MPI is fp32
    and within bf16 rounding (5e-2) of the fp32 network's."""
    _, state = weights
    mpis = {}
    for dtype in ("float32", "bfloat16"):
        engine = RenderEngine(Config().replace(**{**TINY, "model.dtype": dtype}), state,
                              device="cpu")
        mpis[dtype] = engine.predict(image)
    for field in ("mpi_rgb", "mpi_sigma"):
        got = getattr(mpis["bfloat16"], field)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), getattr(mpis["float32"], field).numpy(),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("src_hw", [(300, 200), (77, 93), (128, 128)])
def test_prepare_image_matches_jax_resize(src_hw):
    """Both resize bilinearly with antialiasing on downsampling (torch's
    antialias=True, jax.image.resize's default). The two implement the
    triangle filter separately, so they agree to 2e-5, not bit for bit."""
    image = np.random.default_rng(2).integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    got = video.prepare_image(image, H, W, "cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jvideo.prepare_image(image, H, W)),
                               rtol=0, atol=2e-5)


def test_infer_cli_writes_videos(weights, tmp_path):
    from PIL import Image

    from mine_tpu_torch import infer

    variables, _ = weights
    npz = tmp_path / "vars.npz"
    np.savez(npz, **flatten_variables(variables))
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text("".join(f"{k}: {v}\n" for k, v in {
        **TINY, "mpi.num_bins_coarse": 2}.items()))
    img_path = tmp_path / "photo.png"
    Image.fromarray(np.full((96, 160, 3), 128, np.uint8)).save(img_path)
    written = infer.main(["--weights", str(npz), "--config", str(cfg_path),
                          "--image", str(img_path), "--output_dir", str(tmp_path / "out"),
                          "--device", "cpu"])
    assert len(written) == 4 and all(os.path.exists(p) for p in written)
    assert any("zoom-in_rgb" in p for p in written)
    with pytest.raises(SystemExit):
        infer.main(["--config", str(cfg_path), "--image", str(img_path),
                    "--output_dir", str(tmp_path / "out"), "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(CONFIGS_DIR) if f.endswith(".yaml")))
def test_config_files_load_as_in_jax(name):
    """The shipped YAMLs, read as data files, give the port every key and
    value the JAX loader gives, in every group: since the parallel slice the
    `parallel` group is ported too, so the two flat dicts are equal."""
    paths = [os.path.join(CONFIGS_DIR, "default.yaml"), os.path.join(CONFIGS_DIR, f"{name}.yaml")]
    got = to_flat_dict(load_config(*paths))
    want = jax_flat_dict(jax_load_config(*paths))
    assert got == want


def test_obs_and_resilience_keys_are_honoured_or_named():
    """No obs.* or resilience.* key is dropped on load: obs.enabled and
    resilience.preempt_save reach the config, an unknown key of either group
    raises, and the multi-host keys, honoured since the parallel slice
    (resilience/multihost.py), reach the config and are not refused."""
    from mine_tpu_torch.config import ResilienceConfig, unsupported_training_options

    default = os.path.join(CONFIGS_DIR, "default.yaml")
    cfg = load_config(default, overrides={"obs.enabled": True,
                                          "resilience.preempt_save": False})
    assert cfg.obs.enabled is True and cfg.resilience.preempt_save is False
    assert load_config(default).resilience.preempt_save is True
    assert unsupported_training_options(load_config(default)) == []
    for key in ("obs.no_such_key", "resilience.no_such_key"):
        with pytest.raises(KeyError, match="unknown config key"):
            load_config(default, overrides={key: 1})
    for key, value in (("resilience.multihost_watchdog_s", 30.0),
                       ("resilience.multihost_heartbeat_dir", "/shared/hb"),
                       ("resilience.multihost_bringup_attempts", 5),
                       ("resilience.multihost_bringup_backoff_s", 0.5)):
        cfg = load_config(default, overrides={key: value})
        assert getattr(cfg.resilience, key.split(".")[1]) == value
        assert getattr(ResilienceConfig(), key.split(".")[1]) != value
        assert unsupported_training_options(cfg) == []
