"""Train -> workspace -> serve -> frames, on the CPU: 2 steps of the LLFF
recipe (tiny shapes) from the LLFF fixture, then the workspace is rendered
by `python -m mine_tpu_torch.infer --checkpoint`, restored by
load_for_serving, hot-swapped into a live ServingApp, and served by the
serving CLI through the conformance runner's serve stage."""

import json
import os

import numpy as np
import pytest
import torch

from mine_tpu_torch import infer
from mine_tpu_torch.config import load_config
from mine_tpu_torch.data.conformance import write_fixture
from mine_tpu_torch.data.conformance.runner import serve_stage
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.inference import video
from mine_tpu_torch.inference.trajectory import camera_trajectories
from mine_tpu_torch.models.mpi import init_weights
from mine_tpu_torch.serving.server import ServingApp
from mine_tpu_torch.training import checkpoint as ckpt
from mine_tpu_torch.training.loop import Trainer
from mine_tpu_torch.training.step import build_model
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"data.img_h": 128, "data.img_w": 128, "data.img_pre_downsample_ratio": 1.0,
        "data.per_gpu_batch_size": 2, "data.visible_point_count": 16, "data.num_workers": 0,
        "model.num_layers": 18, "model.dtype": "float32", "mpi.num_bins_coarse": 2,
        "training.checkpoint_interval": 1, "training.log_interval": 1}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_ws")
    path = write_fixture("llff", str(root / "fixture"))
    cfg = load_config(os.path.join(REPO, "mine_tpu", "configs", "default.yaml"),
                      os.path.join(REPO, "mine_tpu", "configs", "llff.yaml"),
                      overrides={**TINY, "data.training_set_path": path})
    ws = str(root / "ws")
    trainer = Trainer(cfg, ws, device="cpu")
    trainer.fit(build_dataset(cfg, "train", 2), max_steps=2)
    assert ckpt.all_steps(ws) == [1, 2]
    image = np.random.default_rng(3).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    return {"ws": ws, "cfg": cfg, "image": image, "root": root}


def test_infer_checkpoint_renders_the_state_dicts_frames(workspace, monkeypatch, tmp_path):
    """The infer CLI on the workspace writes the frames a VideoGenerator on
    the newest checkpoint's model state dict renders."""
    from PIL import Image

    ws, image = workspace["ws"], workspace["image"]
    img_path = tmp_path / "photo.png"
    Image.fromarray(image).save(img_path)
    written_frames = {}

    def capture(frames, path, fps=30):
        written_frames[os.path.basename(path)] = np.asarray(frames)
        return path

    monkeypatch.setattr(video, "write_video", capture)
    written = infer.main(["--checkpoint", ws, "--image", str(img_path),
                          "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert len(written) == 4 and len(written_frames) == 4

    state = ckpt.load(ws, 2)["model"]
    generator = video.VideoGenerator(workspace["cfg"], state, np.asarray(
        Image.open(img_path).convert("RGB")), device="cpu")
    trajectories, _ = camera_trajectories(workspace["cfg"].data.name)
    for name, poses in trajectories:
        rgb, _ = generator.render_poses(poses)
        np.testing.assert_array_equal(written_frames[f"photo_{name}_rgb.mp4"],
                                      video.to_uint8(rgb))
    with pytest.raises(SystemExit):
        infer.main(["--checkpoint", ws, "--config", "x.yaml", "--image", str(img_path),
                    "--output_dir", str(tmp_path / "out"), "--device", "cpu"])


def test_load_for_serving_restores_the_model_only(workspace):
    ws, cfg = workspace["ws"], workspace["cfg"]
    got_cfg, state, step = ckpt.load_for_serving(ws)
    assert step == 2 and got_cfg == ckpt.load_paired_config(ws)
    full = ckpt.load(ws, 2)
    assert set(full) > {"model"}  # the optimizer state is in the file
    assert set(state) == set(build_model(cfg).state_dict())
    assert all(torch.equal(state[k], full["model"][k]) for k in state)
    _, state1, step1 = ckpt.load_for_serving(ws, step=1)
    assert step1 == 1 and not all(torch.equal(state1[k], state[k]) for k in state)
    with pytest.raises(FileNotFoundError, match="retained"):
        ckpt.load_for_serving(ws, step=7)
    expected = {**state, "extra.weight": torch.zeros(2)}
    with pytest.raises(ckpt.CheckpointTreeMismatch, match="missing leaf extra.weight"):
        ckpt.load_for_serving(ws, expected_state=expected)
    overrides = json.dumps({"serving.cache_tier": "int8"})
    assert ckpt.load_for_serving(ws, overrides=overrides)[0].serving.cache_tier == "int8"


def test_load_for_serving_without_a_checkpoint(workspace, tmp_path):
    ckpt.save_paired_config(workspace["cfg"], str(tmp_path))
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        ckpt.load_for_serving(str(tmp_path))
    _, state, step = ckpt.load_for_serving(str(tmp_path), allow_random_init=True)
    want = init_weights(build_model(workspace["cfg"]), torch.Generator().manual_seed(0))
    assert step == 0
    assert all(torch.equal(state[k], v) for k, v in want.state_dict().items())


def test_a_flipped_byte_is_refused_before_parsing(workspace, tmp_path):
    import shutil

    ws = str(tmp_path / "ws")
    shutil.copytree(workspace["ws"], ws)
    path = os.path.join(ckpt.checkpoint_path(ws), "2", ckpt.STATE_FILE)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ckpt.CheckpointCorrupt, match="state.pt"):
        ckpt.load_for_serving(ws)
    # a server on step 1 refuses to swap to it, and keeps serving step 1
    cfg, state, step = ckpt.load_for_serving(ws, step=1)
    app = ServingApp(cfg, state, checkpoint_step=step, device="cpu", swap_source=ws)
    try:
        status = app.swap(wait=True)
        assert status["state"] == "failed" and status["reason"] == "corrupt"
        assert app.engine.generation == 0 and app.engine.checkpoint_step == 1
        assert app.metrics.swap_failures.value(reason="corrupt") == 1
    finally:
        app.close()


def test_promotion_watch_swaps_to_the_vetted_step(workspace):
    ws = workspace["ws"]
    cfg, state, _ = ckpt.load_for_serving(ws, step=1)
    app = ServingApp(cfg, state, checkpoint_step=1, device="cpu", swap_source=ws)
    try:
        ckpt.mark_last_good(ws, 1)
        assert app.maybe_promote() is None  # nothing newer is vetted
        ckpt.mark_last_good(ws, 2)
        status = app.maybe_promote()
        assert status["state"] == "ok" and status["swapped_to_step"] == 2
        assert (app.engine.generation, app.engine.checkpoint_step) == (1, 2)
        assert app.maybe_promote() is None
    finally:
        app.close()


def test_params_yaml_loads_in_both_packages(workspace, tmp_path):
    """The port's params.yaml (with the serving, obs and resilience keys it
    now writes) loads in the JAX package, and a JAX params.yaml in the port."""
    from mine_tpu.config import load_config as jax_load_config
    from mine_tpu.config import save_config as jax_save_config
    from mine_tpu_torch.config import to_flat_dict

    port_yaml = os.path.join(workspace["ws"], "params.yaml")
    jcfg = jax_load_config(port_yaml)
    assert jcfg.serving.cache_tier == workspace["cfg"].serving.cache_tier
    assert jcfg.resilience.breaker_reset_jitter == workspace["cfg"].resilience.breaker_reset_jitter
    jax_save_config(jcfg, str(tmp_path / "jax.yaml"))
    assert to_flat_dict(load_config(str(tmp_path / "jax.yaml"))) == \
        to_flat_dict(load_config(port_yaml))


def test_entry_points_need_cuda_unless_asked(workspace, tmp_path):
    from PIL import Image

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA refusal cannot show")
    img_path = tmp_path / "photo.png"
    Image.fromarray(workspace["image"]).save(img_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.main(["--checkpoint", workspace["ws"], "--image", str(img_path),
                    "--output_dir", str(tmp_path / "out")])


def test_conformance_cli_runs_the_contract_stage(tmp_path, capsys):
    from mine_tpu_torch.data.conformance.__main__ import main

    assert main(["--configs", "llff", "--stages", "contract", "--workdir",
                 str(tmp_path), "--out", str(tmp_path / "verdicts")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and summary["configs_checked"] == 1
    assert os.path.exists(tmp_path / "verdicts" / "llff.json")
    with pytest.raises(SystemExit):
        main(["--stages", "nonsense"])


def test_conformance_serve_stage_on_the_cpu(workspace, monkeypatch):
    """The serving CLI as a subprocess over the workspace: one predict ->
    render -> healthz round over HTTP."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    result = serve_stage(workspace["ws"], timeout_s=240.0, device="cpu")
    assert result["ok"], result
    assert result["checkpoint_step"] == 2 and result["backend"] == "cpu"
    assert result["mpi_key"].endswith(":2:128:128:2:fp32")
