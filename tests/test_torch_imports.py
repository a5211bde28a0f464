"""The port stands alone: no module of mine_tpu_torch, and not chip_smoke.py,
imports jax, flax or anything of the JAX package mine_tpu; and its entry
points never land on the CPU unless asked."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "mine_tpu"}


def _port_files() -> list[str]:
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mine_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = {os.path.relpath(f, REPO): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_only_the_workspace_exporter_imports_both_packages():
    """Outside the tests, the one file that imports both the port and the
    JAX package is tools/jax_workspace_to_torch.py (it runs where orbax
    does)."""
    both = []
    for root, dirs, names in os.walk(REPO):
        dirs[:] = [d for d in dirs if d not in {".git", "tests", "build"}]
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                if {"mine_tpu", "mine_tpu_torch"} <= _imported_roots(path):
                    both.append(os.path.relpath(path, REPO))
    assert both == [os.path.join("tools", "jax_workspace_to_torch.py")]


def test_import_and_cpu_run_leave_jax_unloaded(tmp_path):
    """Import every module of the port and run a CPU predict/render and a
    CPU train step in a fresh interpreter; neither jax nor mine_tpu may end
    up loaded."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np, torch
        import mine_tpu_torch
        for mod in pkgutil.walk_packages(mine_tpu_torch.__path__, "mine_tpu_torch."):
            importlib.import_module(mod.name)
        from mine_tpu_torch.config import Config
        from mine_tpu_torch.models.mpi import init_weights
        from mine_tpu_torch.serving.engine import RenderEngine
        from mine_tpu_torch.training.step import build_model
        cfg = Config().replace(**{"data.img_h": 128, "data.img_w": 128,
                                  "model.num_layers": 18, "mpi.num_bins_coarse": 2})
        state = init_weights(build_model(cfg), torch.Generator().manual_seed(0)).state_dict()
        engine = RenderEngine(cfg, state, device="cpu")
        rgb, disp = engine.render(engine.predict(np.zeros((64, 64, 3), np.uint8)),
                                  np.eye(4, dtype=np.float32)[None])
        assert rgb.shape == (1, 128, 128, 3) and np.isfinite(rgb).all()
        from mine_tpu_torch.data.registry import build_dataset
        from mine_tpu_torch.training.loop import Trainer
        cfg = cfg.replace(**{"data.name": "synthetic", "data.per_gpu_batch_size": 1,
                             "data.visible_point_count": 8, "model.dtype": "float32"})
        trainer = Trainer(cfg, device="cpu")
        logged = trainer.fit(build_dataset(cfg, "train", 1), max_steps=1)
        assert np.isfinite(logged["loss"])
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "mine_tpu"))
        print("LOADED", loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one_torch_thread, for the script
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA refusal cannot show")
    from mine_tpu_torch.config import Config
    from mine_tpu_torch.serving.engine import RenderEngine
    from mine_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        RenderEngine(Config().replace(**{"model.num_layers": 18}), {})
    from mine_tpu_torch import train
    from mine_tpu_torch.training.loop import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config().replace(**{"model.num_layers": 18}))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--extra_config", '{"data.name": "synthetic", "model.num_layers": 18}'])


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, and in a directory holding chip_smoke.py alone, the
    smoke run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script in (os.path.join(REPO, "chip_smoke.py"), str(alone)):
        out = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


QUALITY_TOOLS = ("convergence_run", "oracle_mpi_ceiling", "disocclusion_analysis",
                 "e2e_quality_run")


def test_quality_harnesses_and_the_verdict_stand_alone(tmp_path):
    """mine_tpu_torch/tools/ (each JAX tools/ harness's counterpart, by file
    name) and utils/verdict.py import no jax, flax, mine_tpu, and nothing of
    the repository's root tools/ either; importing them and showing each
    harness's help leaves all of those unloaded."""
    files = [os.path.join(REPO, "mine_tpu_torch", "utils", "verdict.py")]
    files += [os.path.join(REPO, "mine_tpu_torch", "tools", f"{name}.py")
              for name in ("__init__",) + QUALITY_TOOLS]
    for name in QUALITY_TOOLS:
        assert os.path.exists(os.path.join(REPO, "tools", f"{name}.py"))
    bad = {os.path.relpath(f, REPO): sorted(_imported_roots(f) & (FORBIDDEN | {"tools"}))
           for f in files}
    assert not {f: m for f, m in bad.items() if m}
    script = textwrap.dedent(f"""
        import contextlib, importlib, io, sys
        importlib.import_module("mine_tpu_torch.utils.verdict")
        for name in {QUALITY_TOOLS!r}:
            mod = importlib.import_module("mine_tpu_torch.tools." + name)
            with contextlib.redirect_stdout(io.StringIO()):
                try:
                    mod.main(["--help"])
                except SystemExit as exc:
                    assert exc.code == 0, (name, exc.code)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "mine_tpu", "tools"))
        print("LOADED", loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
