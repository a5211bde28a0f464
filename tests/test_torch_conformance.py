"""The port's conformance subsystem (mine_tpu_torch/data/conformance)
against the JAX package's.

Fixtures: for each family, the port's writer and mine_tpu's lay down the same
files: every non-image file byte-equal (an .npz holds equal arrays; its zip
container carries the time it was written), every PNG decoding to equal
pixels and mode. The contract rung (`check_contract`) passes every check for
all 9 shipped configs in the port; `CONTRACTS` and `CONFIG_FAMILIES` equal
mine_tpu's (as `dataclasses.asdict`); the sparse-depth flags agree with the
port's NO_DISP_SUPERVISION. The CLI sweep of all 9 configs (train, then
evaluate, on the CPU) is slow-marked, as the JAX package's is.
"""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
from PIL import Image

from mine_tpu.data.conformance import contract as j_contract
from mine_tpu.data.conformance.fixtures import write_fixture as j_write_fixture
from mine_tpu_torch.data.conformance import contract as t_contract
from mine_tpu_torch.data.conformance.fixtures import write_fixture as t_write_fixture
from mine_tpu_torch.data.conformance.runner import check_contract, check_loader, run_matrix
from torch_threads import one_torch_thread  # noqa: F401


def _files(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("family", sorted(j_contract.CONTRACTS))
def test_fixtures_equal_jax(family, tmp_path):
    want_root, got_root = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert j_write_fixture(family, want_root) == t_write_fixture(family, got_root).replace(
        got_root, want_root)
    files = _files(want_root)
    assert files == _files(got_root)
    assert family == "synthetic" or files
    for f in files:
        a, b = os.path.join(want_root, f), os.path.join(got_root, f)
        if f.endswith(".png"):
            with Image.open(a) as ia, Image.open(b) as ib:
                assert ia.mode == ib.mode, f
                assert np.array_equal(np.asarray(ia), np.asarray(ib)), f
        elif f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za) == sorted(zb)
                assert all(np.array_equal(za[k], zb[k]) for k in za), f
        else:
            assert filecmp.cmp(a, b, shallow=False), f


@pytest.mark.parametrize("config_name", j_contract.all_config_names())
def test_contract_rung_passes_every_check(config_name, tmp_path):
    verdict = check_contract(config_name, str(tmp_path))
    assert verdict["checks"] and verdict["ok"], {
        k: v for k, v in verdict["checks"].items() if v != "ok"}


def test_contract_tables_equal_jax():
    assert t_contract.all_config_names() == j_contract.all_config_names()
    assert len(t_contract.all_config_names()) == 9
    assert os.path.samefile(t_contract.configs_dir(), j_contract.configs_dir())
    assert t_contract.CONFIG_FAMILIES == j_contract.CONFIG_FAMILIES
    assert {k: dataclasses.asdict(v) for k, v in t_contract.CONTRACTS.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_contract.CONTRACTS.items()}
    assert t_contract.ZOO_BUCKETS == j_contract.ZOO_BUCKETS
    for name in t_contract.CONFIG_FAMILIES:
        assert t_contract.contract_for_config(name).required_keys == \
            j_contract.contract_for_config(name).required_keys
    with pytest.raises(KeyError, match="known configs"):
        t_contract.contract_for_config("imagenet")


def test_sparse_depth_flags_agree_with_the_port_step():
    from mine_tpu_torch.data.registry import registered_names
    from mine_tpu_torch.training.step import NO_DISP_SUPERVISION

    assert set(t_contract.CONTRACTS) == set(registered_names())
    for family, contract in t_contract.CONTRACTS.items():
        assert contract.sparse_depth == (family not in NO_DISP_SUPERVISION), family


def test_check_loader_reports_a_failing_stage(tmp_path, monkeypatch):
    """A config whose model cannot be built (a height the decoder refuses)
    passes the loader's contract, fails its train stage with the CLI's
    error, and the eval stage does not run."""
    from mine_tpu_torch.data.conformance import runner

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one_torch_thread, for the CLI
    tiny = runner.conformance_overrides
    monkeypatch.setattr(runner, "conformance_overrides",
                        lambda path: {**tiny(path), "data.img_h": 100})
    verdict = check_loader("llff", str(tmp_path), device="cpu")
    stages = verdict["stages"]
    assert stages["contract"]["ok"] and verdict["overrides"]["data.img_h"] == 100
    assert not stages["train"]["ok"] and "multiple of 128" in stages["train"]["stderr_tail"]
    assert not verdict["ok"] and "eval" not in stages


@pytest.mark.slow
def test_full_matrix_train_eval_on_cpu(tmp_path):
    """All nine configs through the port's train and evaluate CLIs on the
    CPU against their fixtures."""
    summary = run_matrix(str(tmp_path), device="cpu")
    failures = [{r["config"]: {s: res for s, res in r["stages"].items() if not res.get("ok")}}
                for r in summary["results"] if not r["ok"]]
    assert summary["ok"], json.dumps(failures, indent=2)[:4000]
    assert summary["configs_checked"] == 9
