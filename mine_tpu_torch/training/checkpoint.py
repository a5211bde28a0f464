"""Checkpoints of the port's training state (counterpart of
mine_tpu/training/checkpoint.py, in a format of its own: orbax needs JAX).

One directory per step, `<workspace>/checkpoints/<step>/state.pt`, written
into a temporary directory and renamed into place, so a step directory is
either absent or complete. The file is one torch.save'd dict: the model's
state dict (BatchNorm statistics included), the optimizer's and the
schedule's, `global_step`, and the states of the disparity and dropout
generators; it loads with `weights_only=True`. As in the JAX package the
newest `max_to_keep` steps are kept, and every step divisible by
`keep_period`.

Beside the checkpoints, as in the JAX package:
  * params.yaml, the merged config as flat dot-key YAML (save_paired_config
    / load_paired_config);
  * last_good.json, the newest step saved while the training sentinel saw
    only finite steps (mark_last_good / last_good_step / last_good_target);
  * integrity/<step>.json, a sha256 manifest of the step directory written
    after the commit; loading re-hashes it and raises CheckpointCorrupt on a
    mismatch (a checkpoint without a sidecar verifies vacuously).

A step can also be saved as one file a rank, `<workspace>/checkpoints/
<step>-r<rank>of<world>/shard.pt`, each with its own integrity sidecar
(`save_rank_shard`): the emergency checkpoint of a job whose state is
sharded across ranks, written by each rank alone without a collective.
Such a step counts (`all_steps`, `latest_step`, `load`) only when the file of
every rank is present and verifies; `load` then reassembles the layout-free
state from the shards and the placements they record (`assemble_shards`).

For serving, `load_for_serving` restores the config and the model's state
dict alone, and `validate_variables_tree` holds a candidate state dict to
the serving one's leaf names, shapes and dtypes (CheckpointTreeMismatch).
A workspace of the JAX package (orbax step directories) is refused by name
wherever a workspace is read (OrbaxWorkspaceError):
tools/jax_workspace_to_torch.py converts it into one of these.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import shutil
from typing import Any

import torch

from mine_tpu_torch.config import Config, load_config, save_config

StateDict = dict[str, torch.Tensor]

STATE_FILE = "state.pt"
SHARD_FILE = "shard.pt"
_SHARD_DIR = re.compile(r"^(\d+)-r(\d+)of(\d+)$")
EXPORT_SCRIPT = "tools/jax_workspace_to_torch.py"


class OrbaxWorkspaceError(ValueError):
    """A workspace of the JAX package: its steps are orbax checkpoints."""


def checkpoint_path(workspace: str) -> str:
    return os.path.abspath(os.path.join(workspace, "checkpoints"))


def shard_dir_name(step: int, rank: int, world: int) -> str:
    return f"{int(step)}-r{int(rank)}of{int(world)}"


def _refuse_orbax(root: str, names: list[str]) -> None:
    """Raise OrbaxWorkspaceError when a step directory under `root` holds an
    orbax checkpoint (no state.pt, orbax's metadata) instead of the port's."""
    for name in names:
        step_dir = os.path.join(root, name)
        if name.isdigit() and not os.path.exists(os.path.join(step_dir, STATE_FILE)) and (
                os.path.exists(os.path.join(step_dir, "_CHECKPOINT_METADATA"))
                or os.path.isdir(os.path.join(step_dir, "default"))):
            raise OrbaxWorkspaceError(
                f"{os.path.dirname(root)} is a JAX (orbax) workspace: step {name} holds an orbax "
                f"checkpoint, which the port does not read; convert it with `python "
                f"{EXPORT_SCRIPT} --workspace {os.path.dirname(root)} --out <port workspace>`")


def _shard_sets(root: str, names: list[str]) -> dict[int, dict[int, set[int]]]:
    """{step: {world: ranks}} of the per-rank shard directories by name."""
    found: dict[int, dict[int, set[int]]] = {}
    for name in names:
        m = _SHARD_DIR.match(name)
        if m:
            step, rank, world = (int(g) for g in m.groups())
            found.setdefault(step, {}).setdefault(world, set()).add(rank)
    return found


def _dir_step(name: str) -> int | None:
    """The step of a step directory or a rank shard directory, else None."""
    m = _SHARD_DIR.match(name)
    return int(name) if name.isdigit() else int(m.group(1)) if m else None


def _complete_shards(workspace: str, step: int, worlds: dict[int, set[int]]) -> list[str] | None:
    """The shard directories of `step` when one world's set is complete and
    every file of it verifies, else None."""
    for world, ranks in sorted(worlds.items()):
        if ranks != set(range(world)):
            continue
        names = [shard_dir_name(step, r, world) for r in range(world)]
        try:
            for name in names:
                verify_checkpoint_integrity(workspace, name, require_sidecar=True)
        except CheckpointCorrupt:
            continue
        return names
    return None


def all_steps(workspace: str) -> list[int]:
    """The committed steps, ascending: a step directory, or a complete set
    of per-rank shards that verifies."""
    root = checkpoint_path(workspace)
    if not os.path.isdir(root):
        return []
    names = os.listdir(root)
    _refuse_orbax(root, names)
    steps = {int(name) for name in names if name.isdigit()}
    for step, worlds in _shard_sets(root, names).items():
        if step not in steps and _complete_shards(workspace, step, worlds) is not None:
            steps.add(step)
    return sorted(steps)


def latest_step(workspace: str) -> int | None:
    steps = all_steps(workspace)
    return steps[-1] if steps else None


def save(workspace: str, state: dict[str, Any], step: int, max_to_keep: int = 3,
         keep_period: int | None = None) -> None:
    """Commit `state` as step `step`, record its integrity sidecar, then
    drop the steps past the retention rule. A step already on disk raises."""
    root = checkpoint_path(workspace)
    final = os.path.join(root, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint step {step} already exists under {root}")
    tmp = os.path.join(root, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as fh:
        torch.save(state, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    write_integrity_sidecar(workspace, step)
    steps = all_steps(workspace)
    drop = {old for old in (steps[:-max_to_keep] if max_to_keep > 0 else [])
            if not (keep_period and old % keep_period == 0)}
    names = os.listdir(root)
    # a shard set older than this step that never completed cannot any more
    drop |= {old for old in _shard_sets(root, names) if old < step and old not in steps}
    for name in names:
        if _dir_step(name) in drop:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            try:
                os.remove(_integrity_path(workspace, name))
            except OSError:
                pass


def save_rank_shard(workspace: str, shard: dict[str, Any], step: int, rank: int,
                    world: int) -> str:
    """Commit one rank's part of step `step` (its emergency checkpoint: the
    tensors it holds, as `Trainer.rank_shard` collects them) with its own
    integrity sidecar, replacing an earlier file of the same rank and step;
    no retention, no collective. Returns the directory."""
    root = checkpoint_path(workspace)
    name = shard_dir_name(step, rank, world)
    final = os.path.join(root, name)
    tmp = os.path.join(root, f".tmp-{name}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, SHARD_FILE), "wb") as fh:
        torch.save(shard, fh)
        fh.flush()
        os.fsync(fh.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    write_integrity_sidecar(workspace, name)
    return final


def _chunk(coords: dict[str, int], shape: dict[str, int], axes: list[str]) -> int:
    """Row-major index over `axes` (major first): the chunk a placement
    over them gives the rank at `coords`."""
    idx = 0
    for ax in axes:
        idx = idx * shape[ax] + coords[ax]
    return idx


def _reassemble(shards: list[dict], placement, get) -> torch.Tensor:
    """One tensor from the ranks' chunks of it (`get(shard)`), concatenated
    along the placement's dimension in chunk order."""
    dim, axes = placement
    if dim < 0 or not axes:
        return get(shards[0])
    shape = shards[0]["mesh"]["shape"]
    chunks: dict[int, torch.Tensor] = {}
    for sh in shards:
        chunks.setdefault(_chunk(sh["mesh"]["coords"], shape, axes), get(sh))
    n = math.prod(shape[ax] for ax in axes)
    if sorted(chunks) != list(range(n)):
        raise CheckpointCorrupt("rank shards", [f"chunks {sorted(chunks)} of {n} over {axes}"])
    return torch.cat([chunks[i] for i in range(n)], dim=dim)


def assemble_shards(shards: list[dict[str, Any]]) -> dict[str, Any]:
    """The ranks' emergency shards -> the layout-free state a checkpoint
    holds (`Trainer.state()`): every sharded parameter and Adam moment
    concatenated from its chunks by the placement each shard records, the
    replicated rest (statistics, schedule, step, generators) from rank 0."""
    shards = sorted(shards, key=lambda sh: sh["rank"])
    base, layout = shards[0], shards[0]["layout"]
    model = dict(base["model"])
    for name, placement in layout["params"].items():
        model[name] = _reassemble(shards, placement, lambda sh, n=name: sh["model"][n])
    optimizer = dict(base["optimizer"])
    state = {}
    for idx, entry in base["optimizer"]["state"].items():
        name, entry = base["optimizer_names"][idx], dict(entry)
        for m in ("exp_avg", "exp_avg_sq"):
            if m in entry:
                entry[m] = _reassemble(shards, layout["updates"][name],
                                       lambda sh, i=idx, m=m: sh["optimizer"]["state"][i][m])
        state[idx] = entry
    optimizer["state"] = state
    return {"model": model, "optimizer": optimizer, "scheduler": base["scheduler"],
            "global_step": base["global_step"], "generators": base["generators"]}


def load(workspace: str, step: int) -> dict[str, Any]:
    """Verify step `step` against its integrity sidecar, then load it (on
    the CPU, weights_only); a step saved as per-rank shards is reassembled
    (assemble_shards) once every rank's file verifies."""
    root = checkpoint_path(workspace)
    path = os.path.join(root, str(int(step)), STATE_FILE)
    if not os.path.exists(path) and os.path.isdir(root):
        names = os.listdir(root)
        _refuse_orbax(root, names)
        worlds = _shard_sets(root, names).get(int(step))
        if worlds:
            shard_names = _complete_shards(workspace, int(step), worlds)
            if shard_names is None:
                present = sorted(n for n in names if _SHARD_DIR.match(n) and _dir_step(n) == step)
                raise CheckpointCorrupt(f"checkpoint step {step} under {workspace}", [
                    f"rank shards incomplete or failing verification: {present}"])
            return assemble_shards([
                torch.load(os.path.join(root, name, SHARD_FILE), map_location="cpu",
                           weights_only=True) for name in shard_names])
    verify_checkpoint_integrity(workspace, step)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_paired_config(cfg: Config, workspace: str) -> None:
    """Archive the merged config into the workspace as params.yaml."""
    os.makedirs(workspace, exist_ok=True)
    save_config(cfg, os.path.join(workspace, "params.yaml"))


def load_paired_config(workspace: str, overrides: dict | str | None = None) -> Config:
    """The config a training run archived, with `overrides` on top."""
    return load_config(os.path.join(workspace, "params.yaml"), overrides=overrides)


# -- last-good pointer (the sentinel's rollback target) -------------------------


def _last_good_path(workspace: str) -> str:
    return os.path.join(workspace, "last_good.json")


def _write_json_atomic(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, sort_keys=True)
    os.replace(tmp, path)  # readers see the old file or the new one, never half


def mark_last_good(workspace: str, step: int) -> None:
    """Record `step` as the newest checkpoint known healthy."""
    _write_json_atomic(_last_good_path(workspace), {"step": int(step)})


def last_good_step(workspace: str) -> int | None:
    try:
        with open(_last_good_path(workspace)) as fh:
            return int(json.load(fh)["step"])
    except (OSError, ValueError, KeyError):
        return None


def last_good_target(workspace: str) -> int:
    """The newest retained step at or before the last-good pointer; with no
    pointer (or nothing under it) the newest retained step. Raises
    FileNotFoundError when the workspace holds no checkpoint."""
    steps = all_steps(workspace)
    if not steps:
        raise FileNotFoundError(f"rollback requested but {workspace} holds no checkpoint")
    pointer = last_good_step(workspace)
    candidates = [s for s in steps if pointer is None or s <= pointer]
    return max(candidates) if candidates else max(steps)


# -- integrity sidecar ------------------------------------------------------------


class CheckpointCorrupt(ValueError):
    """A checkpoint's bytes no longer match the manifest recorded when it
    was saved."""

    def __init__(self, context: str, problems: list[str]):
        self.problems = problems
        shown = "; ".join(problems[:5])
        more = f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""
        super().__init__(f"{context}: {shown}{more}")


def _dir_name(step: int | str) -> str:
    """A step's directory name: the step, or a rank shard's name."""
    return step if isinstance(step, str) else str(int(step))


def _integrity_path(workspace: str, step: int | str) -> str:
    return os.path.join(workspace, "integrity", f"{_dir_name(step)}.json")


def _step_manifest(workspace: str, step: int | str) -> dict[str, dict]:
    """relative path -> {"bytes", "sha256"} for every file of the step."""
    root = os.path.join(checkpoint_path(workspace), _dir_name(step))
    if not os.path.isdir(root):
        raise CheckpointCorrupt(f"checkpoint step {step} under {workspace}",
                                [f"step directory missing: {root}"])
    manifest: dict[str, dict] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            digest = hashlib.sha256()
            with open(full, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 20), b""):
                    digest.update(block)
            manifest[os.path.relpath(full, root)] = {
                "bytes": os.path.getsize(full), "sha256": digest.hexdigest()}
    return manifest


def _manifest_sha256(manifest: dict[str, dict]) -> str:
    return hashlib.sha256(json.dumps(manifest, sort_keys=True).encode()).hexdigest()


def write_integrity_sidecar(workspace: str, step: int | str) -> None:
    """`step`: a step, or a rank shard's directory name."""
    manifest = _step_manifest(workspace, step)
    _write_json_atomic(_integrity_path(workspace, step), {
        "step": _dir_name(step), "manifest_sha256": _manifest_sha256(manifest),
        "files": manifest})


def verify_checkpoint_integrity(workspace: str, step: int | str,
                                require_sidecar: bool = False) -> None:
    """Re-hash the step directory (or rank shard directory) against its
    sidecar; CheckpointCorrupt names the diverging files. No sidecar:
    nothing to verify, unless `require_sidecar`."""
    try:
        with open(_integrity_path(workspace, step)) as fh:
            recorded = json.load(fh)
    except OSError:
        if require_sidecar:
            raise CheckpointCorrupt(f"checkpoint {_dir_name(step)} under {workspace}",
                                    ["integrity sidecar missing"]) from None
        return
    except ValueError as exc:
        raise CheckpointCorrupt(f"checkpoint step {_dir_name(step)} under {workspace}",
                                [f"unreadable integrity sidecar: {exc}"]) from None
    actual = _step_manifest(workspace, step)
    want = recorded.get("files", {})
    problems = [f"missing file {n}" for n in sorted(set(want) - set(actual))]
    problems += [f"unexpected file {n}" for n in sorted(set(actual) - set(want))]
    for name in sorted(set(want) & set(actual)):
        if want[name] != actual[name]:
            problems.append(f"file {name}: recorded {want[name]['bytes']}B sha256 "
                            f"{want[name]['sha256'][:12]}, found {actual[name]['bytes']}B "
                            f"sha256 {actual[name]['sha256'][:12]}")
    if not problems and recorded.get("manifest_sha256") != _manifest_sha256(actual):
        problems.append("manifest sha256 mismatch")
    if problems:
        raise CheckpointCorrupt(f"checkpoint step {_dir_name(step)} under {workspace}", problems)


# -- serving: the model's state dict alone -----------------------------------------


class CheckpointTreeMismatch(ValueError):
    """A state dict does not carry the leaf names, shapes and dtypes its
    consumer expects; the first mismatched leaves are named."""

    def __init__(self, context: str, problems: list[str]):
        self.problems = problems
        shown = "; ".join(problems[:5])
        more = f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""
        super().__init__(f"{context}: {shown}{more}")


def _signature(state: dict[str, Any]) -> dict[str, tuple]:
    return {name: (tuple(t.shape), str(t.dtype)) for name, t in state.items()}


def validate_variables_tree(expected: dict[str, Any], got: dict[str, Any],
                            context: str = "restored checkpoint") -> None:
    """Raise CheckpointTreeMismatch unless `got` has exactly the keys of
    `expected` with the same shapes and dtypes. Only `.shape` and `.dtype`
    are read: the layout is the contract, the values are not inspected."""
    want, have = _signature(expected), _signature(got)
    problems = [f"missing leaf {n} {want[n][0]}" for n in sorted(set(want) - set(have))]
    problems += [f"unexpected leaf {n} {have[n][0]}" for n in sorted(set(have) - set(want))]
    problems += [f"leaf {n}: expected {want[n][0]}/{want[n][1]}, got {have[n][0]}/{have[n][1]}"
                 for n in sorted(set(want) & set(have)) if want[n] != have[n]]
    if problems:
        raise CheckpointTreeMismatch(context, problems)


def load_for_serving(workspace: str, overrides: dict | str | None = None,
                     allow_random_init: bool = False,
                     expected_state: dict[str, Any] | None = None,
                     step: int | None = None) -> tuple[Config, StateDict, int]:
    """Restore (cfg, model state dict, step) for inference and serving.

    The step directory is verified against its integrity sidecar before
    anything of it is parsed (CheckpointCorrupt). The file is then mapped,
    not read: only the tensors of its "model" entry are touched, so the
    optimizer's moments never reach host memory in full, nor the device. A
    step saved as per-rank shards is reassembled (load). A workspace that
    tools/jax_workspace_to_torch.py exported from the JAX package serves as
    one the port trained; a JAX workspace itself raises
    OrbaxWorkspaceError.

    `step` restores that retained step instead of the newest (an absent one
    raises FileNotFoundError listing the retained steps). With no checkpoint
    at all, `allow_random_init` gives the seeded initial weights and step 0
    (smoke runs only); otherwise FileNotFoundError. `expected_state` (a
    state dict of tensors or of anything with .shape and .dtype) turns on
    validate_variables_tree: a mismatch raises CheckpointTreeMismatch here,
    not inside a later load_state_dict.
    """
    cfg = load_paired_config(workspace, overrides)
    retained = all_steps(workspace)
    if step is not None:
        if int(step) not in retained:
            raise FileNotFoundError(f"checkpoint step {step} not retained under "
                                    f"{checkpoint_path(workspace)} (retained: {retained})")
        step = int(step)
    else:
        step = retained[-1] if retained else None
    if step is None:
        if not allow_random_init:
            raise FileNotFoundError(f"no checkpoint found under {checkpoint_path(workspace)} "
                                    "(pass allow_random_init=True for an untrained smoke run)")
        from mine_tpu_torch.models.mpi import init_weights
        from mine_tpu_torch.training.step import build_model

        model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
        return cfg, model.state_dict(), 0
    path = os.path.join(checkpoint_path(workspace), str(step), STATE_FILE)
    if os.path.exists(path):
        verify_checkpoint_integrity(workspace, step)
        raw = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    else:  # a step saved as per-rank shards
        raw = load(workspace, step)
    if not isinstance(raw, dict) or not isinstance(raw.get("model"), dict):
        raise CheckpointTreeMismatch(f"checkpoint step {step} under {workspace}",
                                     ["no 'model' state dict in " + STATE_FILE])
    state = dict(raw["model"])
    if expected_state is not None:
        validate_variables_tree(expected_state, state,
                                context=f"checkpoint step {step} under {workspace}")
    return cfg, state, step
