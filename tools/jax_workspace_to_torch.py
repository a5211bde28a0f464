#!/usr/bin/env python3
"""Convert a workspace of the JAX package (mine_tpu: orbax checkpoints under
<workspace>/checkpoints, params.yaml beside them) into a workspace of the
PyTorch port (mine_tpu_torch).

    JAX_PLATFORMS=cpu python tools/jax_workspace_to_torch.py \
        --workspace runs/jax_run --out runs/port_run

Run it where JAX and orbax import; the port's machine needs neither. It
restores the JAX workspace's newest step as the JAX package's own warm start
does (mine_tpu/training/checkpoint.py: checkpoint_manager, restore, with the
config the run archived, load_paired_config), converts the whole train state
with mine_tpu_torch/models/convert.py (parameters and BatchNorm statistics,
and, under Adam, each group's moments and count; the schedule's count), and
writes it through mine_tpu_torch/training/checkpoint.py (save,
save_paired_config) as the same step of a port workspace. Then, on the card:

    python -m mine_tpu_torch.train --workspace runs/port_warm \
        --extra_config '{"training.pretrained_checkpoint_path": "runs/port_run"}'
    python -m mine_tpu_torch.infer --checkpoint runs/port_run --image x.png --output_dir out

The first warm-starts from it with the JAX semantics (the whole state, the
step count from 0), the second serves it. JAX's PRNG key has no counterpart
in the port: the export carries the disparity and dropout generators that a
fresh port run of the config seeds (training.seed, training.seed + 1).

With --msgpack it converts instead a model saved by the JAX convergence
harness (tools/convergence_run.py --save-final: flax msgpack of {"params",
"batch_stats"}) into the port harness's --save-final format (a torch.save'd
MPINetwork state_dict), for the port's quality tools:

    JAX_PLATFORMS=cpu python tools/jax_workspace_to_torch.py \
        --msgpack final_params.msgpack --layers 18 --out final_state.pt
    python -m mine_tpu_torch.tools.disocclusion_analysis --params final_state.pt

Prints one JSON line. This script and the tests are the only code that
imports both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections.abc import Mapping

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _flat(tree, prefix: str) -> dict[str, np.ndarray]:
    """A nested dict of arrays -> {"prefix/a/b": array}, leaving out optax's
    MaskedNode leaves (the other group's parameters in a group's moments)."""
    import optax

    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, Mapping):
            out.update(_flat(value, path))
        elif not isinstance(value, optax.MaskedNode):
            out[path] = np.asarray(value)
    return out


def _optimizer_state(opt_state) -> tuple[dict, dict, dict, int | None]:
    """(mu, nu, each group's Adam count, the schedule's count) of the JAX
    optimizer state (mine_tpu/training/optimizer.py: multi_transform over
    the backbone and decoder groups, each add_decayed_weights, scale_by_adam
    under "adam", and the learning rate's schedule). Moments under flat
    "params/..." keys, empty under sgd."""
    import jax
    import optax

    mu, nu, counts, schedule = {}, {}, {}, None
    for group, group_state in opt_state.inner_states.items():
        leaves = jax.tree_util.tree_leaves(
            group_state, is_leaf=lambda x: isinstance(x, (optax.ScaleByAdamState,
                                                          optax.ScaleByScheduleState)))
        for leaf in leaves:
            if isinstance(leaf, optax.ScaleByAdamState):
                mu.update(_flat(leaf.mu, "params"))
                nu.update(_flat(leaf.nu, "params"))
                counts[group] = int(leaf.count)
            elif isinstance(leaf, optax.ScaleByScheduleState):
                schedule = int(leaf.count)
    return mu, nu, counts, schedule


def export(workspace: str, out: str) -> dict:
    """Restore `workspace`'s newest step, convert it, write it to `out`."""
    import jax
    import torch

    from mine_tpu.config import to_flat_dict
    from mine_tpu.training import build_model as jax_build_model
    from mine_tpu.training import checkpoint as jckpt
    from mine_tpu.training import init_state
    from mine_tpu.training import make_optimizer as jax_make_optimizer
    from mine_tpu_torch.config import load_config
    from mine_tpu_torch.models.convert import jax_grads_to_torch, jax_variables_to_torch
    from mine_tpu_torch.training import checkpoint as ckpt
    from mine_tpu_torch.training.optimizer import make_optimizer
    from mine_tpu_torch.training.step import build_model

    jcfg = jckpt.load_paired_config(workspace)
    model = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg, steps_per_epoch=1)
    template = jax.eval_shape(lambda key: init_state(jcfg, model, tx, key, load_pretrained=False),
                              jax.random.PRNGKey(0))
    state, step = jckpt.restore(jckpt.checkpoint_manager(workspace), template)
    if step == 0:
        raise FileNotFoundError(f"{workspace!r} contains no checkpoint")
    variables = {**_flat(state.params, "params"), **_flat(state.batch_stats, "batch_stats")}
    mu, nu, counts, schedule = _optimizer_state(state.opt_state)

    cfg = load_config(overrides=to_flat_dict(jcfg))
    layers = cfg.model.num_layers
    port = build_model(cfg)
    port.load_state_dict(jax_variables_to_torch(variables, layers))
    optimizer, scheduler = make_optimizer(cfg, port, steps_per_epoch=1)
    if mu:
        names = {id(p): n for n, p in port.named_parameters()}
        exp_avg, exp_avg_sq = jax_grads_to_torch(mu, layers), jax_grads_to_torch(nu, layers)
        for group in optimizer.param_groups:  # the port's groups are JAX's labels
            for p in group["params"]:
                name = names[id(p)]
                optimizer.state[p] = {"step": torch.tensor(float(counts[group["name"]])),
                                      "exp_avg": exp_avg[name].to(p.dtype),
                                      "exp_avg_sq": exp_avg_sq[name].to(p.dtype)}
    scheduler.last_epoch = schedule or 0
    seed = cfg.training.seed
    ckpt.save(out, {
        "model": port.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "global_step": int(state.step),
        "generators": {"disparity": torch.Generator().manual_seed(seed).get_state(),
                       "dropout": torch.Generator().manual_seed(seed + 1).get_state()},
    }, step)
    ckpt.save_paired_config(cfg, out)
    return {"workspace": workspace, "out": out, "step": int(step),
            "parameters": sum(p.numel() for p in port.parameters()),
            "adam_moments": bool(mu), "schedule_count": scheduler.last_epoch}


def export_msgpack(path: str, out: str, num_layers: int) -> dict:
    """Convert a JAX convergence harness's --save-final msgpack into the
    port harness's --save-final file (through a tmp file and a rename)."""
    import torch
    from flax import serialization

    from mine_tpu_torch.config import Config
    from mine_tpu_torch.models.convert import flatten_variables, jax_variables_to_torch
    from mine_tpu_torch.training.step import build_model

    with open(path, "rb") as fh:
        tree = serialization.msgpack_restore(fh.read())
    flat = flatten_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    # strict in both directions: a save of another depth fails here
    port = build_model(Config().replace(**{"model.num_layers": num_layers}))
    port.load_state_dict(jax_variables_to_torch(flat, num_layers))
    tmp = out + ".tmp"
    torch.save(port.state_dict(), tmp)
    os.replace(tmp, out)
    return {"msgpack": path, "out": out, "layers": num_layers,
            "parameters": sum(p.numel() for p in port.parameters())}


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--workspace", help="the JAX package's workspace")
    source.add_argument("--msgpack", help="a JAX tools/convergence_run.py --save-final file")
    parser.add_argument("--out", required=True,
                        help="the port workspace to write (with --msgpack: the port's "
                             "--save-final file)")
    parser.add_argument("--layers", type=int, default=18,
                        help="with --msgpack: the ResNet encoder depth of the saved model")
    args = parser.parse_args(argv)
    if args.msgpack:
        result = export_msgpack(args.msgpack, args.out, args.layers)
    else:
        result = export(args.workspace, args.out)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
