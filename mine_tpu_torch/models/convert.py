"""Carry MPINetwork variables and gradients between the JAX package's layout
and the port's, in both directions.

The JAX side is the flat `.npz` layout that mine_tpu/models/pretrained.py
reads and tools/convert_resnet.py / tools/convert_mine_checkpoint.py write:
`params/backbone/Bottleneck_3/Conv_1/kernel`,
`batch_stats/decoder/upconv_4_0/SyncBatchNorm_0/BatchNorm_0/mean`, ...
JAX to the port is the exact inverse of those two converters: HWIO kernels
become OIHW, BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var. A gradient tree is the `params/` part
of that layout. Strict both ways: a missing key raises KeyError, a leftover
one ValueError. `load_npz_subtrees` reads a converted .npz for a warm start
(training.pretrained_checkpoint_path, model.pretrained_backbone_path), as
mine_tpu/models/pretrained.py does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mine_tpu_torch.models.decoder import tuple_to_str
from mine_tpu_torch.models.encoder import BOTTLENECK, STAGE_BLOCKS


def flatten_variables(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax variables {"params": {...}, "batch_stats": {...}} of numpy
    arrays -> the flat "params/backbone/..." layout."""
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_variables(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _mapping(num_layers: int) -> list[tuple[str, str, bool]]:
    """(torch key, flat JAX key, is conv kernel) for every mapped tensor."""
    rows: list[tuple[str, str, bool]] = []

    def conv(torch_key: str, jax_module: str, bias: bool = False) -> None:
        rows.append((f"{torch_key}.weight", f"params/{jax_module}/kernel", True))
        if bias:
            rows.append((f"{torch_key}.bias", f"params/{jax_module}/bias", False))

    def bn(torch_key: str, jax_module: str) -> None:
        base = f"{jax_module}/BatchNorm_0"
        rows.extend([
            (f"{torch_key}.weight", f"params/{base}/scale", False),
            (f"{torch_key}.bias", f"params/{base}/bias", False),
            (f"{torch_key}.running_mean", f"batch_stats/{base}/mean", False),
            (f"{torch_key}.running_var", f"batch_stats/{base}/var", False),
        ])

    if num_layers not in STAGE_BLOCKS:
        raise ValueError(f"unsupported resnet depth {num_layers}")
    enc, jenc = "backbone.encoder", "backbone"
    conv(f"{enc}.conv1", f"{jenc}/Conv_0")
    bn(f"{enc}.bn1", f"{jenc}/SyncBatchNorm_0")
    bottleneck = num_layers in BOTTLENECK
    block = "Bottleneck" if bottleneck else "BasicBlock"
    n_convs = 3 if bottleneck else 2
    j = 0
    for stage, n_blocks in enumerate(STAGE_BLOCKS[num_layers]):
        for b in range(n_blocks):
            pre, jpre = f"{enc}.layer{stage + 1}.{b}", f"{jenc}/{block}_{j}"
            for c in range(n_convs):
                conv(f"{pre}.conv{c + 1}", f"{jpre}/Conv_{c}")
                bn(f"{pre}.bn{c + 1}", f"{jpre}/SyncBatchNorm_{c}")
            if b == 0 and (stage > 0 or bottleneck):
                conv(f"{pre}.downsample.0", f"{jpre}/Conv_{n_convs}")
                bn(f"{pre}.downsample.1", f"{jpre}/SyncBatchNorm_{n_convs}")
            j += 1

    for k, name in enumerate(("conv_down1", "conv_down2", "conv_up1", "conv_up2")):
        conv(f"decoder.{name}.0", f"decoder/ConvBNLeaky_{k}/Conv_0")
        bn(f"decoder.{name}.1", f"decoder/ConvBNLeaky_{k}/SyncBatchNorm_0")
    for i in range(5):
        for jj in (0, 1):
            pre = f"decoder.convs.{tuple_to_str(('upconv', i, jj))}"
            conv(f"{pre}.conv.conv", f"decoder/upconv_{i}_{jj}/Conv3x3_0/Conv_0", bias=True)
            bn(f"{pre}.bn", f"decoder/upconv_{i}_{jj}/SyncBatchNorm_0")
    for s in range(4):
        conv(f"decoder.convs.{tuple_to_str(('dispconv', s))}.conv",
             f"decoder/dispconv_{s}/Conv_0", bias=True)
    return rows


def _check_keys(have, want, what: str) -> None:
    missing = sorted(set(want) - set(have))
    if missing:
        raise KeyError(f"{len(missing)} {what} missing: {missing[:4]}...")
    leftover = sorted(set(have) - set(want))
    if leftover:
        raise ValueError(
            f"{len(leftover)} {what} have no place in the other layout: {leftover[:4]}..."
        )


def _from_jax(flat: Mapping[str, np.ndarray], rows) -> dict[str, torch.Tensor]:
    out = {}
    for torch_key, jax_key, is_kernel in rows:
        arr = np.asarray(flat[jax_key], dtype=np.float32)
        if is_kernel:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        out[torch_key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _to_jax(tensors: Mapping[str, torch.Tensor], rows) -> dict[str, np.ndarray]:
    flat = {}
    for torch_key, jax_key, is_kernel in rows:
        t = tensors[torch_key].detach().cpu()
        arr = (t if t.dtype == torch.float64 else t.float()).numpy()  # bf16 -> fp32
        flat[jax_key] = np.transpose(arr, (2, 3, 1, 0)) if is_kernel else arr  # OIHW -> HWIO
    return flat


def _param_rows(num_layers: int) -> list[tuple[str, str, bool]]:
    return [r for r in _mapping(num_layers) if r[1].startswith("params/")]


def jax_variables_to_torch(flat: Mapping[str, np.ndarray],
                           num_layers: int) -> dict[str, torch.Tensor]:
    """Flat JAX variables of a 4-scale MPINetwork -> the port's state dict
    (fp32, CPU tensors).
    BatchNorm's num_batches_tracked has no JAX counterpart and is set to 0."""
    rows = _mapping(num_layers)
    _check_keys(flat, [jk for _, jk, _ in rows], f"variables for resnet{num_layers}")
    state = _from_jax(flat, rows)
    for torch_key, _, _ in rows:
        if torch_key.endswith(".running_var"):
            state[torch_key[: -len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return state


_SUBTREES = ("backbone", "decoder")


def load_npz_subtrees(path: str, num_layers: int,
                      expect_subtrees: tuple[str, ...] | None = None) -> dict[str, torch.Tensor]:
    """The state-dict entries of the subtrees ("backbone", "decoder") a
    converted .npz covers. Strict per covered subtree: every variable of it
    present, nothing else (KeyError / ValueError). With `expect_subtrees`
    the .npz must cover exactly those."""
    with np.load(path) as raw:
        flat = {k: raw[k] for k in raw.files}
    for key in flat:
        parts = key.split("/", 2)
        if len(parts) != 3 or parts[0] not in ("params", "batch_stats") \
                or parts[1] not in _SUBTREES:
            raise ValueError(f"{path}: unexpected key {key!r}, not a converted MINE .npz")
    covered = sorted({key.split("/")[1] for key in flat})
    if expect_subtrees is not None and covered != sorted(expect_subtrees):
        raise ValueError(f"{path} covers subtrees {covered}, expected {sorted(expect_subtrees)}")
    rows = [r for r in _mapping(num_layers) if r[1].split("/")[1] in covered]
    _check_keys(flat, [jk for _, jk, _ in rows], f"variables of {covered} in {path}")
    return _from_jax(flat, rows)


def jax_grads_to_torch(flat_grads: Mapping[str, np.ndarray],
                       num_layers: int) -> dict[str, torch.Tensor]:
    """A flat JAX gradient tree ("params/..." keys) -> {port parameter name:
    gradient}, fp32 CPU tensors."""
    rows = _param_rows(num_layers)
    _check_keys(flat_grads, [jk for _, jk, _ in rows], f"gradients for resnet{num_layers}")
    return _from_jax(flat_grads, rows)


def torch_to_jax_variables(state: Mapping[str, torch.Tensor],
                           num_layers: int) -> dict[str, np.ndarray]:
    """The port's state dict -> flat JAX variables ("params/...",
    "batch_stats/..."); num_batches_tracked has no JAX counterpart and is
    dropped."""
    rows = _mapping(num_layers)
    have = [k for k in state if not k.endswith(".num_batches_tracked")]
    _check_keys(have, [tk for tk, _, _ in rows], f"tensors for resnet{num_layers}")
    return _to_jax(state, rows)


def torch_grads_to_jax(model: torch.nn.Module, num_layers: int) -> dict[str, np.ndarray]:
    """The `.grad` of every parameter of `model` -> a flat JAX gradient tree
    ("params/..." keys). A parameter without a gradient raises."""
    grads = {name: p.grad for name, p in model.named_parameters()}
    absent = sorted(k for k, g in grads.items() if g is None)
    if absent:
        raise ValueError(f"{len(absent)} parameters have no gradient: {absent[:4]}...")
    rows = _param_rows(num_layers)
    _check_keys(grads, [tk for tk, _, _ in rows], f"parameters for resnet{num_layers}")
    return _to_jax(grads, rows)
