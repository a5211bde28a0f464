"""The training log and the machine-readable metric stream (the port's own
copy of `make_logger` and `MetricWriter` from mine_tpu/utils/logging.py).

  * `make_logger(workspace)`: the package logger ("mine_tpu_torch") with one
    file handler on `<workspace>/train.log`. Lines reach the console through
    the root handler the CLIs configure (logging.basicConfig), so the logger
    keeps propagating.
  * `MetricWriter(workspace)`: scalars to `<workspace>/metrics.jsonl`, one
    line `{"step", "tag", "value"}` each, under the JAX package's tags
    (`train/<loss>`, `obs/mfu`, ...); and to TensorBoard event files where
    tensorboardX imports, as the JAX package writes them. (The writer of
    torch.utils.tensorboard goes through the `tensorboard` package, which
    imports TensorFlow wherever it is installed: 15-18 s for each process on
    a CPU host, against 5 s for tensorboardX.) `image_grid` writes a row of
    images to TensorBoard only, as the JAX package's does.
  * `normalize_disparity_for_vis`: per-image min-max normalisation of a
    disparity batch for display (eval's grids, the video's depth frames).
  * `event_summaries(logdir)`: what the TensorBoard event files under a
    directory hold, tag by tag (reads them back through tensorboardX).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import struct
from typing import Any

import numpy as np

LOGGER_NAME = "mine_tpu_torch"


def make_logger(workspace: str | None, name: str = LOGGER_NAME) -> logging.Logger:
    """The package logger at INFO with a file handler on
    `<workspace>/train.log` (replacing the one an earlier call added)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for handler in [h for h in logger.handlers if getattr(h, "_mine_train_log", False)]:
        logger.removeHandler(handler)
        handler.close()
    if workspace:
        os.makedirs(workspace, exist_ok=True)
        fh = logging.FileHandler(os.path.join(workspace, "train.log"))
        fh.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s"))
        fh._mine_train_log = True
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """Scalars to metrics.jsonl (and TensorBoard where it imports)."""

    def __init__(self, workspace: str | None):
        self._tb = None
        self._jsonl = None
        if workspace:
            os.makedirs(workspace, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(workspace)
            except ImportError:
                pass
            self._jsonl = open(os.path.join(workspace, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: Any, step: int) -> None:
        value = float(value)
        if self._tb:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "tag": tag, "value": value}) + "\n")

    def scalars(self, values: dict[str, Any], step: int, prefix: str = "") -> None:
        for tag, value in values.items():
            self.scalar(prefix + tag, value, step)

    def image_grid(self, tag: str, images: np.ndarray, step: int) -> None:
        """(N, H, W, C) images in [0, 1] -> one row, (H, N * W, C), clipped
        to [0, 1] (TensorBoard only)."""
        if self._tb is None:
            return
        images = np.clip(np.asarray(images), 0.0, 1.0)
        grid = np.concatenate(list(images), axis=1)
        self._tb.add_image(tag, grid, step, dataformats="HWC")

    def flush(self) -> None:
        if self._tb:
            self._tb.flush()
        if self._jsonl:
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb:
            self._tb.close()
            self._tb = None
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None


def normalize_disparity_for_vis(disp: np.ndarray) -> np.ndarray:
    """Min-max normalise each image of an (N, H, W, C) disparity batch."""
    disp = np.asarray(disp)
    lo = disp.min(axis=(1, 2, 3), keepdims=True)
    hi = disp.max(axis=(1, 2, 3), keepdims=True)
    return (disp - lo) / np.maximum(hi - lo, 1e-8)


def event_summaries(logdir: str) -> dict[str, dict]:
    """{tag: {"kind": "image" | "simple_value" | ..., "steps": [...],
    "hw": (height, width) of an image}} over the event files in `logdir`,
    read record by record (length, its CRC, the Event proto, its CRC;
    tensorboardX's protobuf classes). Empty when tensorboardX does not
    import."""
    try:
        from tensorboardX.proto.event_pb2 import Event
    except ImportError:
        return {}
    found: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*"))):
        with open(path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos + 12 <= len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            event = Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 12 + length + 4
            for value in event.summary.value:
                row = found.setdefault(value.tag, {"kind": value.WhichOneof("value"),
                                                   "steps": []})
                row["steps"].append(int(event.step))
                if row["kind"] == "image":
                    row["hw"] = (value.image.height, value.image.width)
    return found
