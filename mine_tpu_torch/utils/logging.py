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
    a CPU host, against 5 s for tensorboardX.)
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

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
