"""Device resolution for the port's entry points (counterpart of
mine_tpu/utils/platform.py).

The entry points run on the card unless the caller asks for the CPU: a
missing CUDA device is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None means CUDA. Raises RuntimeError when CUDA is asked for (or
    implied) and no CUDA device is present; "cpu" must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
