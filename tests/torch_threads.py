"""The port's test files' shared fixture: one intra-op torch thread a file.

The suite runs files in parallel workers, and torch's default of a thread
per core in every worker oversubscribes the machine many times over. A port
test file takes it with

    from torch_threads import one_torch_thread  # noqa: F401

(tests/ is on sys.path while pytest imports a test file from it).
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
