"""``one_torch_thread``, an autouse fixture that the port's CPU-heavy test files import."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these CPU-heavy files: when the suite runs in parallel workers that share
    the cores, each worker's default of a thread a core makes the workers spin against each other (six
    such files took 2.4 times as long together)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
