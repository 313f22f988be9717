"""The port's test modules import ``_one_torch_thread`` from here: an
autouse, module-scoped fixture that pins torch to one intra-op thread."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests' tensors are small: one intra-op thread keeps the torch
    side from contending with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
