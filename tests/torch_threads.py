"""One PyTorch intra-op thread while a test module runs.

The suite runs on several workers at once. PyTorch's CPU ops split their
work across every core, so with several workers each op of a plain
version (many small ops) waits on threads that the other workers hold,
and such tests ran tens of times slower in the suite than alone. A test
module that imports ``one_torch_thread`` runs on one thread, and the
count is restored after it; no tolerance or input changes.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
