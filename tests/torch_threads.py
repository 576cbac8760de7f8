"""One intra-op torch thread for the port's CPU tests.

The suite runs under several xdist workers on one machine's cores; with
torch's default of a thread per core, each worker's small pages spent their
time in thread hand-offs and slowed the other workers' reference compiles.
A ``tests/test_torch_*.py`` module imports ``one_torch_thread``, an autouse
module fixture, and its tests run torch with one thread (restored after the
module).
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
