"""Fixtures of the port's test files that import no JAX, so that a file
run on the card (`pytest --noconftest`, no JAX there) can use them too."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module runs (the port's test files
    import this fixture). With several pytest workers on the machine's
    cores, torch's OpenMP threads wait at each barrier for threads the
    other workers hold off the cores: the f64 model tests of
    test_torch_train.py ran ~50x slower than alone, and slowed every other
    worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
