"""Keep the PyTorch port's CPU tests to a few torch threads.

pytest-xdist runs several workers on one machine. Each worker's torch
would otherwise start one busy-waiting OpenMP thread per core beside
JAX's own thread pool, and the many small ops of these tests then wait
on each other (a 1 s test took over a minute). A test module applies
this to all its tests by importing ``few_torch_threads``; the worker's
thread count is restored after the module."""
import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def test_fixture_holds_torch_threads():
    assert torch.get_num_threads() == TORCH_THREADS
