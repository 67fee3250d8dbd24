"""The port's test modules' one intra-op thread: each imports
``_one_torch_thread`` (``from _torch_threads import _one_torch_thread``),
which pytest then runs as an autouse fixture of that module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny models are op-bound: one intra-op thread a worker keeps
    them from stalling on busy cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
