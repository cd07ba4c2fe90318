"""One torch intra-op thread while a test module runs, for the port's
CPU-heavy test modules: ``from torch_threads import one_thread``. The
tier-1 run has pytest-xdist workers share the machine's cores, and
torch's default of a thread a core in each oversubscribes them; these
modules ran about 4x slower so. The module's tests see the same
results at one thread (spawned ranks already run at one,
torch_dist_cases._rank_main); the count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
