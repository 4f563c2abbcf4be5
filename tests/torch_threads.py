"""One intra-op torch thread for the port's test modules.

The Tier-1 run spreads the test files over six worker processes on one
machine. Each would run torch with as many intra-op threads as the machine
has cores, and the port's plain versions run many small ops, whose threads
then wait on one another. One module of them on an 8-core machine busy with
the whole test run: 60.7 s with eight threads, 12.0 s with one (idle: 9.6 s
and 12.1 s). Each ``tests/test_torch_*.py`` imports ``one_torch_thread``, which
holds torch at one intra-op thread for that module's tests and restores the
count after them; the results do not depend on it (every comparison is
within the same module, or against JAX within a tolerance).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
