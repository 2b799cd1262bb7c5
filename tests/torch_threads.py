"""One torch intra-op thread for the port's CPU tests.

The suite runs one test file per worker, six workers at once. With
torch's default of one intra-op thread per core in every worker, the
port's many small tensor ops spin on oversubscribed cores and run tens of
times slower; one thread per worker keeps each file near its serial time.
Test files import the fixture to use it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
