"""One intra-op thread for the port's tests.

The suite runs in several worker processes at once. torch splits an op on
a few hundred thousand elements over every core, so the plain versions'
many small ops spin against each other across workers (a 2 s test took
over 2 min under six workers). Importing ``one_torch_thread`` into a test
module runs that module with one thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
