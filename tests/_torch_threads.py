"""One torch thread while a port test module runs.

The tier-1 command runs six test processes on the machine's cores; torch's
default of one intra-op thread a core then oversubscribes them, and the
port's small CPU tensors gain nothing from more than one thread (on an
8-core machine the port's files take a quarter less worker time with
one).  A test module that imports the fixture (``from _torch_threads
import one_torch_thread``) runs all its tests with it, and the process's
count comes back after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
