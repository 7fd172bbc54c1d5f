"""One torch intra-op thread for each of the port's CPU test modules.

The tier-1 command runs six pytest-xdist workers. At torch's default of
one OpenMP thread per core, each worker starts a thread per core, and
the port's many small plain-version ops then spend their time waiting
on oversubscribed threads: the port's test files took 328 s under six
workers at the default and 146 s at one thread, on an 8-core x86 CPU. A
module imports the fixture to run its tests single-threaded; the
previous count comes back after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
