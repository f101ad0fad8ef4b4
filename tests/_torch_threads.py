"""One intra-op thread for the port's CPU tests.

With six pytest-xdist workers sharing the cores, torch's OpenMP threads
contend and slow the port's small ops tenfold (one fixture took 435 s
there against 19 s with one thread). A test module pins one thread for its
whole run with

    from _torch_threads import one_torch_thread  # noqa: F401

which brings this module-scoped autouse fixture into the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
