"""One torch CPU thread for the port's CPU tests.

The Tier-1 run puts six pytest workers on eight cores. A test of a small
model gains nothing there from torch's intra-op threads and loses much to
them: each parallel op waits for threads that the other workers hold (the
Darcy training-CLI test took 440-500 s under that load with torch's default
threads, 11 s on one). A port test file imports ``one_torch_thread``, an
autouse fixture, so each of its tests runs on one torch thread; the count is
restored after.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
