"""The port's test files run on one torch thread.

Import the fixture into a test module to make it autouse there::

    from torch_threads import one_thread  # noqa: F401

Under the suite's six workers each worker would otherwise start one
thread a core, and the small models these files run gain nothing from
more threads: beside the other workers they only contend.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process for the module's tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
