"""One intra-op torch thread for the port's test modules.

Several pytest workers share the CPU and the port's tests run small tensors,
so each of their modules imports `one_torch_thread`, an autouse fixture that
caps torch at one thread for that module and restores the old count after
it.  The cap never leaks into other modules of the same worker."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
