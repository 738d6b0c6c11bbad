"""A fixture that the port's test files import: one torch intra-op thread
while a module's tests run.

The port's tests run tiny shapes, where torch's thread pool gains nothing,
and its waiting threads contend with the other test processes that
pytest-xdist runs beside them: on an 8-core host the port's files took
93 s under ``-n 6`` with torch's default thread count and 43 s with one.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
