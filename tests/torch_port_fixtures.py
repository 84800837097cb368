"""Fixtures shared by the port's test files; a file takes one by
importing it by name."""
import shutil

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread in the importing module: the suite runs several
    worker processes on the machine's cores, and PyTorch's default of one
    thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted when the test ends.  pytest keeps the
    temporary directories of the last three sessions; the training tests
    write checkpoints of the full-width detector (a few hundred MB each),
    and three sessions of them filled the disk a whole run writes to."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
