"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q``.

Tests that need the card carry the ``chip`` marker and skip without one;
each decides inside the test, never at import.  On the card: ``python -m
pytest portbench/tests -q -m chip``."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
