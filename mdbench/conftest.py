"""pytest settings of the benchmark's own tests (python -m pytest mdbench):
the benchmark's folder and the repository's root on the path, one torch
thread a worker, and the marker of tests that need an NVIDIA card."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one); run on "
        "the card with `python -m pytest mdbench -m card`")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch
    torch.set_num_threads(1)
