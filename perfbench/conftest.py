"""The benchmark's tests: ``pbench`` and ``references`` importable, and
the ``chip`` marker for tests that run only on a CUDA device.

On the card: ``python3 -m pytest -q perfbench/tests -m chip``."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for path in (HERE, HERE.parent / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def one_thread():
    """Toy sizes gain nothing from intra-op threads, and the suite runs
    beside other workers: one thread a test, restored after it."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
