"""CPU tests of the benchmark (run from the repository's root:
``python -m pytest perfbench/tests -q -p no:cacheprovider``). Tests marked
``chip`` need the card and skip inside their fixture where there is none;
on the card run them with ``-m chip``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark's card tests run on "
                    "the chip")
    return torch.device("cuda")
