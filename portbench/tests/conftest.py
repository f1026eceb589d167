"""The benchmark's own CPU tests.  Tests that need a CUDA card carry the
``card`` marker and skip without one, deciding inside the test."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


torch.set_num_threads(2)  # the tiny cells gain nothing from more, and workers share the CPU


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
