"""Settings of the benchmark's own tests (run by hand; see
``benchmark/README.md``). The ``cuda`` marker is the repository's marker of
tests that need the card: such a test decides inside itself whether a card
exists and skips without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skips without them)")
