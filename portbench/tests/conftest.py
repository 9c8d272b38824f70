"""The benchmark's own tests (run them with ``python -m pytest
portbench/tests -q`` from the root of a checkout).  Tests marked ``chip``
need an NVIDIA GPU and skip without one, deciding inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs an NVIDIA GPU (skips without one)")
