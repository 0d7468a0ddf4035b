"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from the
repository root. Tests marked ``cuda`` need an NVIDIA card and skip without
one; each decides inside the test, never while it is imported."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs an NVIDIA card (skips without one)')
