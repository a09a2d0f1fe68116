"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` on
the CPU; the ones marked ``cuda`` run on a card and skip without one."""

import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")
