"""CPU tests of the decode benchmark: python -m pytest decode_bench/tests

Tests marked `card` need a CUDA card and skip, deciding inside the
test, where there is none.  They run on the card by the same command.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
