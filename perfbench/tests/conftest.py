"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the repository root.  Tests marked ``card`` need a CUDA card; each decides
inside the test and skips here with its reason."""

import os
import sys

# a few threads a test process: the training cells run a loader thread beside
# the step, and several test processes share the host
os.environ.setdefault("OMP_NUM_THREADS", "2")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
