"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root. Tests marked ``cuda`` need an NVIDIA card and skip
elsewhere; each decides inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skips elsewhere")
