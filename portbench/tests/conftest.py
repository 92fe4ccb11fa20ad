"""The benchmark's tests: CPU tests at small sizes, and tests marked
``card`` that need a CUDA card (they skip at run time without one). Run
them from the root of the repo:

    PYTHONPATH=src python -m pytest -q portbench/tests
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips at run time without one")
