"""Puts the benchmark's folder and the repository's root on the path of
the benchmark's own tests (python -m pytest benchmark/tests)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))):
    if p not in sys.path:
        sys.path.insert(0, p)
