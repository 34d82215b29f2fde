"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` from
the repository's root (the card test: ``-m cuda``, on a machine with a
card).  They make the checkout's root importable, as `run.py` does."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
