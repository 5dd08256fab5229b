"""Puts the benchmark's directory and the repository's root on the path:
the harness imports its modules by their plain names, as ``run.py`` does."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]
