"""Puts the checkout's root and the benchmark's folder on the path, so the
tests import `port_bench` and `run` as the benchmark's own run does."""
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (BENCH.parent, BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
