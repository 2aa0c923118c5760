#!/usr/bin/env python3
"""One run of one cell of the benchmark of thor_tpu_torch on the H100.

    python3 h100_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout.  The cells, their configurations,
traffic mixes and metrics are named in BENCHMARK.json at the root; the
last line of standard output is the run's JSON result, and the numbers
that decided `correct` are the last lines of standard error.  See
h100_bench/README.md.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

if __name__ == "__main__":
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness.cli import main
    sys.exit(main())
