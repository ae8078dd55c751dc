"""Runs one cell of the benchmark of `gaussian_lic_tpu_torch` once, from the
root of a checkout:

    python benchmark/run.py --workload fastlivo.train --seed 7 --seconds 10 --trace 0

Its last line on standard output is the result (harness/cli.py)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], root=ROOT, t_start=T_START))
