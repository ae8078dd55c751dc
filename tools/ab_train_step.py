"""Train-step time of several checkouts of the port, in turns, on one GPU.

    python tools/ab_train_step.py OLD_DIR NEW_DIR [--rounds 2]

Each round runs the checkouts in the order A B B A (for two; forward then
backward for more), each in a fresh process that imports that checkout's own
`chip_smoke.py` and runs its `bench_state` + `phase_steps`: the 1M-Gaussian
fastlivo train step, 3 warm-up + 20 timed steps, ms/step from a host clock
around work that ends in `synchronize()` and a loss fetch. Comparing two
versions inside one call on one card in turns is what makes their
difference readable (the card's power limit and the host's load vary
between calls). Prints each run's phase-4 line (the card's name and power
limit in it), then each checkout's ms/step in run order. Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from gaussian_lic_tpu_torch.utils.cuda_timing import card_line
dev = torch.device("cuda:0")
cs.phase_steps(dev, card_line(), cs.bench_state(dev))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout directories (each holds chip_smoke.py)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    for t in trees:
        if not os.path.isfile(os.path.join(t, "chip_smoke.py")):
            print(f"ab_train_step.py: {t} holds no chip_smoke.py", file=sys.stderr)
            return 2
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    ms = {t: [] for t in trees}
    for t in order:
        out = subprocess.run([sys.executable, "-c", _CHILD, t], capture_output=True, text=True)
        line = next((s for s in out.stdout.splitlines() if s.startswith("[4]")), None)
        if out.returncode != 0 or line is None:
            print(out.stdout[-2000:] + out.stderr[-2000:], file=sys.stderr)
            print(f"ab_train_step.py: the run of {t} failed ({out.returncode})", file=sys.stderr)
            return 1
        print(f"{t}: {line}", flush=True)
        ms[t].append(float(re.search(r"([0-9.]+) ms/step", line).group(1)))
    for t in trees:
        print(f"{t}: ms/step " + " ".join(f"{v:.3f}" for v in ms[t]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
