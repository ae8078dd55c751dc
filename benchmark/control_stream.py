"""Readings that set the limits of the `stream` cells' `correct`, at a cell's
own size: the control (the plain reference computed one precision lower,
TF32 in its matmuls and convolutions, as control.py's) and two faults of
the extend, each a reference put in the program's place and compared with
the reference as the program is. The benchmark's own runs never run this.

    python benchmark/control_stream.py --workload fastlivo.stream --seeds 1,2 \\
        --what control_tf32,dedup_farthest,no_alpha_test --out control.jsonl

Faults: `dedup_farthest` keeps the farthest point of each pixel, not the
nearest; `no_alpha_test` appends where the map's render is already opaque
too (no alpha < 0.99 test).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import spec as specs  # noqa: E402
from reference import extend  # noqa: E402


def farthest_per_pixel(pix, z, n_pix):
    return extend.nearest_per_pixel(pix, -z, n_pix)


WHAT = {"control_tf32": dict(tf32=True),
        "dedup_farthest": dict(winners=farthest_per_pixel),
        "no_alpha_test": dict(alpha_limit=float("inf"))}


def readings(root, cell_name, seed, device, what) -> dict:
    """The gaps of `what` (a key of WHAT) from the reference."""
    import torch

    sp = specs.spec(root)
    cell = specs.cell(sp, cell_name)
    run = SimpleNamespace(root=root, cell=cell, config=specs.config(root, cell["config"]),
                          traffic=specs.traffic(root, cell["traffic"]), seed=seed,
                          device=torch.device(device), layer={}, info={})
    kind = specs.kind(root, run.traffic["kind"])
    kind.inputs(run)
    return kind.gaps(kind.reference(run, **WHAT[what]), kind.reference(run))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default=",".join(WHAT), help="comma-separated keys of WHAT")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", required=True, help="JSON lines file to append to")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for cell in args.workload.split(","):
        for seed in args.seeds.split(","):
            for what in args.what.split(","):
                g = readings(ROOT, cell, int(seed), args.device, what)
                rec = dict(cell=cell, seed=int(seed), what=what, gaps=g)
                print(json.dumps(rec), flush=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
