"""Readings that set the limits of `correct`, at a cell's own size: the
control (the plain reference computed one precision lower, TF32 in its
matmuls and convolutions, in the program's place) and planted faults,
each compared with the reference as the program is. The benchmark's own
runs never run this.

    python benchmark/control.py --workload fastlivo.train --seeds 1,2,3 \\
        [--fault half_batch] --out control.jsonl

Faults (train cells), planted in the reference put in the program's place:
`half_batch` takes the loss over the left half of the image's columns
only, its mean over them. A step that returns its state unchanged reads 1
by the change's measure and needs no run.
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
from reference import splat  # noqa: E402


def half_batch_loss(img, gt, lambda_dssim):
    w = img.shape[-1] // 2
    return splat.training_loss(img[..., :w], gt[..., :w], lambda_dssim)


def readings(root, cell_name, seed, device, fault=None):
    """The gaps of the control (or of `fault`) from the reference."""
    import torch

    sp = specs.spec(root)
    cell = specs.cell(sp, cell_name)
    run = SimpleNamespace(root=root, cell=cell, config=specs.config(root, cell["config"]),
                          traffic=specs.traffic(root, cell["traffic"]), seed=seed,
                          device=torch.device(device), layer={}, info={})
    kind = specs.kind(root, run.traffic["kind"])
    kind.inputs(run)
    if run.traffic["kind"] == "train":
        ref = kind.reference(run)
        if fault == "half_batch":
            other = kind.reference(run, loss_fn=half_batch_loss)
        else:
            other = kind.reference(run, tf32=True)
        return kind.gaps(other, ref)
    views = kind.sample(run)
    ref = kind.reference(run, views)
    return kind.gaps(kind.reference(run, views, tf32=True), ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None, choices=(None, "half_batch"))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", required=True, help="JSON lines file to append to")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for cell in args.workload.split(","):
        for seed in args.seeds.split(","):
            g = readings(ROOT, cell, int(seed), args.device, args.fault)
            rec = dict(cell=cell, seed=int(seed), what=args.fault or "control_tf32", gaps=g)
            print(json.dumps(rec), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
