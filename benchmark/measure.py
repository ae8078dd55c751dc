"""Runs cells of the benchmark several times, one process after another, and
summarises each metric's spread: the median, the first and third quartile
(`statistics.quantiles(values, n=4)`) and their distance over the median.

    python benchmark/measure.py --workload fastlivo.train --seeds 11,12,13 \\
        --seconds 10 [--trace 1] --out runs.jsonl

Each run's result line (with its seed, exit code and the card's name and
power limit) is appended to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return dict(median=q2, q1=q1, q3=q3, spread=(q3 - q1) / q2 if q2 else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True, help="cell names, comma-separated")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True, help="JSON lines file to append to")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    power = card()
    for cell in args.workload.split(","):
        values = {}
        for seed in args.seeds.split(","):
            t0 = time.time()
            p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
                                "--seed", seed, "--seconds", str(args.seconds),
                                "--trace", str(args.trace)], cwd=ROOT, capture_output=True,
                               text=True)
            lines = p.stdout.strip().splitlines()
            rec = dict(cell=cell, seed=int(seed), trace=args.trace, rc=p.returncode,
                       wall_s=time.time() - t0, card=power,
                       info=next((json.loads(s[5:]) for s in lines if s.startswith("info ")), None))
            try:
                rec["result"] = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                rec["stderr"] = p.stderr[-3000:]
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            res = rec.get("result", {})
            print(cell, seed, "rc", p.returncode, f"wall {rec['wall_s']:.1f}s", "correct",
                  res.get("correct"), json.dumps({k: v["value"] for k, v in
                                                  res.get("metrics", {}).items()}),
                  json.dumps(res.get("compared", {})), flush=True)
            if "stderr" in rec:
                print(rec["stderr"], flush=True)
            for k, v in res.get("metrics", {}).items():
                values.setdefault(k, []).append(v["value"])
        for k, vs in values.items():
            print("spread", cell, k, json.dumps(spread(vs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
