"""One run of one cell: set up, measure for `--seconds`, check the timed
path's outputs against the plain reference, print the result's line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and per-layer readers are found by name
(harness/spec.py). The traffic's kind (benchmark/kinds/<kind>.py) provides

    setup(run)    build the program's state from the seed and warm up every
                  shape the window uses; the checked steps run here
    window(run)   the measured calls; sets run.e2e, run.attempted, run.failed
    release(run)  drop the program's state before the reference runs
    check(run)    [(name, value, limit)] of the comparison with the reference

and `run` carries the cell, its configuration and traffic, the seed, the
device, `trace` and what the kind records. With `--trace 1` the window runs
under the profiler and the line carries the per-layer metrics; else the
end-to-end ones. The run fails, printing no result, without a card, or if
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from types import SimpleNamespace

from harness import spec as specs

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_lic_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port's runs must not load,
    compared whole (`gaussian_lic_tpu_torch` is not `gaussian_lic_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the port's nvcc
    build already lives in gaussian_lic_tpu_torch/build/)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: str = None, t_start: float = None, device: str = None) -> int:
    """`device` None takes the card and fails without one; the tests pass
    "cpu" to drive a tiny cell on the port's plain versions."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = root or os.getcwd()
    cache_env(root)
    sp = specs.spec(root)
    cell = specs.cell(sp, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA device(s), found {have}",
                  file=sys.stderr)
            return 3
        device = "cuda:0"
    run = SimpleNamespace(
        root=root, cell=cell, config=specs.config(root, cell["config"]),
        traffic=specs.traffic(root, cell["traffic"]), seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device(device), e2e={}, attempted=0, failed=0,
        info={}, layer={})
    kind = specs.kind(root, run.traffic["kind"])
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.set_device(run.device)
    kind.setup(run)
    if on_card:
        torch.cuda.synchronize(run.device)
    setup_s = time.perf_counter() - t_start
    kind.window(run)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    if on_card:
        from gaussian_lic_tpu_torch import _build

        # the nvcc build of a checkout's first run, inside setup_s and
        # recorded apart (0 once the library is built)
        run.info["build_s"] = _build.load().build_seconds
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    kind.release(run)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared = kind.check(run)
    run.info["check_s"] = time.perf_counter() - t_check
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in compared)

    metrics = {}
    if run.trace:
        for m in specs.per_layer(sp, cell["name"]):
            v = specs.reader(root, m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        for m in specs.end_to_end(sp, cell["name"]):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
           "count": 1 if on_card else 0, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if run.trace and "trace" in run.layer:
        t = run.layer["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t["device_ops"]],
                               "idle_gaps": [[n, s] for n, s in t["idle_gaps"]]}
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    print("info " + json.dumps(dict(run.info, setup_s=setup_s)))
    for n, v, lim in compared:
        print(f"compared {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
