"""K6 (the preprocess backward) under other register budgets, on one GPU.

    python tools/k6_occupancy.py [--min-blocks 1,8] [--rounds 2]

Builds the kernel library once as it is and once for each `--min-blocks`
value B with K6's launch bounds set to (128, B) (at most 65536 / (128 B)
registers a thread: 255 at 1, 80 at 6 (K6's own), 64 at 8), each from a
copy of csrc/ under gaussian_lic_tpu_torch/build/k6_occupancy/, and
prints ptxas's registers and spill bytes for K6. Then it times K6 of each build in turns (forward
then backward order, `--rounds` times; 50 launches each, CUDA events) on
the arguments of chip_smoke.py's 1M-Gaussian train step, K2's output as its
row gradients, after checking that each build's outputs equal the first's
bit for bit, and beside them a device-to-device copy of as many bytes as
K6 must move (chip_smoke.preprocess_bytes): the rate a plain stream
reaches on this card. The first line is the card's name and power limit.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BOUNDS = "__launch_bounds__(kK6Threads, kK6MinBlocks)"


def build(name: str, min_blocks: int):
    """The kernel library of csrc/ with K6's min blocks set to `min_blocks`
    (0: as it is), and K6's ptxas line."""
    from gaussian_lic_tpu_torch import _build

    src = os.path.join(_build.PKG_DIR, "csrc")
    root = os.path.join(_build.PKG_DIR, "build", "k6_occupancy", name)
    if min_blocks:
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(src, os.path.join(root, "csrc"))
        path = os.path.join(root, "csrc", "preprocess_backward.cuh")
        with open(path) as f:
            text = f.read()
        if BOUNDS not in text:
            raise RuntimeError(f"{BOUNDS} not found in preprocess_backward.cuh")
        with open(path, "w") as f:
            f.write(text.replace(BOUNDS, f"__launch_bounds__(kK6Threads, {min_blocks})"))
        src = os.path.join(root, "csrc")
    _build.CSRC_DIR, _build.BUILD_DIR = src, os.path.join(root, "build")
    _build.load.cache_clear()
    lib = _build.load()
    log = lib.build_log.splitlines()
    report = ""
    for i, line in enumerate(log):
        if ("Compiling entry" in line and "preprocess_backward_kernelILi0E" in line
                and "probe" not in line):
            report = "; ".join(re.sub(r"^ptxas info\s*:\s*", "", x.strip())
                               for x in log[i + 1:i + 5] if "registers" in x or "spill" in x)
    return lib, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-blocks", default="1,8",
                    help="comma-separated launch-bound block counts to build beside K6")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k6_occupancy.py: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussian_lic_tpu_torch import _build
    from gaussian_lic_tpu_torch.ops import blend, preprocess as pre
    from gaussian_lic_tpu_torch.utils.cuda_timing import card_line, cuda_ms

    print(card_line(), flush=True)
    load = _build.load
    libs = {"K6": build("K6", 0)}
    for b in (int(v) for v in args.min_blocks.split(",") if v):
        libs[f"min_blocks={b}"] = build(f"mb{b}", b)
    for name, (_, report) in libs.items():
        print(f"{name}: {report}", flush=True)

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load = lambda: libs["K6"][0]
    sc = cs.step_scene(cs.bench_state(dev))
    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    args3 = (sc["splats"], sc["starts"], sc["lens"])
    _, ft, nc = blend.blend_forward(*args3, **kw)
    d_attrs = blend.blend_backward(*args3, sc["dl"], ft, nc, sc["sorted_gauss"],
                                   n_gauss=sc["n_gauss"], **kw)
    x = sc["inputs"]
    bargs = tuple(x[k] for k in ("xyz", "scale", "quat", "opacity")) + (
        x["camera"], x["dc"], x["sh_rest"], x["sh_degree"], d_attrs)
    ref = pre.preprocess_backward(*bargs)
    nbytes = cs.preprocess_bytes(x["xyz"].shape[0], x["sh_rest"].shape[1])["backward"]
    src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    runs = {name: lambda name=name: pre.preprocess_backward(*bargs) for name in libs}
    runs["copy"] = lambda: dst.copy_(src)
    times = {name: [] for name in runs}
    order = list(runs) + list(runs)[::-1]
    for _ in range(args.rounds):
        for name in order:
            if name in libs:
                _build.load = lambda name=name: libs[name][0]
                out = pre.preprocess_backward(*bargs)
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    raise AssertionError(f"{name}'s outputs differ from K6's")
            times[name].append(cuda_ms(runs[name], 50, warmup=3))
    _build.load = load
    for name, ms in times.items():
        what = f"a copy of {nbytes} bytes" if name == "copy" else name
        print(f"{what}: " + " ".join(f"{t:.4f}" for t in ms) + " ms  (bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
