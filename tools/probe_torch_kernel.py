"""Forward blend kernel (K1) by cost centre: the K3 probes on the card.

The PyTorch/CUDA counterpart of tools/probe_kernel.py. Each variant of
`ops.blend_probe.probe_forward` replaces one cost centre of K1 with a cheap
stand-in (base, noexp, noattr, noblend, batch512, direct; see that module).
On the probe scene (`utils.synthetic.probe_scene`: 1M Gaussians of the bench
state, fastlivo preset, camera 0) it prints, per variant, the kernel time
from CUDA events, the max color deviation from base and the mean number of
entries walked per tile (noexp, noattr and noblend change where the walk
stops). The first line is the card's name and power limit. Needs a CUDA
device; imports no JAX.

Usage: python tools/probe_torch_kernel.py [--iters 10]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GAUSS = 1 << 20


def run(sc: dict, iters: int = 10, log=print) -> dict:
    """Times every forward variant on scene `sc`; returns {variant: {ms,
    walked, dev}}."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    args = (sc["splats"], sc["starts"], sc["lens"])
    walked = torch.empty(g.n_tx * g.n_ty, dtype=torch.int32, device=sc["splats"].device)
    res, base = {}, None
    for v in bp.FORWARD_VARIANTS:
        out = bp.probe_forward(v, *args, walked=walked, **kw)
        base = out if base is None else base      # FORWARD_VARIANTS[0] is base
        dev = float((out[0] - base[0]).abs().max())
        ms = cuda_ms(lambda: bp.probe_forward(v, *args, **kw), iters, warmup=2)
        res[v] = dict(ms=ms, walked=float(walked.double().mean()), dev=dev)
        log(f"fwd {v:9s}: {ms:9.4f} ms  walked/tile {res[v]['walked']:8.1f}  "
            f"max color dev vs base {dev:.2e}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_kernel.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gaussian_lic_tpu_torch.config import load_params
    from gaussian_lic_tpu_torch.utils.cuda_timing import card_line
    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state, probe_scene

    print(card_line(), flush=True)
    cfg = load_params(preset="fastlivo", initial_capacity=N_GAUSS, skybox_points_num=0)
    intr, gm, kf, _ = make_bench_state(cfg, N_GAUSS, torch.device("cuda:0"))
    sc = probe_scene(cfg, intr, gm, kf)
    lens = sc["lens"].double()
    print(f"scene: {N_GAUSS} Gaussians, {sc['splats'].shape[0]} list entries, tile lens "
          f"mean {float(lens.mean()):.1f} max {int(lens.max())}", flush=True)
    run(sc, args.iters, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
