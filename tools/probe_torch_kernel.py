"""Forward blend kernel (K1) by cost centre: the K3 probes on the card.

The PyTorch/CUDA counterpart of tools/probe_kernel.py. Each variant of
`ops.blend_probe.probe_forward` is K1's own kernel with one cost centre
taken out (base, nocull, noexp, noattr, noblend, batch256, direct; see that
module); `base` is K1. On the probe scene (`utils.synthetic.probe_scene`: 1M
Gaussians of the bench state, fastlivo preset, camera 0) it prints K1's own
time, then per variant the kernel time from CUDA events, its difference
from base, the max deviation from the variant's plain version (image and
final_T; n_contrib mismatches) and the mean number of entries walked per
tile (noexp, noattr and noblend change where the walk stops). The first
line is the card's name and power limit. Needs a CUDA device; imports no
JAX.

Usage: python tools/probe_torch_kernel.py [--iters 10]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GAUSS = 1 << 20


def run(sc: dict, iters: int = 10, log=print) -> dict:
    """Times K1 and every forward variant on scene `sc`; returns {variant:
    {ms, vs_base_ms, walked, dev, nc_mismatches}} and K1's time under "K1"."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    args = (sc["splats"], sc["starts"], sc["lens"])
    walked = torch.empty(g.n_tx * g.n_ty, dtype=torch.int32, device=sc["splats"].device)
    res = {"K1": cuda_ms(lambda: blend.blend_forward(*args, **kw), iters, warmup=2)}
    log(f"prod K1 blend_forward: {res['K1']:9.4f} ms")
    for v in bp.FORWARD_VARIANTS:
        out = bp.probe_forward(v, *args, walked=walked, **kw)
        ref = bp.probe_forward_plain(v, *args, **kw)
        dev = max(float((out[0] - ref[0]).abs().max()), float((out[1] - ref[1]).abs().max()))
        mism = int((out[2] != ref[2]).sum())
        del out, ref
        ms = cuda_ms(lambda: bp.probe_forward(v, *args, **kw), iters, warmup=2)
        res[v] = dict(ms=ms, vs_base_ms=ms - res.get("base", {"ms": ms})["ms"],
                      walked=float(walked.double().mean()), dev=dev, nc_mismatches=mism)
        log(f"fwd {v:9s}: {ms:9.4f} ms  vs base {res[v]['vs_base_ms']:+9.4f} ms  "
            f"walked/tile {res[v]['walked']:8.1f}  max dev vs plain {dev:.2e} "
            f"(n_contrib mismatches {mism})")
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
