"""Backward blend kernel (K2 in its first design) by cost centre: the K4 probes on the card.

The PyTorch/CUDA counterpart of tools/probe_bwd.py. Each variant of
`ops.blend_probe.probe_backward` replaces K2's batch pipeline or its
reduction (base, dbuf2, nored, smematomic, fused; see that module). On the
probe scene (`utils.synthetic.probe_scene`: 1M Gaussians of the bench state,
fastlivo preset, camera 0, dL/dpix ~ N(0, 0.1) from default_rng(0)) it prints
K2's own time, then per variant the kernel time from CUDA events, the max
deviation from base (absolute and relative to base's max) and the mean
number of entries walked per tile. `fused` writes per-Gaussian grads, so it
is compared with, and timed beside, base + the index_add_ that followed
the first K2. Today's K2 (csrc/blend_backward.cu) writes per-Gaussian sums
too, so its time is the one to set beside those two. The first line is the
card's name and power limit. Needs a CUDA device; imports no JAX.

Usage: python tools/probe_torch_bwd.py [--iters 10] [--variants base,dbuf2,...]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GAUSS = 1 << 20
VARIANTS = "base,dbuf2,nored,smematomic,fused"


def run(sc: dict, iters: int = 10, variants=None, log=print) -> dict:
    """Times K2 and the backward variants on scene `sc`; returns {variant:
    {ms, walked, dev, rel}}, fused also with `base_index_add_ms`."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    bargs = (sc["splats"], sc["starts"], sc["lens"], sc["dl"], sc["final_t"], sc["n_contrib"])
    fkw = dict(kw, sorted_gauss=sc["sorted_gauss"], n_gauss=sc["n_gauss"])
    walked = torch.empty(g.n_tx * g.n_ty, dtype=torch.int32, device=sc["splats"].device)

    def base_index_add():
        per_entry = bp.probe_backward("base", *bargs, **kw)
        out = per_entry.new_zeros((sc["n_gauss"] + 1, blend.N_ATTR))
        return out.index_add_(0, sc["sorted_gauss"].long(), per_entry)

    k2 = lambda: blend.blend_backward(*bargs, sc["sorted_gauss"], n_gauss=sc["n_gauss"], **kw)
    log(f"prod K2 blend_backward (per-Gaussian sums in the kernel): "
        f"{cuda_ms(k2, iters, warmup=2):9.4f} ms")
    base = bp.probe_backward("base", *bargs, **kw)
    res = {}
    for v in variants or bp.BACKWARD_VARIANTS:
        out = bp.probe_backward(v, *bargs, walked=walked, **fkw)
        ref = base_index_add() if v == "fused" else base
        dev = float((out - ref).abs().max())
        rel = dev / max(float(ref.abs().max()), 1e-30)
        ms = cuda_ms(lambda: bp.probe_backward(v, *bargs, **fkw), iters, warmup=2)
        res[v] = dict(ms=ms, walked=float(walked.double().mean()), dev=dev, rel=rel)
        line = (f"bwd {v:10s}: {ms:9.4f} ms  walked/tile {res[v]['walked']:8.1f}  "
                f"max dev vs base {dev:.2e} (rel {rel:.2e})")
        if v == "fused":
            res[v]["base_index_add_ms"] = cuda_ms(base_index_add, iters, warmup=2)
            line += f"; base + index_add_ {res[v]['base_index_add_ms']:.4f} ms"
        log(line)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", default=VARIANTS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_bwd.py: needs a CUDA device", file=sys.stderr)
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
    run(sc, args.iters, args.variants.split(","), log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
