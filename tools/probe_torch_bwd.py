"""Backward blend kernel (K2) by cost centre: the K4 probes on the card.

The PyTorch/CUDA counterpart of tools/probe_bwd.py. Each variant of
`ops.blend_probe.probe_backward` is K2's own kernel with its pipeline, its
reduction, its output stage or its cull swapped out (base, sbuf, nored,
smematomic, noatomic, nocull; see that module); `base` is K2. On the probe scene
(`utils.synthetic.probe_scene`: 1M Gaussians of the bench state, fastlivo
preset, camera 0, dL/dpix ~ N(0, 0.1) from default_rng(0)) it prints K2's
own time, then per variant the kernel time from CUDA events (its wrapper:
the output's zeros and K2's longest-first argsort included, as K2's), its
difference from base, the max deviation from the variant's plain version
(absolute, and relative to each column's max) and the mean number of
entries walked per tile; then K2's launch order: base in tile order (a
precomputed identity order) against longest first with its argsort, in
turns. The first line is the card's name and power limit. Needs a CUDA
device; imports no JAX.

Usage: python tools/probe_torch_bwd.py [--iters 10] [--variants base,sbuf,...]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GAUSS = 1 << 20
VARIANTS = "base,sbuf,nored,smematomic,noatomic,nocull"


def run(sc: dict, iters: int = 10, variants=None, log=print) -> dict:
    """Times K2 and the backward variants on scene `sc`; returns {variant:
    {ms, vs_base_ms, walked, dev, rel}}, K2's time under "K2" and the
    order's turns under "order" ({tile_ms, longest_ms}, each the mean of
    its two turns)."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w, n_gauss=sc["n_gauss"])
    bargs = (sc["splats"], sc["starts"], sc["lens"], sc["dl"], sc["final_t"], sc["n_contrib"],
             sc["sorted_gauss"])
    walked = torch.empty(g.n_tx * g.n_ty, dtype=torch.int32, device=sc["splats"].device)
    res = {"K2": cuda_ms(lambda: blend.blend_backward(*bargs, **kw), iters, warmup=2)}
    log(f"prod K2 blend_backward: {res['K2']:9.4f} ms")
    for v in variants or bp.BACKWARD_VARIANTS:
        out = bp.probe_backward(v, *bargs, walked=walked, **kw)
        ref = bp.probe_backward_plain(v, *bargs, **kw)
        d = (out - ref).abs().reshape(-1, blend.N_ATTR)
        dev = float(d.max())
        rel = float((d.amax(0) / ref.abs().reshape(-1, blend.N_ATTR).amax(0)
                     .clamp_min(1e-30)).max())
        del out, ref, d
        ms = cuda_ms(lambda: bp.probe_backward(v, *bargs, **kw), iters, warmup=2)
        res[v] = dict(ms=ms, vs_base_ms=ms - res.get("base", {"ms": ms})["ms"],
                      walked=float(walked.double().mean()), dev=dev, rel=rel)
        log(f"bwd {v:10s}: {ms:9.4f} ms  vs base {res[v]['vs_base_ms']:+9.4f} ms  "
            f"walked/tile {res[v]['walked']:8.1f}  max dev vs plain {dev:.2e} "
            f"(rel to column max {rel:.2e})")
    ident = torch.arange(g.n_tx * g.n_ty, dtype=torch.int32, device=sc["splats"].device)
    tile = lambda: bp.probe_backward("base", *bargs, tile_order=ident, **kw)   # noqa: E731
    longest = lambda: bp.probe_backward("base", *bargs, **kw)                  # noqa: E731
    turns = [cuda_ms(f, iters, warmup=2) for f in (tile, longest, longest, tile)]
    res["order"] = dict(tile_ms=(turns[0] + turns[3]) / 2, longest_ms=(turns[1] + turns[2]) / 2)
    log("bwd base launch order, in turns tile longest longest tile (longest first with its "
        "argsort): " + " ".join(f"{t:.4f}" for t in turns) + " ms")
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
