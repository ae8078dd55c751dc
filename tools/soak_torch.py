"""Long-run soak of the PyTorch/CUDA port: a sustained 200+ frame stream at
the full production config (fastlivo rig 640x512, skybox on with K = 16 tile
slots, max_iters_per_keyframe = 100), recording each keyframe's wall clock
against the stream period, the loss/PSNR trajectory, the overflow counters
and the static-shape growths.

The counterpart of tools/soak.py, with the same arguments, overrides,
records and summary, plus `--device` (default cuda:0; without CUDA it exits
with an error unless `--device cpu` is given). Imports no JAX.

Usage:
    python tools/soak_torch.py --frames 600 [--points 120000] [--out soak.json]
    python tools/soak_torch.py --tiny --device cpu --frames 10 --skybox 64 --iters 2

PASS at the end: train PSNR > 17.0, no binning overflow in the second half
of the keyframes, and at most 8 + log2(gaussians) recompiles
(`PhaseTimers.compiles`, what the JAX engine compiles: each bundle size and
extend bucket, and the capacity, keyframe-buffer and splat-budget growths),
so churn would show as O(keyframes) recompiles. On the card the steps run as
CUDA-graph bundles, whose captures (seconds, graph pool) end the run's
output beside the card's line. A keyframe's wall time ends in the host
fetch of its last step's loss (`MappingEngine.optimize`); the PSNR probe is
not billed to the stream. "Steady" keyframes are those past
max_iters_per_keyframe / 2, as in tools/soak.py. `iters_per_sec` divides
by `PhaseTimers.optimize_steps`, the `frame.optimize` span's seconds: each
keyframe's whole `optimize()` call, its keyframe draw, ids upload and
overflow handling included, not the train steps alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_FLOOR = 17.0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--points", type=int, default=120000,
                    help="world points (about the final map size before the skybox)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--skybox", type=int, default=100000)
    ap.add_argument("--psnr-every", type=int, default=10,
                    help="render + PSNR the newest keyframe every N keyframes")
    ap.add_argument("--out", default="soak.json")
    ap.add_argument("--stream-period", type=float, default=0.5,
                    help="seconds between keyframes in the live rig "
                         "(10 Hz camera x keyframe stride 5)")
    ap.add_argument("--tiny", action="store_true",
                    help="128x64 rig for a CPU smoke of the harness itself")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of the run (default cuda:0); cpu runs the "
                         "kernels' plain PyTorch versions")
    return ap


def soak_passes(summary: dict, compiles: int, gaussians: int) -> bool:
    """tools/soak.py's PASS rule: quality, no late overflow, bounded growths."""
    return bool(
        np.isfinite(summary["train_psnr"]) and summary["train_psnr"] > PSNR_FLOOR
        and summary["overflow_second_half"] == 0
        and compiles <= 8 + int(np.log2(max(gaussians, 1)))
    )


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device is available; pass "
              "--device cpu to run the plain PyTorch versions on the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.config import load_params
    from gaussian_lic_tpu_torch.engine.trainer import MappingEngine, _render_kw
    from gaussian_lic_tpu_torch.ops import losses
    from gaussian_lic_tpu_torch.ops.rasterize import render_map
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    overrides = dict(
        max_iters_per_keyframe=args.iters,
        # the skybox needs the full K = 16 slot budget (sky points have huge
        # footprints at the hemisphere radius; K = 8 would truncate rects)
        skybox_points_num=args.skybox,
        max_tiles_per_gaussian=16 if args.skybox else 8,
        initial_capacity=1 << 18,
        densify_budget=1 << 15,
    )
    if args.tiny:
        overrides.update(width=128, height=64, fx=60.0, fy=60.0, cx=64.0,
                         cy=32.0, initial_capacity=1 << 12,
                         densify_budget=1 << 10)
    cfg = load_params(preset="fastlivo", **overrides)
    intr = Intrinsics(width=cfg.width, height=cfg.height,
                      fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy)
    rng = np.random.default_rng(0)
    print(f"device={device}  frames={args.frames} world={args.points} "
          f"skybox={args.skybox} K={cfg.max_tiles_per_gaussian}", flush=True)
    world = make_world(rng, n_points=args.points, intr=intr)
    t0 = time.perf_counter()
    frames = make_sequence(world, n_frames=args.frames,
                           points_per_frame=max(args.points // 20, 2000),
                           rng=rng, device=device)
    print(f"GT synthesis: {time.perf_counter() - t0:.1f}s", flush=True)

    def psnr_probe(eng, idx: int) -> float:
        # the engine's own splat budget, so a large map is not cut short
        with torch.no_grad():
            out = render_map(eng.gm, eng.kf_buffer.camera(intr, idx),
                             **_render_kw(eng.cfg, eng.gm.capacity))
            gt = eng.kf_buffer.images[idx].float() / 255.0
            return float(losses.psnr(out.image, gt))   # host fetch: synchronises

    eng = MappingEngine(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    t_run0 = time.perf_counter()
    last_t = t_run0
    for i, f in enumerate(frames):
        was_kf = eng.add_frame(f)
        if not was_kf:
            continue
        now = time.perf_counter()
        m = eng.last_metrics
        rec = {
            "frame": i,
            "kf": eng.kf_count,
            "gaussians": int(eng.gm.count),
            "loss": round(float(m.get("loss", float("nan"))), 5),
            "budget_lost": int(m.get("budget_lost", 0)),
            "truncated": int(m.get("truncated", 0)),
            "kf_wall_s": round(now - last_t, 3),
            "recompiles": eng.timers.compiles,
        }
        last_t = now
        if args.psnr_every and eng.kf_count % args.psnr_every == 0:
            rec["psnr_kf"] = round(psnr_probe(eng, eng.kf_count - 1), 2)
            last_t = time.perf_counter()  # don't bill the probe to the stream
        records.append(rec)
        print(json.dumps(rec), flush=True)
    wall = time.perf_counter() - t_run0

    res = eng.finalize()
    t = eng.timers
    iters_total = sum(
        min(cfg.max_iters_per_keyframe, k) for k in range(1, eng.kf_count + 1)
    )
    # steady state = keyframes past the reference's ramp
    steady = [r for r in records if r["kf"] > cfg.max_iters_per_keyframe // 2]
    steady_wall = (np.mean([r["kf_wall_s"] for r in steady]) if steady
                   else float("nan"))
    overflow_tail = sum(
        r["budget_lost"] for r in records[len(records) // 2:]
    )
    summary = {
        "frames": args.frames,
        "keyframes": eng.kf_count,
        "gaussians": int(eng.gm.count),
        "iters_total": iters_total,
        "iters_per_sec": round(iters_total / max(t.optimize_steps, 1e-9), 2),
        "train_psnr": round(res.get("train_psnr", 0) or 0, 3),
        "test_psnr": round(res.get("test_psnr", 0) or 0, 3),
        "train_ssim": round(res.get("train_ssim", 0) or 0, 4),
        "wall_s": round(wall, 1),
        "steady_kf_wall_s": (round(float(steady_wall), 3)
                             if steady and np.isfinite(steady_wall) else None),
        "stream_period_s": args.stream_period,
        "realtime_x": round(args.stream_period / steady_wall, 2)
        if steady and np.isfinite(steady_wall) else None,
        "recompiles": t.compiles,
        "overflow_second_half": int(overflow_tail),
        "psnr_trajectory": [
            (r["kf"], r["psnr_kf"]) for r in records if "psnr_kf" in r
        ],
    }
    with open(args.out, "w") as fh:
        json.dump({"summary": summary, "keyframes": records}, fh, indent=1)
    if device.type == "cuda":
        from gaussian_lic_tpu_torch.utils.cuda_timing import card_line

        caps = " ".join(f"{k}:{sec:.3f}" for k, sec, _ in eng.graphs.captures)
        print(f"card: {card_line()}; peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB; graph captures "
              f"(k:seconds) {caps}; graph pool {eng.graphs.pool_bytes / 2**20:.1f} MiB")
    print(json.dumps(summary))
    ok = soak_passes(summary, t.compiles, int(eng.gm.count))
    print("SOAK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
