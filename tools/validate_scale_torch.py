"""Scale validation of the PyTorch/CUDA port: the full production config
(fastlivo rig 640x512) against a synthetic world. Checks that quality
improves and that no binning overflow remains, and reports the train rate.

The counterpart of tools/validate_scale.py, with the same arguments, summary
and PASS rule (train PSNR above 20 dB once 1000 or more iterations ran,
above 17 dB below that, and no overflow), plus `--device` (default cuda:0;
without CUDA it exits with an error unless `--device cpu` is given) and
`--tiny` (the 128x64 rig of tools/soak_torch.py, for a CPU run of the
harness). Imports no JAX.

The train rate divides the iterations by `PhaseTimers.optimize_steps`, the
`frame.optimize` span's seconds: each keyframe's whole `optimize()` call,
its keyframe draw, ids upload and overflow handling included.

Usage: python tools/validate_scale_torch.py [--frames 40] [--points 50000] [--iters 40]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--points", type=int, default=50000)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--skybox", type=int, default=0,
                    help="skybox points (the synthetic GT has no sky; enable with "
                         "max_tiles_per_gaussian>=16 to avoid footprint truncation)")
    ap.add_argument("--tiny", action="store_true",
                    help="128x64 rig for a CPU smoke of the harness itself")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of the run (default cuda:0); cpu runs the "
                         "kernels' plain PyTorch versions")
    return ap


def psnr_bar(iters_total: int) -> float:
    """The quality bar scales with the optimization actually run: early
    keyframes get only #keyframes-so-far iterations (the reference's
    cadence), so short runs cannot reach the long-run PSNR."""
    return 20.0 if iters_total >= 1000 else 17.0


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
    from gaussian_lic_tpu_torch.engine.trainer import MappingEngine
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    overrides = dict(
        max_iters_per_keyframe=args.iters,
        skybox_points_num=args.skybox,
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
    print(f"device={device}  building {args.frames} frames "
          f"({args.points} world points, {cfg.width}x{cfg.height})...", flush=True)
    world = make_world(rng, n_points=args.points, intr=intr)
    t0 = time.perf_counter()
    frames = make_sequence(world, n_frames=args.frames,
                           points_per_frame=args.points // 10, rng=rng, device=device)
    print(f"GT rendering took {time.perf_counter() - t0:.1f}s", flush=True)

    eng = MappingEngine(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    overflow_seen = 0
    for i, f in enumerate(frames):
        was_kf = eng.add_frame(f)
        if was_kf:
            m = eng.last_metrics
            overflow_seen = max(overflow_seen, int(m.get("overflow", 0)))
            print(f"kf {eng.kf_count:3d} @ frame {i:3d}: "
                  f"gaussians={int(eng.gm.count):7d} loss={m['loss']:.4f} "
                  f"overflow={int(m['overflow'])}", flush=True)
    wall = time.perf_counter() - t0
    res = eng.finalize()
    t = eng.timers
    # optimize() runs min(max_iters, #keyframes-so-far) steps per keyframe
    # (reference parity: opt_list = min(100, kf_num), gaussian.cpp:643-662)
    iters_total = sum(
        min(cfg.max_iters_per_keyframe, k) for k in range(1, eng.kf_count + 1)
    )
    summary = {
        "frames": args.frames,
        "keyframes": eng.kf_count,
        "gaussians": int(eng.gm.count),
        "train_psnr": round(res.get("train_psnr", 0), 3),
        "test_psnr": round(res.get("test_psnr", 0), 3),
        "train_ssim": round(res.get("train_ssim", 0), 4),
        "iters_per_sec": round(iters_total / max(t.optimize_steps, 1e-9), 2),
        "mapping_wall_s": round(wall, 1),
        "max_overflow": overflow_seen,
        "recompiles": t.compiles,
    }
    if device.type == "cuda":
        from gaussian_lic_tpu_torch.utils.cuda_timing import card_line

        print(f"card: {card_line()}; peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    print(json.dumps(summary))
    ok = (summary["train_psnr"] > psnr_bar(iters_total) and overflow_seen == 0
          and np.isfinite(summary["train_psnr"]))
    print("VALIDATION", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
