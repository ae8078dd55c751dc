"""Where the time of one PyTorch-port train step goes, on one GPU.

Builds the train-step benchmark state (1M Gaussians at the fastlivo rig by
default, `utils.synthetic.make_bench_state`), warms up, then runs a few steps
under torch.profiler and prints, per step: the wall time with and without
the profiler, the summed kernel time and the device's busy share, and the
kernels that take the most device time. `--sharded` profiles the multi-GPU
step (parallel.make_sharded_train_step) on a one-rank NCCL group instead of
`train_step`: what the sharded machinery costs on one card. `--capacity`
pads the map to more rows than it has Gaussians, as the engine's capacity
doubling does, and `--tiles-per-gaussian` sets the slot count K (the soak's
skybox config takes 16). Needs a CUDA device; imports no JAX.

Usage: python tools/profile_torch_step.py [--gaussians N] [--steps 5]
                                         [--trace step_trace.json] [--sharded]
                                         [--capacity C] [--tiles-per-gaussian K]
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gaussians", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded step on a one-rank NCCL group")
    ap.add_argument("--capacity", type=int, default=None,
                    help="rows of the padded map (default: the Gaussian count)")
    ap.add_argument("--tiles-per-gaussian", type=int, default=None,
                    help="max_tiles_per_gaussian (default: the fastlivo preset's)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step.py: needs a CUDA device", file=sys.stderr)
        return 2
    from gaussian_lic_tpu_torch.config import load_params
    from gaussian_lic_tpu_torch.engine import trainer
    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    n = args.gaussians
    over = {} if args.tiles_per_gaussian is None else dict(
        max_tiles_per_gaussian=args.tiles_per_gaussian)
    cfg = load_params(preset="fastlivo", initial_capacity=max(args.capacity or n, n),
                      skybox_points_num=0, **over)
    intr, gm, kf, opt = make_bench_state(cfg, n, dev)
    train_step = functools.partial(trainer.train_step, intr=intr, cfg=cfg)
    if args.sharded:
        from gaussian_lic_tpu_torch import parallel

        mesh = parallel.make_mesh(1, device=dev)
        gm, opt = parallel.shard_state(gm, opt, mesh)
        train_step = parallel.make_sharded_train_step(intr, cfg, mesh)

    step = 0

    def run(k):
        nonlocal gm, opt, step
        m = None
        for _ in range(k):
            step += 1
            gm, opt, m = train_step(gm, opt, kf, step % 4, step)
        return m

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = run(args.steps)
    torch.cuda.synchronize()
    float(m["loss"])
    wall_plain = (time.perf_counter() - t0) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = run(args.steps)
        torch.cuda.synchronize()
        float(m["loss"])
        wall_prof = (time.perf_counter() - t0) / args.steps * 1e3
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    events = prof.key_averages()

    def self_dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and self_dev_us(e) > 0), key=self_dev_us, reverse=True)
    total_dev = sum(self_dev_us(e) for e in kernels) / 1e3 / args.steps
    print(f"card: {card}; {n} Gaussians in {gm.capacity} rows, K = "
          f"{cfg.max_tiles_per_gaussian}, {cfg.width}x{cfg.height}; steps {args.steps}; "
          + ("sharded step, one-rank NCCL group" if args.sharded else "train_step"))
    print(f"wall ms/step: {wall_plain:.3f} (unprofiled), {wall_prof:.3f} (profiled)")
    print(f"kernel time: {total_dev:.3f} ms/step; device busy {100 * total_dev / wall_prof:.1f}% "
          f"of the profiled step, {100 * total_dev / wall_plain:.1f}% of the unprofiled one")
    print("top kernels by device time, ms/step:")
    for e in kernels[:25]:
        print(f"  {self_dev_us(e) / 1e3 / args.steps:9.3f}  x{e.count // args.steps:<5d} "
              f"{e.key[:110]}")
    if args.sharded:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
