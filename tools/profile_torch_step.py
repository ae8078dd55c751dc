"""Where the time of one PyTorch-port train step goes, on one GPU.

Builds the train-step benchmark state (1M Gaussians at the fastlivo rig by
default, `utils.synthetic.make_bench_state`), warms up, then runs a few steps
under torch.profiler (device activity only) and prints, per step: the
wall time with and without the profiler, the summed kernel time and its
split by owner (the hand-written kernels, sort, gathers, elementwise, ...), the
device's idle share read from the profiler's timeline (one minus the union
of the device's kernel and copy intervals over the profiled window, timed
on the host from its first launch to its synchronize()), and the kernels
that take the most device time; `--shapes` also lists the PyTorch ops by
input shape. `--bundle K` profiles K eager steps and then the same K steps
as the engine's K-step bundle (one CUDA graph, captured before the window)
beside them, each from the same state. `--sharded` profiles the multi-GPU
step (parallel.make_sharded_train_step) on a one-rank NCCL group instead of
`train_step`: what the sharded machinery costs on one card. `--capacity`
pads the map to more rows than it has Gaussians, as the engine's capacity
doubling does, and `--tiles-per-gaussian` sets the slot count K (the soak's
skybox config takes 16). Needs a CUDA device; imports no JAX.

Usage: python tools/profile_torch_step.py [--gaussians N] [--steps 5]
                                         [--trace step_trace.json] [--sharded]
                                         [--bundle K]
                                         [--capacity C] [--tiles-per-gaussian K]
                                         [--shapes]
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def idle_share(prof, window_us: float) -> float:
    """1 - (the union of the device's kernel and copy intervals) / (the
    window's host-timed length, microseconds): the device's idle share of a
    window that the profile covers whole and that ends in synchronize().
    nan when the trace holds no device activity."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        return float("nan")
    busy, (a, b) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > b:
            busy, a, b = busy + (b - a), s, e
        else:
            b = max(b, e)
    return 1.0 - (busy + (b - a)) / window_us


# The owners of a step's device time: the first pattern a kernel's name
# holds names its owner (the hand-written kernels, then PyTorch's own).
OWNERS = (("K1 blend forward", "blend_forward_kernel"),
          ("K2 blend backward", "blend_backward_kernel"),
          ("K5 preprocess forward", "preprocess_forward_kernel"),
          ("K6 preprocess backward", "preprocess_backward_kernel"),
          ("K7 sparse Adam", "sparse_adam_kernel"), ("K8 bin keys", "bin_keys_kernel"),
          ("K9 bin ranges", "bin_ranges_kernel"), ("K10 splat gather", "gather_splats_kernel"),
          ("K11 ssim forward", "ssim_forward_kernel"),
          ("K12 ssim backward", "ssim_backward_kernel"),
          ("sort", "radix"), ("sort", "Sort"),
          ("gather, scatter, index", "index"), ("gather, scatter, index", "gather"),
          ("gather, scatter, index", "scatter"), ("reductions", "reduce"),
          ("copies", "copy"), ("fills", "fill"), ("elementwise", "elementwise"))


def owner(name: str) -> str:
    return next((o for o, pat in OWNERS if pat in name), "other")


def self_dev_us(e) -> float:
    """An event's own device time, microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gaussians", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded step on a one-rank NCCL group")
    ap.add_argument("--bundle", type=int, default=None,
                    help="K: profile K eager steps and the K-step bundle (CUDA graph)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="rows of the padded map (default: the Gaussian count)")
    ap.add_argument("--tiles-per-gaussian", type=int, default=None,
                    help="max_tiles_per_gaussian (default: the fastlivo preset's)")
    ap.add_argument("--shapes", action="store_true",
                    help="also profile the eager steps with their ops' input shapes")
    args = ap.parse_args()
    if args.bundle is not None and args.sharded:
        ap.error("--bundle profiles the single-device step")

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
    print(f"card: {card}; {n} Gaussians in {gm.capacity} rows, K = "
          f"{cfg.max_tiles_per_gaussian}, {cfg.width}x{cfg.height}; steps {args.steps}; "
          + ("sharded step, one-rank NCCL group" if args.sharded else "train_step"))

    state = dict(gm=gm, opt=opt, step=0)

    def eager(k):
        m = None
        for _ in range(k):
            state["step"] += 1
            state["gm"], state["opt"], m = train_step(state["gm"], state["opt"], kf,
                                                      state["step"] % 4, state["step"])
        return m

    runs = [("eager steps", eager, args.steps)]
    if args.bundle is not None:
        k = args.bundle
        graphs = trainer.BundleGraphs()
        bundle = trainer._make_train_bundle(intr, cfg, k, graphs)
        ids = torch.arange(1, k + 1, device=dev) % kf.images.shape[0]   # eager's step % 4
        start = (gm, opt)

        def bundled(_):
            state["gm"], state["opt"], m = bundle(start[0], start[1], kf, ids, 1)
            return m

        def eager_from_start(_):
            state["gm"], state["opt"], state["step"] = start[0], start[1], 0
            return eager(k)

        t0 = time.perf_counter()
        bundled(k)                # captures the graph
        torch.cuda.synchronize()
        print(f"bundle of {k}: first call (warm-up, capture, replay) "
              f"{time.perf_counter() - t0:.3f} s; capture {graphs.captures[0][1]:.3f} s, "
              f"graph pool {graphs.pool_bytes / 2**20:.1f} MiB; each call copies the "
              "start state into the graph's static tensors")
        runs = [(f"{k} eager steps", eager_from_start, k), (f"{k}-step bundle", bundled, k)]

    eager(3)
    torch.cuda.synchronize()
    for label, fn, k in runs:
        t0 = time.perf_counter()
        m = fn(k)
        torch.cuda.synchronize()
        float(m["loss"])
        wall_plain = (time.perf_counter() - t0) / k * 1e3

        # device activity only: tracing the host's ops would slow an eager
        # step's launches and read as device idle time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m = fn(k)
            torch.cuda.synchronize()
            float(m["loss"])
            window = time.perf_counter() - t0
        wall_prof = window / k * 1e3
        if args.trace:
            path = args.trace if len(runs) == 1 else args.trace.replace(
                ".json", f"_{label.split()[1]}.json")
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            prof.export_chrome_trace(path)

        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and self_dev_us(e) > 0), key=self_dev_us, reverse=True)
        total_dev = sum(self_dev_us(e) for e in kernels) / 1e3 / k
        idle = idle_share(prof, window * 1e6)
        print(f"[{label}] wall ms/step: {wall_plain:.3f} (unprofiled), {wall_prof:.3f} "
              f"(profiled); kernel time {total_dev:.3f} ms/step; device idle "
              f"{100 * idle:.2f}% of the profiled window (timeline)")
        by_owner = {}
        for e in kernels:
            by_owner[owner(e.key)] = by_owner.get(owner(e.key), 0.0) + self_dev_us(e) / 1e3 / k
        print(f"[{label}] device time by owner, ms/step: " + "; ".join(
            f"{o} {v:.3f}" for o, v in sorted(by_owner.items(), key=lambda kv: -kv[1])))
        print(f"[{label}] top kernels by device time, ms/step:")
        for e in kernels[:25]:
            print(f"  {self_dev_us(e) / 1e3 / k:9.3f}  x{e.count / k:<7.1f} {e.key[:110]}")
    if args.shapes:
        # host ops recorded with their input shapes: slows the launches, so
        # only the device time of each (op, shapes) is read
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            eager(args.steps)
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                      if e.key.startswith("aten::") and self_dev_us(e) > 0),
                     key=self_dev_us, reverse=True)
        print(f"[ops by shape] {args.steps} eager steps, self device ms/step, calls/step, op, "
              "input shapes:")
        for e in ops[:25]:
            print(f"  {self_dev_us(e) / 1e3 / args.steps:9.3f}  x{e.count / args.steps:<7.1f} "
                  f"{e.key:20s} {str(e.input_shapes)[:90]}")
    if args.sharded:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
