"""Runnable mapping app — the `gs_mapping` node equivalent (mapping.cpp:203-242).

The counterpart of the JAX package's `run.py`, with the same flags. Replays a
recorded odometry stream (or a built-in synthetic demo) through the whole
pipeline: stream alignment (the native C++ aligner when it builds) ->
watchdog -> incremental mapping (init / densify / <=N-step optimization per
keyframe) -> end-of-run quality eval (PSNR/SSIM/LPIPS on train and held-out
views) -> 3DGS PLY export, with the reference's runtime-stats printout
(mapping.cpp:188-195).

Usage:
    python -m gaussian_lic_tpu_torch --input /path/to/stream_dir \\
        --config config/fastlivo.yaml --lpips-path randinit --result-path out/ \\
        [--checkpoint out/ckpt.npz] [--resume out/ckpt.npz] [--phase-timers]
    python -m gaussian_lic_tpu_torch --demo --device cpu --result-path /tmp/out

A stream directory holds frame_XXXXX.npz files (engine.stream.RecordedStream
schema); `--input` also takes a ROS1 .bag or ros://[master_uri]. The run uses
`--device` (default cuda:0) and never falls back to another device: without
CUDA it exits with an error unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from gaussian_lic_tpu_torch.config import Params, load_params
from gaussian_lic_tpu_torch.engine.dataset import FrameInput
from gaussian_lic_tpu_torch.engine.stream import (
    NativeStreamAligner,
    RecordedStream,
    Watchdog,
    make_aligner,
)
from gaussian_lic_tpu_torch.engine.trainer import MappingEngine
from gaussian_lic_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint


def _demo_frames(cfg: Params, n_frames: int = 25, device="cpu"):
    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    rng = np.random.default_rng(cfg.seed)
    intr = Intrinsics(width=cfg.width, height=cfg.height,
                      fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy)
    world = make_world(rng, n_points=600, intr=intr)
    return make_sequence(world, n_frames=n_frames, points_per_frame=250, rng=rng,
                         device=device)


def run_stream(
    engine: MappingEngine,
    frames: Iterable[FrameInput],
    use_aligner: bool = True,
    verbose: bool = True,
) -> dict:
    """Feed frames through the aligner + watchdog into the engine
    (the mapping-thread loop, mapping.cpp:124-200)."""
    aligner = make_aligner()
    if use_aligner:
        kind = ("native (csrc/glic_runtime.cpp)" if isinstance(aligner, NativeStreamAligner)
                else "Python (native runtime unavailable)")
        print(f"[stream] aligner: {kind}")
    watchdog = Watchdog()
    t_start = time.perf_counter()
    n_frames = 0
    frame_iter = iter(frames)
    while True:
        # The reference watchdog fires on >1 s without a point message
        # (mapping.cpp:224-234): source silence, not mapping latency (its
        # subscriber callbacks run on their own thread). In this synchronous
        # replay loop that is the time spent waiting on the source iterator.
        t_wait = time.monotonic()
        try:
            frame = next(frame_iter)
        except StopIteration:
            break
        source_wait = time.monotonic() - t_wait
        if use_aligner and watchdog.initialized and source_wait > watchdog.timeout:
            print("[watchdog] >1 s without point data — ending the run "
                  "(mapping.cpp:224-234)")
            break
        if use_aligner:
            # the three reference topics (/points_for_gs /pose_for_gs /image_for_gs)
            aligner.push_points(frame.timestamp, (frame.points, frame.colors))
            aligner.push_pose(frame.timestamp, (frame.R_wc, frame.t_wc))
            aligner.push_image(frame.timestamp, frame.image)
            got = aligner.pop_aligned()
            if got is None:
                continue
            stamp, (pts, cols), (R_wc, t_wc), img = got
            frame = FrameInput(timestamp=stamp, R_wc=R_wc, t_wc=t_wc, image=img,
                               points=pts, colors=cols)
        was_kf = engine.add_frame(frame)
        watchdog.initialized = engine.initialized
        n_frames += 1
        if verbose and was_kf:
            m = engine.last_metrics
            print(
                f"[frame {n_frames:5d}] keyframe {engine.kf_count:4d}  "
                f"gaussians {int(engine.gm.count):8d}  "
                f"loss {m.get('loss', float('nan')):.4f}  "
                f"overflow {int(m.get('overflow', 0))}"
            )
    wall = time.perf_counter() - t_start

    t = engine.timers
    print("\n===== runtime stats (cf. mapping.cpp:188-195) =====")
    print(f"  frames processed      : {n_frames}")
    print(f"  train keyframes       : {engine.kf_count}")
    print(f"  total wall time       : {wall:.2f} s "
          f"({n_frames / max(wall, 1e-9):.1f} frames/s)")
    print(f"  optimize (train steps): {t.optimize_steps:.2f} s")
    print(f"  adding (frame ingest) : {t.adding:.2f} s")
    print(f"  extending (densify)   : {t.extending:.2f} s")
    print(f"  capacity growths      : {t.compiles}")
    return {"frames": n_frames, "wall_s": wall}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gaussian_lic_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="recorded stream directory (frame_*.npz), "
                                     "a ROS1 .bag with the three topics, or "
                                     "ros://[master_uri] to subscribe to a "
                                     "live ROS1 graph (default $ROS_MASTER_URI)")
    src.add_argument("--demo", action="store_true",
                     help="synthetic demo sequence (no data needed)")
    ap.add_argument("--points-topic", default="/points_for_gs")
    ap.add_argument("--pose-topic", default="/pose_for_gs")
    ap.add_argument("--image-topic", default="/image_for_gs")
    ap.add_argument("--config", help="reference-schema YAML config")
    ap.add_argument("--preset", choices=("fastlivo", "r3live", "mcd"),
                    help="camera rig preset (config/<preset>.yaml equivalents)")
    ap.add_argument("--result-path", help="output dir: eval dumps + point_cloud.ply")
    ap.add_argument("--lpips-path", help="LPIPS weights (.npz/.pt/.pth or dir), "
                                         "or randinit[:seed]")
    ap.add_argument("--checkpoint", help="write a resumable checkpoint here at exit")
    ap.add_argument("--resume", help="resume from a checkpoint written earlier")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of the run (default cuda:0); cpu runs the "
                         "kernels' plain PyTorch versions")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="shard training over N devices (not ported: only 0)")
    ap.add_argument("--demo-frames", type=int, default=25)
    ap.add_argument("--max-iters", type=int, default=None,
                    help="override max train iters per keyframe")
    ap.add_argument("--no-aligner", action="store_true",
                    help="bypass the stream aligner (frames are pre-aligned)")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler chrome trace of the stream to "
                         "DIR/trace.json")
    ap.add_argument("--phase-timers", action="store_true",
                    help="measure the forward/backward/optimizer split of one "
                         "train step at the end of the run (mapping.cpp:188-195)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv: Optional[list] = None,
         engine_factory: Callable[..., MappingEngine] = MappingEngine) -> int:
    """The CLI. `engine_factory(cfg, result_path=, lpips_path=, device=)`
    makes the run's engine; a caller may pass one that keeps a reference."""
    args = _parser().parse_args(argv)
    if args.mesh_devices:
        print("error: --mesh-devices: multi-GPU training (the JAX package's "
              "parallel/sharded.py) is not ported yet; run with one device",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device is available; pass "
              "--device cpu to run the plain PyTorch versions on the CPU",
              file=sys.stderr)
        return 2

    overrides = {}
    if args.demo:
        # the demo world is small: a fast 128x64 rig
        overrides.update(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0,
                         skybox_points_num=0, initial_capacity=1 << 12,
                         densify_budget=1 << 10, max_train_keyframes=64)
    if args.max_iters is not None:
        overrides["max_iters_per_keyframe"] = args.max_iters
    cfg = load_params(path=args.config, preset=args.preset, **overrides)

    engine = engine_factory(cfg, result_path=args.result_path,
                            lpips_path=args.lpips_path, device=device)
    print(f"[run] device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    if args.resume:
        gm, opt_state, _extra = load_checkpoint(args.resume, device=device)
        engine.gm = gm
        engine.opt_state = opt_state
        print(f"resumed from {args.resume}: {int(gm.count)} gaussians")

    use_aligner = not args.no_aligner
    if args.demo:
        frames = _demo_frames(cfg, args.demo_frames, device=device)
    elif args.input.startswith("ros://"):
        from gaussian_lic_tpu_torch.io.ros_live import RosLiveStream

        # live TCPROS subscriber (the reference node's three-topic feed,
        # mapping.cpp:203-242); aligns internally with the same +-10 ms policy
        master = args.input[len("ros://"):] or None
        if master and not master.startswith("http"):
            master = f"http://{master}"
        frames = RosLiveStream(master_uri=master, points_topic=args.points_topic,
                               pose_topic=args.pose_topic, image_topic=args.image_topic)
        use_aligner = False
        print("[stream] aligner: Python, inside RosLiveStream")
    elif args.input.endswith(".bag"):
        from gaussian_lic_tpu_torch.io.rosbag import RosbagStream

        frames = RosbagStream(args.input, points_topic=args.points_topic,
                              pose_topic=args.pose_topic, image_topic=args.image_topic)
        use_aligner = False
        print("[stream] aligner: Python, inside RosbagStream")
    else:
        frames = RecordedStream(args.input)
    if args.no_aligner:
        print("[stream] aligner: none (--no-aligner)")

    profiler = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    with profiler as prof:
        run_stream(engine, frames, use_aligner=use_aligner, verbose=not args.quiet)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")

    if args.phase_timers:
        engine.measure_phase_split()

    results = engine.finalize()
    if results:
        print("\n===== quality (cf. gaussian.cpp:784-829) =====")
        for k in sorted(results):
            v = results[k]
            print(f"  {k:16s}: " + (f"{v:.4f}" if v is not None else "skipped"))

    if args.checkpoint and engine.initialized:
        save_checkpoint(args.checkpoint, engine.gm, engine.opt_state,
                        extra={"kf_count": engine.kf_count})
        print(f"checkpoint written to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
