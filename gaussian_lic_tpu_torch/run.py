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

`--mesh-devices N` trains tile-band-sharded over N ranks (parallel/): N > 1
starts N processes (parallel.launch.spawn; rank r on cuda:r with NCCL, one
GPU per rank, or on the CPU with gloo for `--device cpu`), N = 1 runs a
one-rank group in this process. Rank 0 opens the input and broadcasts each
aligned frame to the others; rank 0 alone prints the results and writes the
result path, the PLY and the checkpoint.

`--profile DIR` records the stream and its end-of-run eval under
torch.profiler: DIR/trace.json is the chrome trace, the port's `glic.*`
spans (utils/trace.py) beside the kernels, and DIR/record.json the spans'
counts and host ms by name and the counters (`host_syncs`, `h2d_bytes`,
`extend.candidates` / `extend.added`, the growths and graph captures).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

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
from gaussian_lic_tpu_torch.utils import trace


def _demo_frames(cfg: Params, n_frames: int = 25, device="cpu"):
    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    rng = np.random.default_rng(cfg.seed)
    intr = Intrinsics(width=cfg.width, height=cfg.height,
                      fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy)
    world = make_world(rng, n_points=600, intr=intr)
    return make_sequence(world, n_frames=n_frames, points_per_frame=250, rng=rng,
                         device=device)


def _aligned_frames(engine, frames: Iterable[FrameInput], use_aligner: bool, ended: dict):
    """The frames the engine takes: the source through the aligner, until the
    source ends or the watchdog fires (then `ended["watchdog"]` is True)."""
    aligner = make_aligner()
    watchdog = Watchdog()
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
            ended["watchdog"] = True
            return
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
        yield frame   # the engine takes it before the loop goes on
        watchdog.initialized = engine.initialized


def _broadcast_frames(frames, mesh):
    """Rank 0's `frames`, sent to every rank of the mesh one by one (None
    ends the stream); the other ranks pass frames=None."""
    it = iter(frames) if mesh.rank == 0 else None
    while True:
        box = [next(it, None) if it is not None else None]
        dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group)
        if box[0] is None:
            return
        yield box[0]


def run_stream(
    engine: MappingEngine,
    frames: Optional[Iterable[FrameInput]],
    use_aligner: bool = True,
    verbose: bool = True,
    mesh=None,
) -> dict:
    """Feed frames through the aligner + watchdog into the engine
    (the mapping-thread loop, mapping.cpp:124-200). With a mesh, rank 0
    reads `frames` (the other ranks pass None), aligns them and broadcasts
    each aligned frame. With `verbose` rank 0 prints a line a keyframe;
    without it, nothing. Returns the frames taken and the wall seconds,
    and on rank 0 the runtime stats too (`_print_stats`): whether the
    watchdog ended the run, `keyframes`, `frames_s` and the engine's
    accumulated timers (`optimize_s`, `adding_s`, `extending_s`,
    `compiles`)."""
    main = mesh is None or mesh.rank == 0
    verbose = verbose and main
    ended = {"watchdog": False}
    source = _aligned_frames(engine, frames, use_aligner, ended) if main else None
    if mesh is not None:
        source = _broadcast_frames(source, mesh)
    t_start = time.perf_counter()
    n_frames = 0
    for frame in source:
        was_kf = engine.add_frame(frame)
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
    if not main:
        return {"frames": n_frames, "wall_s": wall}

    t = engine.timers
    return {"frames": n_frames, "wall_s": wall, "watchdog": ended["watchdog"],
            "keyframes": engine.kf_count, "frames_s": n_frames / max(wall, 1e-9),
            "optimize_s": t.optimize_steps, "adding_s": t.adding, "extending_s": t.extending,
            "compiles": t.compiles}


def _aligner_kind() -> str:
    return ("native (csrc/glic_runtime.cpp)" if isinstance(make_aligner(), NativeStreamAligner)
            else "Python (native runtime unavailable)")


def _print_stats(stats: dict) -> None:
    """The end of a stream as the reference node prints it: the watchdog's
    firing and the runtime stats of rank 0's `run_stream`."""
    if stats["watchdog"]:
        print("[watchdog] >1 s without point data — ending the run (mapping.cpp:224-234)")
    print("\n===== runtime stats (cf. mapping.cpp:188-195) =====")
    print(f"  frames processed      : {stats['frames']}")
    print(f"  train keyframes       : {stats['keyframes']}")
    print(f"  total wall time       : {stats['wall_s']:.2f} s ({stats['frames_s']:.1f} frames/s)")
    print(f"  optimize (train steps): {stats['optimize_s']:.2f} s")
    print(f"  adding (frame ingest) : {stats['adding_s']:.2f} s")
    print(f"  extending (densify)   : {stats['extending_s']:.2f} s")
    print(f"  capacity recompiles   : {stats['compiles']}")


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
                    help="shard training over N ranks (tile-row bands): N > 1 "
                         "starts N processes, rank r on cuda:r (one GPU per "
                         "rank) or, with --device cpu, on the CPU over gloo; "
                         "0 = one device, no process group")
    ap.add_argument("--demo-frames", type=int, default=25)
    ap.add_argument("--max-iters", type=int, default=None,
                    help="override max train iters per keyframe")
    ap.add_argument("--no-aligner", action="store_true",
                    help="bypass the stream aligner (frames are pre-aligned)")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler chrome trace of the stream and "
                         "its eval, with the port's glic.* spans, to DIR/trace.json, "
                         "and the spans' counts and host ms and the counters to "
                         "DIR/record.json")
    ap.add_argument("--phase-timers", action="store_true",
                    help="measure the forward/backward/optimizer split of one "
                         "train step at the end of the run (mapping.cpp:188-195)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv: Optional[list] = None,
         engine_factory: Callable[..., MappingEngine] = MappingEngine) -> int:
    """The CLI. `engine_factory(cfg, result_path=, lpips_path=, device=)`
    makes the run's engine (with `mesh=` too under --mesh-devices 1); a
    caller may pass one that keeps a reference. With --mesh-devices N > 1
    the N spawned ranks make MappingEngines; the exit code is the largest
    of theirs."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device is available; pass "
              "--device cpu to run the plain PyTorch versions on the CPU",
              file=sys.stderr)
        return 2
    n = args.mesh_devices
    if n < 0:
        print(f"error: --mesh-devices {n}: need 0 or more", file=sys.stderr)
        return 2
    if device.type == "cuda" and n > torch.cuda.device_count():
        print(f"error: --mesh-devices {n}: NCCL takes one GPU per rank and this machine "
              f"has {torch.cuda.device_count()}; run with at most that many ranks",
              file=sys.stderr)
        return 2
    if n > 1:
        from gaussian_lic_tpu_torch.parallel import spawn

        return max(spawn(_rank_main, n, device.type, args=(argv,)))
    if n == 0:
        return _run(args, device, None, engine_factory)
    from gaussian_lic_tpu_torch.parallel import make_mesh

    own_group = not dist.is_initialized()
    mesh = make_mesh(1, device=device)
    try:
        return _run(args, mesh.device, mesh, engine_factory)
    finally:
        if own_group:
            dist.destroy_process_group()


def _rank_main(mesh, argv: list) -> int:
    """One spawned rank of `--mesh-devices N`."""
    return _run(_parser().parse_args(argv), mesh.device, mesh, MappingEngine)


def _run(args, device: torch.device, mesh, engine_factory) -> int:
    main = mesh is None or mesh.rank == 0
    overrides = {}
    if args.demo:
        # the demo world is small: a fast 128x64 rig
        overrides.update(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0,
                         skybox_points_num=0, initial_capacity=1 << 12,
                         densify_budget=1 << 10, max_train_keyframes=64)
    if args.max_iters is not None:
        overrides["max_iters_per_keyframe"] = args.max_iters
    cfg = load_params(path=args.config, preset=args.preset, **overrides)

    engine = engine_factory(cfg, result_path=args.result_path, lpips_path=args.lpips_path,
                            device=device, **({} if mesh is None else {"mesh": mesh}))
    if main:
        print(f"[run] device {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
              + (f", mesh of {mesh.size} rank(s)" if mesh is not None else ""))

    if args.resume:
        gm, opt_state, _extra = load_checkpoint(args.resume, device=device)
        engine.gm = gm
        engine.opt_state = opt_state
        if main:
            print(f"resumed from {args.resume}: {int(gm.count)} gaussians")

    use_aligner = not args.no_aligner
    frames = None
    if not main:
        pass   # rank 0 reads the input and broadcasts the frames
    elif args.demo:
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
    if args.no_aligner and main:
        print("[stream] aligner: none (--no-aligner)")
    elif use_aligner and main:
        print(f"[stream] aligner: {_aligner_kind()}")

    profiler = contextlib.nullcontext()
    if args.profile and main:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    with profiler as prof:
        stats = run_stream(engine, frames, use_aligner=use_aligner, verbose=not args.quiet,
                           mesh=mesh)
        if main:
            _print_stats(stats)
        results = engine.finalize()
    if args.profile and main:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        rec = trace.record()
        with open(os.path.join(args.profile, "record.json"), "w") as f:
            json.dump(rec.summary() if rec is not None else {}, f, indent=1)
        print(f"profiler trace and span record written to {args.profile}")

    if results and main:
        print("\n===== quality (cf. gaussian.cpp:784-829) =====")
        for k in sorted(results):
            v = results[k]
            print(f"  {k:16s}: " + (f"{v:.4f}" if v is not None else "skipped"))

    if args.phase_timers and main:
        engine.measure_phase_split()

    if args.checkpoint and engine.initialized and main:
        save_checkpoint(args.checkpoint, engine.gm, engine.opt_state,
                        extra={"kf_count": engine.kf_count})
        print(f"checkpoint written to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
