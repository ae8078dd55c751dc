"""Traffic kind `stream`: the keyframe stream as users run it, a recorded
bag replayed through the program's entry point `run.run_stream` (aligner,
watchdog, `MappingEngine.add_frame`: ingest; on a keyframe the extend and
a `max_iters_per_keyframe`-step optimize()).

Set-up builds, from the seed, the configuration's map (harness/state.py:
`map_live` Gaussians in `map_rows` rows, which a stream's configuration
gives with room for a call's extends), `keyframes` keyframes of random
images, and `frames` frames that continue the keyframes' trajectory
(harness/frames.py), each `points_per_frame` LiDAR points in its own
frustum; a keyframe every
`select_every_k_frame` frames. The engine holds the map with zero Adam
moments and a keyframe buffer of `max_train_keyframes` rows, as a
deployment's engine does, so no frame of the window grows it.

The check runs first, on an engine of its own built the same way whose
`max_iters_per_keyframe` is 1: one keyframe cycle (the first
`select_every_k_frame` frames) through `run_stream`, so one extend and
one step through the 1-step graph, run twice with the window's restore
between. The first run captures the graph; the second is the window's
path: the restore writes into the graph's static set, the extend's new
tensors are copied into it, and the graph replays at the grown count. The
second run's appended rows, step's loss, gradient (the Adam moments over
1 - beta1) and every leaf's change from the start state (the appended
rows' values included) are compared with the plain extend
(reference/extend.py) and the plain train step (reference/splat.py) from
the same start state, frames and drawn keyframe.

The timed engine then runs whole window calls until one captures no graph
and grows nothing; the first of them feeds the frames one keyframe cycle
at a time, to read the rows each extend appends. A window call restores
the start state (the map's rows and count by device copy, zero moments,
the keyframe count, the held-out views and keyframe names cut back, an
empty point accumulator, the frame counter, the state of the RNG that
draws optimize()'s keyframes) and calls
`run_stream(engine, frames, use_aligner=True, verbose=False)`: every call
does the same work, in a closed loop, as fast as the mapper returns.
`train_it_s` is the optimize steps completed over the window's seconds.
A traced run profiles `trace_calls` calls.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from harness import frames as stream_frames
from harness import program, state, trace
from reference import extend as plain_extend
from reference import splat


def _sizes(run):
    """(map rows, live Gaussians, keyframes a call, steps a keyframe)."""
    p, a, t = run.config["params"], run.config["assumed"], run.traffic
    every = p["select_every_k_frame"]
    if t["frames"] % every or t["keyframes"] <= p["max_iters_per_keyframe"]:
        raise ValueError("a call's frames must be whole keyframe cycles, and the keyframes "
                         "more than max_iters_per_keyframe (else optimize() runs fewer steps)")
    return a["map_rows"], a["map_live"], t["frames"] // every, p["max_iters_per_keyframe"]


def inputs(run):
    """The seeded map in its rows, the keyframes, the frames."""
    p, a, t = run.config["params"], run.config["assumed"], run.traffic
    rows, live, _, _ = _sizes(run)
    gen = state.generator(run.seed, run.device)
    run.params0 = state.map_params(gen, p, rows, live, run.device)
    run.poses = state.poses(np.arange(t["keyframes"], dtype=np.float64))
    run.imgs = state.images(gen, t["keyframes"], p, run.device)
    run.frames = stream_frames.frames(gen, p, float(t["keyframes"]), t["frames"],
                                      t["points_per_frame"], run.device)


def _engine(run):
    eng = program.engine(run, run.params0, run.imgs, *run.poses)
    n_kf, kf_per_call = run.traffic["keyframes"], _sizes(run)[2]
    eng.kf_buffer = eng.kf_buffer.grow(max(run.config["params"]["max_train_keyframes"],
                                           n_kf + kf_per_call))
    eng._kf_names = [f"train_{i:04d}" for i in range(n_kf)]
    run.rng0 = eng.rng.bit_generator.state
    return eng


def _frame_inputs(run, frames):
    from gaussian_lic_tpu_torch.engine.dataset import FrameInput

    return [FrameInput(timestamp=f["stamp"], R_wc=f["R_wc"], t_wc=f["t_wc"], image=f["image"],
                       points=f["points"], colors=f["colors"]) for f in frames]


def _stream(eng, frames):
    from gaussian_lic_tpu_torch.run import run_stream

    return run_stream(eng, frames, use_aligner=True, verbose=False)


def _restore(run, eng):
    """The start state, copied into the engine's tensors; the host state cut
    back to its set-up length."""
    tr = eng.gm.trainable()
    for g, t in run.params0.items():
        tr[g].copy_(t)
    eng.gm.count.fill_(run.config["assumed"]["map_live"])
    for st in eng.opt_state.values():
        st.exp_avg.zero_()
        st.exp_avg_sq.zero_()
    n_kf = run.traffic["keyframes"]
    eng.kf_count = n_kf
    del eng._kf_names[n_kf:]
    del eng.test_cameras[:]
    eng.accum.take()
    eng.all_frame_num = 0
    eng.rng.bit_generator.state = run.rng0


def _shape(eng) -> tuple:
    """What a call must not change: graphs captured, map rows, keyframe
    buffer rows, splat budget."""
    return (len(eng.graphs.captures), eng.gm.capacity, eng.kf_buffer.images.shape[0],
            eng.cfg.splat_budget_factor)


def _checked_cycle(run) -> dict:
    """One keyframe cycle through run_stream on its own engine, one step a
    keyframe, run twice with the window's restore between: what the
    reference checks is the second run, which replays the graph the first
    captured."""
    live = run.config["assumed"]["map_live"]
    every = run.config["params"]["select_every_k_frame"]
    eng = _engine(run)
    eng.cfg = eng.cfg.replace(max_iters_per_keyframe=1)
    cycle = _frame_inputs(run, run.frames[:every])
    _stream(eng, cycle)
    captures = len(eng.graphs.captures)
    _restore(run, eng)
    _stream(eng, cycle)
    out = dict(recaptures=len(eng.graphs.captures) - captures,
               added=int(eng.gm.count) - live, loss=eng.last_metrics["loss"],
               grad_norms=splat.leaf_norms({g: st.exp_avg / (1.0 - splat.BETA1)
                                            for g, st in eng.opt_state.items()}),
               change_norms=splat.leaf_norms({g: eng.gm.trainable()[g] - run.params0[g]
                                              for g in run.params0}))
    del eng
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def setup(run):
    t = run.traffic
    rows, live, kf_per_call, _ = _sizes(run)
    every = run.config["params"]["select_every_k_frame"]
    inputs(run)
    run.checked = _checked_cycle(run)
    run.frame_inputs = _frame_inputs(run, run.frames)
    eng = run.eng = _engine(run)

    per_kf, calls = [], 0
    for calls in range(1, t["max_settle_calls"] + 1):
        before = _shape(eng)
        _restore(run, eng)
        if calls == 1:
            # one cycle at a time, to read each extend's appended rows
            seen = [live]
            for c in range(kf_per_call):
                _stream(eng, run.frame_inputs[c * every:(c + 1) * every])
                seen.append(int(eng.gm.count))
            per_kf = np.diff(seen).tolist()
        else:
            _stream(eng, run.frame_inputs)
        if calls > 1 and _shape(eng) == before:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.layer["capture_s"] = sum(c[1] for c in eng.graphs.captures)
    run.info.update(map_rows=rows, map_live=live, setup_captures=len(eng.graphs.captures),
                    settle_calls=calls, appended_per_keyframe=per_kf,
                    splat_budget_factor=eng.cfg.splat_budget_factor,
                    kf_buffer_rows=eng.kf_buffer.images.shape[0],
                    checked_added=run.checked["added"], checked_loss=run.checked["loss"],
                    checked_recaptures=run.checked["recaptures"])


def window(run):
    eng, t = run.eng, run.traffic
    _, live, kf_per_call, steps_per_kf = _sizes(run)
    before = _shape(eng)
    calls = bad = 0
    appended = []
    with trace.profiled(run.trace) as prof:
        t0 = time.perf_counter()
        while True:
            with trace.span("restore"):
                _restore(run, eng)
            with trace.span("stream"):
                _stream(eng, run.frame_inputs)
            calls += 1
            appended.append(int(eng.gm.count) - live)
            bad += not math.isfinite(eng.last_metrics["loss"])
            if run.trace and calls >= t["trace_calls"]:
                break
            if not run.trace and time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
    after = _shape(eng)
    steps = calls * kf_per_call * steps_per_kf
    run.attempted, run.failed = steps, bad * kf_per_call * steps_per_kf
    run.e2e["train_it_s"] = steps / elapsed
    run.info.update(window_calls=calls, window_s=elapsed, window_captures=after[0] - before[0],
                    window_growths=sum(a != b for a, b in zip(after[1:], before[1:])),
                    window_appended=sorted(set(appended)))
    run.layer.update(frames=calls * t["frames"], keyframes=calls * kf_per_call, steps=steps,
                     window_s=elapsed)
    if prof is not None:
        run.layer["trace"] = trace.read(prof, elapsed)


def release(run):
    run.eng = None


def reference(run, tf32=False, **faults) -> dict:
    """The checked cycle in the plain reference: the extend from the first
    keyframe cycle's points into its keyframe's camera, then one train step
    on the keyframe the engine's RNG draws (numpy's default_rng(seed): a
    choice of 1 of the keyframes, then a shuffle). `tf32` computes the
    control (splat.check_train's); `faults` go to the extend."""
    p, t, dev = run.config["params"], run.traffic, run.device
    rows, live, _, _ = _sizes(run)
    every = p["select_every_k_frame"]
    budget = splat.splat_budget(rows, float(p["splat_budget_factor"]), p["max_tiles_per_gaussian"])
    cycle = run.frames[:every]
    kf = cycle[-1]
    cam_kf = splat.camera(p, torch.as_tensor(kf["R_wc"], device=dev),
                          torch.as_tensor(kf["t_wc"], device=dev))
    n_kf = t["keyframes"] + 1
    rng = np.random.default_rng(run.seed)
    drawn = rng.choice(n_kf, size=1, replace=False)
    rng.shuffle(drawn)
    i = int(drawn[0])
    if i < t["keyframes"]:
        R_wc, t_wc = run.poses
        cam = splat.camera(p, torch.as_tensor(R_wc[i], device=dev),
                           torch.as_tensor(t_wc[i], device=dev))
        gt = run.imgs[i].float() / 255.0
    else:
        cam = cam_kf
        gt = torch.as_tensor(kf["image"], device=dev).permute(2, 0, 1).float() / 255.0
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        params, count, added = plain_extend.extend(run.params0, live, cam_kf,
                                                   *plain_extend.gathered(cycle), p, budget,
                                                   **faults)
        moments = {g: (torch.zeros_like(x), torch.zeros_like(x)) for g, x in params.items()}
        loss, grads, new_p, _, _ = splat.train_step(params, moments, count, cam, gt, p, budget,
                                                    lower=tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return dict(added=added, loss=loss, grad_norms=splat.leaf_norms(grads),
                change_norms=splat.leaf_norms({g: new_p[g] - run.params0[g] for g in new_p}))


def gaps(prog: dict, ref: dict) -> dict:
    """The program's (or a control's) checked cycle against the reference's;
    the change over the leaves the train cells compare (splat.moved_leaves)."""
    return dict(
        added_gap=abs(prog["added"] - ref["added"]) / max(ref["added"], 1),
        loss_gap=abs(prog["loss"] - ref["loss"]) / abs(ref["loss"]),
        grad_gap=splat.gap_of_norms(prog["grad_norms"], ref["grad_norms"]),
        change_gap=splat.gap_of_norms(prog["change_norms"], ref["change_norms"],
                                      keep=splat.moved_leaves(ref["grad_norms"])))


def check(run):
    lim = run.traffic["limits"]
    return [(n, v, lim[n]) for n, v in gaps(run.checked, reference(run)).items()]
