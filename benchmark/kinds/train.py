"""Traffic kind `train`: the keyframe optimisation as users run it.

Set-up builds one `MappingEngine` on a map made from the seed (the
configuration's `assumed` map_rows and map_live, harness/state.py) and
`keyframes` keyframes of random images, then drives that engine through
its first steps with the window's own call and keyframe feed:
`optimize(max_iters=1)`, one step, then `optimize(max_iters=k)` with k the
smallest bundle of `opt_bundle_sizes` above 1, so that the checked steps
run through a multi-step graph that the window replays (on the card the
k-step CUDA graph; its step i reads keyframe id i and carries the state to
step i + 1, as every graph of the window does). Each call's last loss (the
one the engine reports), the first gradient (from the Adam moments after
step 1) and the parameters' change after the last step are what the
reference checks. Set-up then restores the map and runs `optimize()` until
a call captures nothing and grows no splat budget.

Each repetition of the window restores the seeded map and zero moments (a
device copy) and calls `optimize()`: `max_iters_per_keyframe` steps on
keyframes the engine's RNG draws, in the bundles of `opt_bundle_sizes`
(CUDA graphs on the card), ending in the engine's one host fetch. So every
repetition does the same work however fast the program is. The window runs
whole repetitions until `--seconds` have passed; `train_it_s` is the steps
over the window's seconds. A traced run profiles `trace_reps` repetitions.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from harness import bounds, program, state, trace
from reference import splat


def checked_calls(run) -> list:
    """The steps of each checked optimize() call: 1, then the smallest
    bundle size above 1 (none when every bundle is one step)."""
    above = [k for k in run.config["params"]["opt_bundle_sizes"] if k > 1]
    return [1] + ([min(above)] if above else [])


def _restore(eng, params0):
    """The seeded map and zero moments, copied into the engine's tensors."""
    tr = eng.gm.trainable()
    for g, t in params0.items():
        tr[g].copy_(t)
    for st in eng.opt_state.values():
        st.exp_avg.zero_()
        st.exp_avg_sq.zero_()


def inputs(run):
    """The seeded map, the keyframes' poses and images."""
    p, a, t = run.config["params"], run.config["assumed"], run.traffic
    gen = state.generator(run.seed, run.device)
    run.params0 = state.map_params(gen, p, a["map_rows"], a["map_live"], run.device)
    run.poses = state.poses(np.arange(t["keyframes"], dtype=np.float64))
    run.imgs = state.images(gen, t["keyframes"], p, run.device)


def setup(run):
    t, dev = run.traffic, run.device
    inputs(run)
    eng = run.eng = program.engine(run, run.params0, run.imgs, *run.poses)

    losses = []
    for i, k in enumerate(checked_calls(run)):
        eng.optimize(max_iters=k)
        losses.append(eng.last_metrics["loss"])
        if i == 0:
            grads = splat.leaf_norms({g: st.exp_avg / (1.0 - splat.BETA1)
                                      for g, st in eng.opt_state.items()})
    change = splat.leaf_norms({g: eng.gm.trainable()[g] - run.params0[g] for g in run.params0})
    run.checked = dict(losses=losses, grad_norms=grads, change_norms=change)

    growths, settle = 0, []
    for i in range(t["max_settle_calls"]):
        _restore(eng, run.params0)
        n_cap, factor = len(eng.graphs.captures), eng.cfg.splat_budget_factor
        eng.optimize()
        grew = eng.cfg.splat_budget_factor != factor
        growths += grew
        settle.append(eng.last_metrics["loss"])
        if i >= 1 and not grew and len(eng.graphs.captures) == n_cap:
            break
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    run.layer["capture_s"] = sum(c[1] for c in eng.graphs.captures)
    run.info.update(setup_captures=len(eng.graphs.captures), setup_budget_growths=growths,
                    settle_calls=len(settle), splat_budget_factor=eng.cfg.splat_budget_factor,
                    checked_losses=losses)


def window(run):
    eng, t = run.eng, run.traffic
    steps_per_call = run.config["params"]["max_iters_per_keyframe"]
    n_cap, factor = len(eng.graphs.captures), eng.cfg.splat_budget_factor
    reps = bad = 0
    with trace.profiled(run.trace) as prof:
        t0 = time.perf_counter()
        while True:
            with trace.span("restore"):
                _restore(eng, run.params0)
            with trace.span("optimize"):
                eng.optimize()
            reps += 1
            bad += not math.isfinite(eng.last_metrics["loss"])
            if run.trace and reps >= t["trace_reps"]:
                break
            if not run.trace and time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
    steps = reps * steps_per_call
    run.attempted, run.failed = steps, bad * steps_per_call
    run.e2e["train_it_s"] = steps / elapsed
    run.info.update(window_calls=reps, window_s=elapsed,
                    window_captures=len(eng.graphs.captures) - n_cap,
                    window_budget_growths=int(eng.cfg.splat_budget_factor != factor))
    run.layer.update(steps=steps, window_s=elapsed)
    if prof is not None:
        run.layer["trace"] = trace.read(prof, elapsed)


def release(run):
    run.eng = None


def _reference_inputs(run):
    """The keyframes of the checked steps, as the engine's RNG draws them
    (numpy's default_rng(seed), each call of k steps: a choice of k of the
    keyframes, or all of them when there are no more than k, then a
    shuffle), with the reference's own cameras."""
    p = run.config["params"]
    rng = np.random.default_rng(run.seed)
    n_kf = run.traffic["keyframes"]
    R_wc, t_wc = run.poses
    cams, gts = [], []
    for k in checked_calls(run):
        idx = rng.choice(n_kf, size=k, replace=False) if n_kf > k else np.arange(n_kf)
        rng.shuffle(idx)
        for i in idx.tolist():
            cams.append(splat.camera(p, torch.as_tensor(R_wc[i], device=run.device),
                                     torch.as_tensor(t_wc[i], device=run.device)))
            gts.append(run.imgs[i].float() / 255.0)
    return cams, gts


def reference(run, tf32=False, counts=None, loss_fn=None):
    p, a = run.config["params"], run.config["assumed"]
    cams, gts = _reference_inputs(run)
    return splat.check_train(run.params0, a["map_live"], cams, gts, p, a["map_rows"],
                             float(p["splat_budget_factor"]),
                             [min(k, run.traffic["keyframes"]) for k in checked_calls(run)], tf32=tf32,
                             counts=counts, loss_fn=loss_fn)


def gaps(prog: dict, ref: dict) -> dict:
    return dict(
        loss_gap=max(abs(x - y) / abs(y) for x, y in zip(prog["losses"], ref["losses"])),
        grad_gap=splat.gap_of_norms(prog["grad_norms"], ref["grad_norms"]),
        change_gap=splat.gap_of_norms(prog["change_norms"], ref["change_norms"],
                                      keep=splat.moved_leaves(ref["grad_norms"])))


def check(run):
    counts = dict(applied=0, stopped=0, entries=0, visible=0)
    ref = reference(run, counts=counts)
    p, a = run.config["params"], run.config["assumed"]
    counts.update(live=a["map_live"], tiles=(-(-p["width"] // p["tile_w"]))
                  * (-(-p["height"] // p["tile_h"])), pixels=p["width"] * p["height"])
    run.layer["counts"] = counts
    run.layer["bounds_s"] = bounds.step(counts)
    lim = run.traffic["limits"]
    return [(n, v, lim[n]) for n, v in gaps(run.checked, ref).items()]
