"""Traffic kind `render`: the eval path of `finalize`,
`evaluate_visual_quality` (gaussian_lic_tpu_torch/engine/evaluate.py), on a
map made from the seed, over `keyframe_views` keyframe views and
`held_out_views` held-out views along the trajectory, with no images saved
and no LPIPS.

Set-up builds a `MappingEngine` that holds the seeded map, the keyframes
(poses and images in its keyframe buffer, their names) and the held-out
views (`test_cameras`: host poses and host images), and calls
`evaluate_visual_quality(engine, save_images=False)` once, which warms
every view's shapes. The window repeats that call, as `finalize` makes it,
until `--seconds` have passed; `render_views_s` is the views of the
calls over the window's seconds. A traced run profiles `trace_calls` calls.

The check: `check_views` views drawn from the seed, each evaluated by the
same call on the same engine holding that one view (a view's work does not
depend on the others: each starts from the same splat budget), once the
window has closed; the plain reference renders them again and the widest
PSNR and SSIM gaps are compared.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from harness import program, state, trace
from reference import splat


def _splits(run):
    t = run.traffic
    n_kf, n_ho = t["keyframe_views"], t["held_out_views"]
    s_kf = np.arange(n_kf, dtype=np.float64)
    s_ho = (np.arange(n_ho, dtype=np.float64) + 0.5) * (n_kf / max(n_ho, 1))
    return s_kf, s_ho


def inputs(run):
    """The seeded map, both splits' poses and targets."""
    p, a = run.config["params"], run.config["assumed"]
    gen = state.generator(run.seed, run.device)
    run.params0 = state.map_params(gen, p, a["map_rows"], a["map_live"], run.device)
    s_kf, s_ho = _splits(run)
    run.poses = (state.poses(s_kf), state.poses(s_ho))
    run.gts = (state.images(gen, len(s_kf), p, run.device),
               state.images(gen, len(s_ho), p, run.device))


def setup(run):
    from gaussian_lic_tpu_torch.engine.dataset import TestCamera
    from gaussian_lic_tpu_torch.engine.evaluate import evaluate_visual_quality

    inputs(run)
    (R_kf, t_kf), (R_ho, t_ho) = run.poses
    kf_imgs, ho_imgs = run.gts
    ho_host = ho_imgs.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    eng = run.eng = program.engine(run, run.params0, kf_imgs, R_kf, t_kf, optimizer=False)
    eng._kf_names = [f"train_{i:04d}" for i in range(len(R_kf))]
    eng.test_cameras = [TestCamera(name=f"test_{i:04d}", R_wc=R_ho[i], t_wc=t_ho[i],
                                   image_u8=ho_host[i]) for i in range(len(R_ho))]
    evaluate_visual_quality(eng, save_images=False)


def _split_views(eng) -> dict:
    return {"train": len(eng._kf_names), "test": len(eng.test_cameras)}


def window(run):
    from gaussian_lic_tpu_torch.engine.evaluate import evaluate_visual_quality

    t, eng = run.traffic, run.eng
    n = _split_views(eng)
    views = bad = calls = 0
    with trace.profiled(run.trace) as prof:
        t0 = time.perf_counter()
        while True:
            with trace.span("evaluate"):
                res = evaluate_visual_quality(eng, save_images=False)
            calls += 1
            views += sum(n.values())
            bad += sum(m for s, m in n.items()
                       if not all(math.isfinite(res[f"{s}_{k}"]) for k in ("psnr", "ssim")))
            if run.trace and calls >= t["trace_calls"]:
                break
            if not run.trace and time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
    run.attempted, run.failed = views, bad
    run.e2e["render_views_s"] = views / elapsed
    run.info.update(window_calls=calls, window_s=elapsed)
    run.layer.update(views=views, window_s=elapsed)
    if prof is not None:
        run.layer["trace"] = trace.read(prof, elapsed)
    run.answers = [answer(eng, split, i) for split, i in sample(run)]


def answer(eng, split: int, i: int):
    """(PSNR, SSIM) of one view by `evaluate_visual_quality` on the engine
    holding only that view: keyframe `i` (split 0) or held-out view `i`."""
    from gaussian_lic_tpu_torch.engine.dataset import KeyframeBuffer
    from gaussian_lic_tpu_torch.engine.evaluate import evaluate_visual_quality

    one = copy.copy(eng)
    kb = eng.kf_buffer
    if split == 0:
        one.kf_buffer = KeyframeBuffer(R_cw=kb.R_cw[i:i + 1], t_cw=kb.t_cw[i:i + 1],
                                       full_proj=kb.full_proj[i:i + 1],
                                       images=kb.images[i:i + 1])
        one._kf_names, one.test_cameras, key = [eng._kf_names[i]], [], "train"
    else:
        one._kf_names, one.test_cameras, key = [], [eng.test_cameras[i]], "test"
    res = evaluate_visual_quality(one, save_images=False)
    return res[f"{key}_psnr"], res[f"{key}_ssim"]


def release(run):
    run.eng = None


def sample(run):
    """The checked views: (split, index) drawn from the seed, and always the
    last view of each split."""
    rng = np.random.default_rng([run.seed, 1])
    s_kf, s_ho = _splits(run)
    n = run.traffic["check_views"]
    picks = {(0, len(s_kf) - 1), (1, len(s_ho) - 1)}
    while len(picks) < n:
        split = int(rng.integers(0, 2))
        picks.add((split, int(rng.integers(0, (len(s_kf), len(s_ho))[split]))))
    return sorted(picks)


def reference(run, views, tf32=False):
    p, a = run.config["params"], run.config["assumed"]
    out = []
    for split, i in views:
        R, tv = run.poses[split]
        cam = splat.camera(p, torch.as_tensor(R[i], device=run.device),
                           torch.as_tensor(tv[i], device=run.device))
        gt = run.gts[split][i].float() / 255.0
        out.append(splat.eval_view(run.params0, a["map_live"], cam, gt, p,
                                   a["map_rows"] * p["max_tiles_per_gaussian"], tf32=tf32))
    return out


def gaps(answers, ref) -> dict:
    """The widest PSNR (dB) and SSIM gaps over the checked views (NaN if
    any answer is)."""
    d = np.abs(np.asarray(answers, np.float64) - np.asarray(ref, np.float64))
    return dict(psnr_gap_db=float(np.max(d[:, 0])), ssim_gap=float(np.max(d[:, 1])))


def check(run):
    ref = reference(run, sample(run))
    lim = run.traffic["limits"]
    return [(n, v, lim[n]) for n, v in gaps(run.answers, ref).items()]
