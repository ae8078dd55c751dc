#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gaussian_lic_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers and seconds; any failure raises, so the
exit code is not 0:

  1. device and build: the card's name and power limit, TF32 switched off,
     the CUDA kernels built with nvcc from csrc/ (seconds, ptxas report);
  2. kernel vs plain: K1 blend_forward (color and no_color) and K2
     blend_backward at 640x512, each held against its plain PyTorch version
     with both times (CUDA events), on two inputs: a seeded ~20k-Gaussian
     scene (short tile lists) and the arguments of phase 4's first train step
     at 1M Gaussians (tile lists of thousands of entries, so K1 walks many
     staged batches and its early exit);
  2b. the blend probes K3/K4 (ops/blend_probe.py): every variant on phase
     2's two inputs, held against K1/K2's outputs of phase 2 where it keeps
     their numerics, and against its own plain version (every variant on the
     20k scene, the others at 1M); then the probes' own path, the run()
     of tools/probe_torch_kernel.py and tools/probe_torch_bwd.py on the probe
     scene (1M Gaussians, camera 0), with the probe launch counters zeroed
     just before and read just after: every variant must show;
  3. the slice: MappingEngine.add_frame over a 40-frame synthetic stream at
     the fastlivo rig (640x512, SH 3, 16 tile slots, capacity 262144); the
     launch counters are zeroed just before the stream and read just after,
     and must show every kernel; the train PSNR must clear a floor; the same
     small stream through the engine on the card and on the CPU (plain path)
     must agree;
  4. full-size train steps: the 1M-Gaussian state of phase 2, 3 warm-up + 20
     timed steps (ms/step, it/s, peak memory, overflow counters).

It never falls back to the CPU for the card's work: without a CUDA device it
exits with an error before printing any result. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The phase functions take their sizes as arguments (defaults: the sizes
above), so their control flow can be rehearsed on a CPU at a tiny size.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "config", "fastlivo.yaml")

PSNR_FLOOR = 17.0          # phase 3 train PSNR floor: first H100 run 18.86 dB
IMG_ATOL = 1e-5            # K1 image and final_T vs plain
GRAD_RTOL = 1e-4           # K2 per-entry grads vs plain, relative to the max
SMALL_LOSS_RTOL = 1e-4     # phase 3 small stream: card vs CPU per-keyframe loss
NOBLEND_RTOL = 1e-5        # K3 noblend vs plain, relative to the max: sums of ~1e4 powers
NORED_RTOL = 1e-4          # K4 nored vs plain, relative to the max: 4-pixel sums
# K4 variants vs K2 (fused: vs K2 + index_add_), relative to the max; base and
# dbuf2 keep K2's arithmetic and order, smematomic and fused sum in any order
BWD_RTOL_VS_K2 = {"base": 1e-6, "dbuf2": 1e-6, "smematomic": GRAD_RTOL, "fused": GRAD_RTOL}
FWD_K1_NUMERICS = ("base", "batch512", "direct")   # K3 variants held to K1 bit for bit


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    """(fn(), the ms of that one call between two CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------

def kernel_scene(dev, n: int = 20000, seed: int = 1) -> dict:
    """Seeded 640x512 scene of `n` Gaussians, with a random seeded dL/dpix."""
    import torch

    from gaussian_lic_tpu_torch.camera import Intrinsics, look_at, make_camera
    from gaussian_lic_tpu_torch.config import load_params
    from gaussian_lic_tpu_torch.utils.synthetic import splat_args

    cfg = load_params(CONFIG, skybox_points_num=0)
    intr = Intrinsics(cfg.width, cfg.height, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 12.0, n)
    xyz = np.stack([rng.uniform(-0.7, 0.7, n) * z, rng.uniform(-0.55, 0.55, n) * z, z], 1)
    f32 = dict(dtype=torch.float32, device=dev)
    xyz = torch.as_tensor(xyz, **f32)
    scale = torch.as_tensor(np.abs(rng.normal(size=(n, 3))) * 0.03 + 0.01, **f32) * xyz[:, 2:3] / 4
    quat = torch.as_tensor(rng.normal(size=(n, 4)), **f32)
    opacity = torch.as_tensor(rng.uniform(0.05, 0.99, n), **f32)
    dc = torch.as_tensor(rng.normal(size=(n, 3)) * 0.5, **f32)
    sh_rest = torch.as_tensor(rng.normal(size=(n, 15, 3)) * 0.05, **f32)
    R_wc, t_wc = look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]), up=(0.0, -1.0, 0.0))
    cam = make_camera(intr, R_wc, t_wc, device=dev)
    sc = splat_args(xyz, scale, quat, opacity, cam, dc=dc, sh_rest=sh_rest, sh_degree=3,
                    tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                    max_tiles_per_gaussian=cfg.max_tiles_per_gaussian, max_total_splats=4 * n)
    g = sc["grid"]
    sc["dl"] = torch.as_tensor(rng.normal(size=(3, g.padded_height, g.padded_width)) * 1e-3,
                               **f32)
    return sc


def step_scene(state: dict, idx: int = 1) -> dict:
    """The arguments K1 and K2 get in the train step of `state` on keyframe
    `idx` (phase 4's first step): the step's splat list, and dL/dpix of the
    training loss at the image of the plain forward."""
    import torch

    from gaussian_lic_tpu_torch.engine.trainer import _render_kw
    from gaussian_lic_tpu_torch.ops import blend, losses
    from gaussian_lic_tpu_torch.utils.synthetic import splat_args

    cfg, intr, gm, kf = state["cfg"], state["intr"], state["gm"], state["kf"]
    sc = splat_args(gm.xyz, gm.scaling, gm.rotation, gm.opacity, kf.camera(intr, idx),
                    dc=gm.dc, sh_rest=gm.sh_rest, sh_degree=gm.sh_degree,
                    active=gm.active_mask(), **_render_kw(cfg, gm.capacity))
    g = sc["grid"]
    color = blend.blend_forward_plain(sc["splats"], sc["starts"], sc["lens"], n_tx=g.n_tx,
                                      n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)[0]
    color = color.requires_grad_(True)
    gt = kf.images[idx].float() / 255.0
    loss = losses.training_loss(color[:, :intr.height, :intr.width], gt, cfg.lambda_dssim)
    sc["dl"] = torch.autograd.grad(loss, color)[0].contiguous()
    return sc


def tie_pixels(plain, sc, kw):
    """Pixels where some T*(1-alpha) lies within 1 ulp of 1e-4: the plain
    forward `plain` decides them differently with the threshold moved 1 ulp
    down or up."""
    eps32 = np.float32(1e-4)
    lo = float(np.nextafter(eps32, np.float32(0)))
    hi = float(np.nextafter(eps32, np.float32(1)))
    _, ft_lo, nc_lo = plain(sc["splats"], sc["starts"], sc["lens"], t_eps=lo, **kw)
    _, ft_hi, nc_hi = plain(sc["splats"], sc["starts"], sc["lens"], t_eps=hi, **kw)
    return (nc_lo != nc_hi) | (ft_lo != ft_hi)


def compare_kernels(sc: dict, tag: str) -> dict:
    """K1 (color, no_color) and K2 against their plain versions on one
    scene; raises beyond the tolerances. Returns each kernel's max abs error
    and its and its plain version's time (ms), and keeps K1's and K2's
    outputs, the tie pixels and the times in `sc` for phase 2b."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    args = (sc["splats"], sc["starts"], sc["lens"])
    lens = sc["lens"].cpu().numpy()
    log(f"[2] {tag}: {sc['splats'].shape[0]} list entries, {sc['live']} live, "
        f"tile lens mean {lens.mean():.1f} max {lens.max()}, overflow {sc['lost']}")

    out_k = blend.blend_forward(*args, **kw)
    out_p = blend.blend_forward_plain(*args, **kw)
    torch.cuda.synchronize()
    ties = tie_pixels(blend.blend_forward_plain, sc, kw)
    nc_bad = out_k[2] != out_p[2]
    if bool((nc_bad & ~ties).any()):
        raise AssertionError(f"{tag}: K1 n_contrib differs at {int((nc_bad & ~ties).sum())} "
                             "pixels that are not termination ties")
    ok_px = ~(nc_bad | ties)
    err_img = float((out_k[0] - out_p[0]).abs().amax(0)[ok_px].max())
    err_ft = float((out_k[1] - out_p[1]).abs()[ok_px].max())
    log(f"[2] {tag} K1 color: max|d image| {err_img:.3e}  max|d final_T| {err_ft:.3e}  "
        f"n_contrib mismatches {int(nc_bad.sum())} (tie pixels {int(ties.sum())}, "
        f"excluded from the image check)")
    if not (err_img <= IMG_ATOL and err_ft <= IMG_ATOL):
        raise AssertionError(f"{tag}: K1 disagrees with its plain version beyond {IMG_ATOL}")

    nk = blend.blend_forward(*args, no_color=True, **kw)
    np_ = blend.blend_forward_plain(*args, no_color=True, **kw)
    err_nc = float((nk[1] - np_[1]).abs()[~ties].max())
    if float(nk[0].abs().max()) != 0.0 or int(nk[2].abs().max()) != 0:
        raise AssertionError(f"{tag}: K1 no_color wrote color or n_contrib")
    log(f"[2] {tag} K1 no_color: max|d final_T| {err_nc:.3e}")
    if not err_nc <= IMG_ATOL:
        raise AssertionError(f"{tag}: K1 no_color disagrees with its plain version beyond "
                             f"{IMG_ATOL}")

    bargs = args + (sc["dl"], out_p[1], out_p[2])
    gk = blend.blend_backward(*bargs, **kw)
    gp = blend.blend_backward_plain(*bargs, **kw)
    torch.cuda.synchronize()
    err_g = float((gk - gp).abs().max())
    rel_g = err_g / max(float(gp.abs().max()), 1e-30)
    log(f"[2] {tag} K2: max|d grad| {err_g:.3e}  relative to max {rel_g:.3e}")
    if not rel_g <= GRAD_RTOL:
        raise AssertionError(f"{tag}: K2 disagrees with its plain version beyond {GRAD_RTOL} "
                             "relative")

    res = {
        "forward": (max(err_img, err_ft),
                    cuda_ms(lambda: blend.blend_forward(*args, **kw), 20),
                    cuda_ms(lambda: blend.blend_forward_plain(*args, **kw), 3)),
        "forward_no_color": (err_nc,
                             cuda_ms(lambda: blend.blend_forward(*args, no_color=True, **kw), 20),
                             cuda_ms(lambda: blend.blend_forward_plain(*args, no_color=True,
                                                                       **kw), 3)),
        "backward": (err_g,
                     cuda_ms(lambda: blend.blend_backward(*bargs, **kw), 20),
                     cuda_ms(lambda: blend.blend_backward_plain(*bargs, **kw), 3)),
    }
    for k, (_, tk, tp) in res.items():
        log(f"[2] {tag} time {k}: kernel {tk:.4f} ms  plain {tp:.4f} ms")
    sc.update(k1=out_k, ties=ties, k2=gk, k2_in=bargs[3:], times=res)
    return res


def phase_kernels(dev, state: dict, n: int = 20000):
    """Compares the kernels on the seeded n-Gaussian scene and on the
    arguments of phase 4's first train step. The JSON line reports the
    larger error of the two and the times at the train step's shapes.
    Returns those rows and the two scenes."""
    light_sc, step_sc = kernel_scene(dev, n), step_scene(state)
    light = compare_kernels(light_sc, f"{n}-Gaussian scene")
    step = compare_kernels(step_sc, f"{state['n']}-Gaussian train step")
    src = "gaussian_lic_tpu_torch/csrc/"
    pallas = "gaussian_lic_tpu/ops/blend_pallas.py:"
    rows = [("blend_forward", "blend_forward.cu", "278", "forward"),
            ("blend_forward_no_color", "blend_forward.cu", "278", "forward_no_color"),
            ("blend_backward", "blend_backward.cu", "578", "backward")]
    return [dict(name=name, route="cuda", source=src + cu, replaces=pallas + line,
                 counter=key, max_abs_err=max(light[key][0], step[key][0]),
                 ms=step[key][1], plain_ms=step[key][2])
            for name, cu, line, key in rows], (light_sc, step_sc)


# ---------------------------------------------------------------------------
# phase 2b: the blend probes K3/K4
# ---------------------------------------------------------------------------

def check_probe_forward(tag, v, against, out, ref, tol, ties) -> float:
    """Max abs error of K3 variant `v`'s outputs against `ref` (named
    `against`), outside the pixels that `ties()` names (asked for only when
    some pixel disagrees); raises beyond `tol` or on an n_contrib mismatch
    outside them."""
    import torch

    if v == "noblend":
        err = float((out[0] - ref[0]).abs().max())
        rel = err / max(float(ref[0].abs().max()), 1e-30)
        log(f"[2b] {tag} K3 {v} vs {against}: max|d image| {err:.3e}  relative to max "
            f"{rel:.3e}")
        if not (rel <= NOBLEND_RTOL and bool((out[1] == 1.0).all())
                and int(out[2].abs().max()) == 0):
            raise AssertionError(f"{tag}: K3 {v} disagrees with {against} beyond "
                                 f"{NOBLEND_RTOL} relative")
        return err
    px_err = torch.maximum((out[0] - ref[0]).abs().amax(0), (out[1] - ref[1]).abs())
    nc_bad = out[2] != ref[2]
    bad = nc_bad | (px_err > tol)
    excused = ties() if bool(bad.any()) else torch.zeros_like(bad)
    err = float(px_err[~excused].max())
    log(f"[2b] {tag} K3 {v} vs {against}: max|d image|,|d final_T| {err:.3e}  n_contrib mismatches "
        f"{int(nc_bad.sum())} (tie pixels excused {int(excused.sum())})")
    if bool((bad & ~excused).any()):
        raise AssertionError(f"{tag}: K3 {v} disagrees with {against} beyond {tol} at "
                             f"{int((bad & ~excused).sum())} pixels that are not ties")
    return err


def check_probe_backward(tag, v, against, out, ref, tol) -> float:
    """Max abs error of K4 variant `v`'s grads against `ref` (named
    `against`); raises beyond `tol` relative to the max of `ref`."""
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    log(f"[2b] {tag} K4 {v} vs {against}: max|d grad| {err:.3e}  relative to max {rel:.3e}")
    if not rel <= tol:
        raise AssertionError(f"{tag}: K4 {v} disagrees with {against} beyond {tol} relative")
    return err


def compare_probes(sc: dict, tag: str, full: bool) -> dict:
    """Every K3/K4 variant on scene `sc` of phase 2. The variants that keep
    K1/K2's numerics are held against phase 2's K1/K2 outputs; with `full`,
    every variant is also held against its plain version, and otherwise only
    the others run their plain version, once (the rest take phase 2's plain
    time). Returns {(direction, variant): (max abs err, ms, plain ms)}."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    args = (sc["splats"], sc["starts"], sc["lens"])
    res = {}
    for v in bp.FORWARD_VARIANTS:
        plain = functools.partial(bp.probe_forward_plain, v)
        out = bp.probe_forward(v, *args, **kw)
        errs, plain_ms = [], sc["times"]["forward"][2]
        if full or v not in FWD_K1_NUMERICS:
            ref, plain_ms = timed(lambda: plain(*args, **kw))
            errs.append(check_probe_forward(tag, v, "plain", out, ref, IMG_ATOL,
                                            lambda: tie_pixels(plain, sc, kw)))
        if v in FWD_K1_NUMERICS:
            errs.append(check_probe_forward(tag, v, "K1", out, sc["k1"], 0.0,
                                            lambda: sc["ties"]))
        res[("forward", v)] = (max(errs), cuda_ms(lambda: bp.probe_forward(v, *args, **kw), 20),
                               plain_ms)

    bargs = args + sc["k2_in"]   # phase 2's dL/dpix, final_T and n_contrib
    fkw = dict(kw, sorted_gauss=sc["sorted_gauss"], n_gauss=sc["n_gauss"])
    sg = sc["sorted_gauss"].long()
    k2_sum = sc["k2"].new_zeros((sc["n_gauss"] + 1, sc["k2"].shape[1])).index_add_(
        0, sg, sc["k2"])
    for v in bp.BACKWARD_VARIANTS:
        out = bp.probe_backward(v, *bargs, **fkw)
        errs, plain_ms = [], sc["times"]["backward"][2]
        if full or v == "nored":
            ref, plain_ms = timed(lambda: bp.probe_backward_plain(v, *bargs, **fkw))
            errs.append(check_probe_backward(tag, v, "plain", out, ref,
                                             NORED_RTOL if v == "nored" else GRAD_RTOL))
        elif v == "fused":
            plain_ms += cuda_ms(lambda: torch.zeros_like(k2_sum).index_add_(0, sg, sc["k2"]), 5)
        if v == "fused":
            errs.append(check_probe_backward(tag, v, "K2 + index_add_", out, k2_sum,
                                             BWD_RTOL_VS_K2[v]))
        elif v in BWD_RTOL_VS_K2:
            errs.append(check_probe_backward(tag, v, "K2", out, sc["k2"], BWD_RTOL_VS_K2[v]))
        res[("backward", v)] = (max(errs),
                                cuda_ms(lambda: bp.probe_backward(v, *bargs, **fkw), 20), plain_ms)
    for (d, v), (_, tk, tp) in res.items():
        log(f"[2b] {tag} time {d} {v}: kernel {tk:.4f} ms  plain {tp:.4f} ms")
    return res


def load_tool(name: str):
    """tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_probes(state: dict, scenes, iters: int = 3) -> list:
    """K3/K4 against their plain versions on phase 2's scenes, then the
    probes' own path: the two probe tools' run() on the probe scene, between
    a reset and a read of the probe launch counters."""
    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.synthetic import probe_scene

    light_sc, step_sc = scenes
    light = compare_probes(light_sc, f"{light_sc['n_gauss']}-Gaussian scene", full=True)
    step = compare_probes(step_sc, f"{state['n']}-Gaussian train step", full=False)

    sc = probe_scene(state["cfg"], state["intr"], state["gm"], state["kf"])
    tools = load_tool("probe_torch_kernel"), load_tool("probe_torch_bwd")
    bp.reset_launches()
    tools[0].run(sc, iters, log=lambda s: log(f"[2b] probe path: {s}"))
    tools[1].run(sc, iters, log=lambda s: log(f"[2b] probe path: {s}"))
    launches = dict(bp.LAUNCHES)
    log(f"[2b] launches in the probe path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a probe variant never launched on the probe path: {launches}")

    src = "gaussian_lic_tpu_torch/csrc/"
    rows = []
    for d, variants, cu, replaces in (
            ("forward", bp.FORWARD_VARIANTS, "blend_probe_forward.cu", "tools/probe_kernel.py:235"),
            ("backward", bp.BACKWARD_VARIANTS, "blend_probe_backward.cu", "tools/probe_bwd.py:354")):
        for v in variants:
            key = (d, v)
            rows.append(dict(name=f"probe_{d}_{v}", route="cuda", source=src + cu,
                             replaces=replaces, launches=launches[f"{d}_{v}"],
                             max_abs_err=max(light[key][0], step[key][0]),
                             ms=step[key][1], plain_ms=step[key][2]))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def run_engine(cfg, frames, dev, verbose: bool):
    from gaussian_lic_tpu_torch.engine.trainer import MappingEngine

    eng = MappingEngine(cfg, device=dev)
    rows = []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        if eng.add_frame(f):
            dt = time.perf_counter() - t0
            m = eng.last_metrics
            rows.append((eng.kf_count, i, m["loss"], int(eng.gm.count), int(m["overflow"]), dt))
            if verbose:
                log(f"[3] kf {eng.kf_count:2d} @ frame {i:2d}: loss {m['loss']:.6f} "
                    f"gaussians {int(eng.gm.count)} overflow {int(m['overflow'])} "
                    f"seconds {dt:.4f}")
    return eng, rows


def phase_slice(dev, kernels: list, n_points: int = 50000, n_frames: int = 40,
                points_per_frame: int = 5000) -> dict:
    import torch

    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.config import Params, load_params
    from gaussian_lic_tpu_torch.ops import blend, losses
    from gaussian_lic_tpu_torch.ops.rasterize import _splat_budget_for, render_map
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    cfg = load_params(CONFIG, skybox_points_num=0)
    intr = Intrinsics(cfg.width, cfg.height, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    world = make_world(rng, n_points=n_points, intr=intr)
    frames = make_sequence(world, n_frames=n_frames, points_per_frame=points_per_frame,
                           rng=rng, device=dev)
    log(f"[3] stream: {n_frames} frames of {cfg.width}x{cfg.height}, {n_points}-point "
        f"world, {points_per_frame} points/frame ({time.perf_counter() - t0:.2f} s to build)")

    blend.reset_launches()
    eng, rows = run_engine(cfg, frames, dev, verbose=True)
    launches = dict(blend.LAUNCHES)
    log(f"[3] launches in the stream: {launches}")

    kf_losses = [r[2] for r in rows]
    if not all(math.isfinite(v) for v in kf_losses):
        raise AssertionError(f"non-finite keyframe loss: {kf_losses}")
    if not kf_losses[-1] < kf_losses[0]:
        raise AssertionError(f"loss did not fall: {kf_losses[0]} -> {kf_losses[-1]}")
    for k in kernels:
        k["launches"] = launches[k["counter"]]
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on the main path")

    psnrs = []
    with torch.no_grad():
        for i in range(eng.kf_count):
            out = render_map(eng.gm, eng.train_camera(i), tile_h=cfg.tile_h,
                             tile_w=cfg.tile_w,
                             max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                             max_total_splats=_splat_budget_for(eng.gm.capacity, eng.cfg))
            gt = eng.kf_buffer.images[i].float() / 255.0
            psnrs.append(float(losses.psnr(out.image.clamp(0.0, 1.0), gt)))
    train_psnr = float(np.mean(psnrs))
    log(f"[3] train PSNR over {eng.kf_count} keyframes: {train_psnr:.4f} dB "
        f"(floor {PSNR_FLOOR}); gaussians {int(eng.gm.count)}; "
        f"steps {sum(min(cfg.max_iters_per_keyframe, k) for k in range(1, eng.kf_count + 1))}")
    if not train_psnr > PSNR_FLOOR:
        raise AssertionError(f"train PSNR {train_psnr} below the floor {PSNR_FLOOR}")

    # the same small stream through the engine on the card and on the CPU
    small = Params(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0,
                   select_every_k_frame=2, skybox_points_num=0, initial_capacity=512,
                   densify_budget=256, max_train_keyframes=4, max_tiles_per_gaussian=16)
    s_intr = Intrinsics(64, 64, 40.0, 40.0, 32.0, 32.0)
    s_rng = np.random.default_rng(3)
    s_frames = make_sequence(make_world(s_rng, n_points=300, intr=s_intr), n_frames=6,
                             points_per_frame=100, rng=s_rng, device="cpu")
    _, rows_gpu = run_engine(small, s_frames, dev, verbose=False)
    _, rows_cpu = run_engine(small, s_frames, "cpu", verbose=False)
    rel = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(rows_gpu, rows_cpu))
    counts = ([r[3] for r in rows_gpu], [r[3] for r in rows_cpu])
    log(f"[3] small stream card vs CPU: gaussians {counts[0]} vs {counts[1]}, "
        f"max per-keyframe loss rel diff {rel:.3e}")
    if counts[0] != counts[1] or not rel <= SMALL_LOSS_RTOL:
        raise AssertionError("engine on the card disagrees with the engine on the CPU")
    return dict(train_psnr=train_psnr, keyframes=rows, launches=launches)


# ---------------------------------------------------------------------------
# phase 4: full-size train steps
# ---------------------------------------------------------------------------

def bench_state(dev, n: int = 1 << 20) -> dict:
    """The train-step benchmark state: n Gaussians at the fastlivo rig."""
    from gaussian_lic_tpu_torch.config import load_params
    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

    cfg = load_params(preset="fastlivo", initial_capacity=n, skybox_points_num=0)
    intr, gm, kf, opt = make_bench_state(cfg, n, dev)
    return dict(n=n, cfg=cfg, intr=intr, gm=gm, kf=kf, opt=opt)


def phase_steps(dev, card: str, state: dict) -> dict:
    import torch

    from gaussian_lic_tpu_torch.engine.trainer import train_step

    n, cfg, intr, gm, kf, opt = (state[k] for k in ("n", "cfg", "intr", "gm", "kf", "opt"))
    del state["gm"], state["opt"]   # the steps replace them
    gc.collect()                    # engines of phase 3 held in reference cycles
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    step = 0

    def run(k):
        nonlocal gm, opt, step
        m = None
        for _ in range(k):
            step += 1
            gm, opt, m = train_step(gm, opt, kf, step % 4, step, intr=intr, cfg=cfg)
        return m

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = run(20)
    torch.cuda.synchronize()
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    ms = dt / 20 * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    res = dict(ms_per_step=ms, it_per_s=1e3 / ms, peak_bytes=peak, loss=loss,
               budget_lost=int(m["budget_lost"]), truncated=int(m["truncated"]),
               n_visible=int(m["n_visible"]))
    log(f"[4] {n} Gaussians 640x512 ({card}): {ms:.3f} ms/step, {1e3 / ms:.3f} it/s, "
        f"peak memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the "
        f"steps), loss {loss:.6f}, visible {res['n_visible']}, "
        f"budget_lost {res['budget_lost']}, truncated {res['truncated']}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return res


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "gaussian_lic_tpu_torch")):
        print("chip_smoke.py: the gaussian_lic_tpu_torch package is not beside this "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this test runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gaussian_lic_tpu_torch import _build
    from gaussian_lic_tpu_torch.utils.cuda_timing import card_line

    t_all = time.perf_counter()
    dev = torch.device("cuda:0")
    # [1] device and build
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    lib = _build.load()
    for line in lib.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[1] ptxas: {line.strip()}")
    log(f"[1] kernels built in {lib.build_seconds:.2f} s -> {os.path.relpath(lib.path, REPO)} "
        f"(phase {time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    state = bench_state(dev)
    kernels, scenes = phase_kernels(dev, state)
    log(f"[2] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    probes = phase_probes(state, scenes)
    del scenes
    log(f"[2b] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    phase_slice(dev, kernels)
    log(f"[3] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    phase_steps(dev, card, state)
    log(f"[4] phase seconds {time.perf_counter() - t0:.2f}")
    log(f"total seconds {time.perf_counter() - t_all:.2f}")

    for k in kernels:
        del k["counter"]
    print(json.dumps({"kernels": kernels + probes}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
