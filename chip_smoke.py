#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gaussian_lic_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers and seconds; any failure raises, so the
exit code is not 0:

  1. device and build: the card's name and power limit, TF32 switched off,
     the CUDA kernels built with nvcc from csrc/ (seconds, ptxas report);
     K2's entry loop in the SASS (cuobjdump) must issue exactly the shuffle
     and shared-memory instructions of today's loop (K2_LOOP_COUNTS: under
     a third of the first design's, whose counts are printed beside them);
  2. kernel vs plain: K1 blend_forward (color and no_color) and K2
     blend_backward at 640x512, each held against its plain PyTorch version
     with both times (CUDA events), on two inputs: a seeded ~20k-Gaussian
     scene (short tile lists) and the arguments of phase 4's first train step
     at 1M Gaussians (tile lists of thousands of entries, so K1 walks many
     staged batches and its early exit). K1 must match bit for bit outside
     termination ties; the share of (entry, warp block) pairs its cull keeps
     is read from its plain emulation (warp_cull_keep), and at each input K1
     is timed in turns beside K3 base, the same kernel launched through the
     probe's entry (a check that the probes time the production kernel). K2
     returns per-Gaussian sums and is held per column against the plain
     per-entry version + index_add_; at each input it is timed in turns
     beside K4 base, likewise. Every kernel's bounds come from the
     (entry, pixel) pairs of the train step's inputs (blend_pairs), the
     card's SM count and max clock: bound_ms on the pairs the result needs,
     walk_bound_ms on every pair a plain walk tests;
  2b. the blend probes K3/K4 (ops/blend_probe.py), instantiations of K1's
     and K2's own kernel templates: every variant on phase 2's two inputs.
     The variants that compute K1's outputs (base, nocull, batch256,
     direct) must equal phase 2's K1 output bit for bit; those that compute
     K2's (base, sbuf, smematomic, nocull) must agree per column with K2's
     plain per-Gaussian output of phase 2 (and base with K2's); the others
     (noexp, noattr, noblend, nored, noatomic) with their own plain
     versions, as every variant on the 20k scene. The built SASS of K3/K4
     base is set beside K1's/K2's. Then the probes' own path, the run() of
     tools/probe_torch_kernel.py and tools/probe_torch_bwd.py on the probe
     scene (1M Gaussians, camera 0: every variant's time, its difference
     from base and its deviation from its plain version; K2's tile order),
     with the probe launch counters zeroed just before and read just after:
     every variant must show;
  2c. the per-Gaussian kernels K5 (preprocess forward), K6 (its backward)
     and K7 (the six-group sparse Adam), on phase 2's two inputs with edge
     rows put in (NaN opacity, behind the camera, det = 0, tx and ty
     clamped, an SH colour below 0, inactive): K5 against the plain chain
     (rows and depth within PRE_FWD_RTOL of each column's max, radius on at
     most PRE_RADIUS_SHARE of rows off by 1, base_active equal; the sorted
     lists binned from both compared), K6 against the closed form and
     autograd of the plain chain (PRE_GRAD_RTOL of each column's max; on
     the 20k scene both K6 and the float32 autograd also against a float64
     autograd run), K7 bit for bit against the per-group loop; each timed
     (20 launches) beside its plain version, the parent's main path. Then
     K6's timing variants (preprocess.K6_VARIANTS, instantiations of K6's
     own template: base and direct must equal K6 bit for bit, noshio and
     noproj are timed only) with the count of rows whose row gradient is
     not zero, and the built SASS of K6 beside its probe's base (the same
     opcodes, in both input forms). The same from the stored parameters
     (log_scale, quat, opa_logit: the main path's form, the activations
     inside K5 and K6) with their edge rows besides (exp overflowing, opacity
     logits of +-inf, a zero quaternion): K5 bit for bit against the plain
     chain with its activations, every output and the binned lists; K6
     within PRE_GRAD_RTOL of the closed form, autograd and float64 autograd,
     each output's ulps against autograd printed; both timed in CUDA graphs
     (20 calls) in turns beside the parent's path, the activations as
     PyTorch ops around K5 and K6 in activated form;
  2d. the binning kernels K8 (slot keys), K9 (sorted list and tile ranges)
     and K10 (the splat gather), on phase 2's two inputs with phase 2c's
     edge rows through K5: K8 with global tile ids; K8, K9 on the stable
     sort of its 32-bit keys and K10 on K9's list in the whole grid (at
     the scene's budget and at a budget cut) and in every band of D = 2, 4
     and 8; each bit for bit against its plain version (K10 also against
     `index_select`), K8 also from depth keys (compute_slot_keys_kmajor),
     timed beside it (20 calls in a CUDA graph, as the bundles run them,
     and eagerly), with its bytes bound; the sort timed on the keys as
     int64 and as int32 in turns; K8's timing variants (tiles.K8_VARIANTS,
     instantiations of K8's own template: those that compute K8's outputs
     bit for bit against it) timed beside each other in turns, and the
     warp-slots in which K8 runs the power's body against those of the
     listed design, counted from the slot mask (k8_warp_slots); K9 with K8's
     outputs (cnt from touched or JAX's survivor compare) and without them
     (the sharded path's histogram), and K9's timing variants
     (tiles.K9_VARIANTS: the first design and its cost centres, the listed
     design with the histogram) held bit for bit at the budget and at a cut
     and timed beside K9 in turns (k9_variants); the built SASS of K8 and
     K9 beside their probes' bases, and the registers, spills and shared
     memory of K8's and K9's kernels (cuobjdump);
  2e. the loss kernels K11 (SSIM and L1 forward: the window's two sums and
     the three partial maps) and K12 (d loss / d img), on phase 2's two
     inputs (the 20k scene's render against a seeded smooth-ish target, the
     1M train step's render against its keyframe's image), the whole image
     and every band of D = 2, 4 and 8 with its halo rows, and on the CPU
     tests' shapes: K11's partial maps and K12 bit for bit against their
     plain versions (the ulps are printed), K11's sums within
     SSIM_SUM_RTOL, K12 within SSIM_GRAD_RTOL of the gradient's max against
     autograd of the plain chain (float64 autograd too on the 20k scene and
     the small shapes); then each timed (20 calls in a CUDA graph) beside its
     plain version, the plain chain's forward and autograd backward (the
     path before the kernels) and the library's blurs (a depthwise F.conv2d
     pair, TF32 off), with its bytes and operations bounds; K11's timing
     variants (losses.K11_VARIANTS: other geometries, persistent blocks,
     the first design, each with one cost centre taken out) timed beside
     each other in turns, those that compute K11's outputs held bit for bit
     (partial maps) and within SSIM_SUM_RTOL (sums) wherever K11 is; K12's
     (losses.K12_VARIANTS: the listed design at other geometries, the first
     design, each with one cost centre taken out) timed beside K12 in turns,
     those that compute K12's d held bit for bit wherever K12 is; the built
     SASS of K11 and K12 beside their probes' bases, and the registers,
     spills and shared memory of K11's and K12's kernels (cuobjdump);
  3. the slice: MappingEngine.add_frame over a 40-frame synthetic stream at
     the fastlivo rig (640x512, SH 3, 16 tile slots, capacity 262144), its
     steps in bundles (CUDA graphs); the launch counters are zeroed just
     before the stream and read just after, and must show every kernel; the
     train PSNR must clear a floor; the same small stream through the engine
     on the card and on the CPU (plain path, eager bundles) must agree; the
     graphs' capture seconds and the compile count are printed; every
     render must launch one K8, K9 and K10 (as many as K1's launches), and
     every train step one K11 and one K12 (as many as K7's);
  4. full-size train steps: the 1M-Gaussian state of phase 2, 100 steps
     eagerly and as the bundles 64+16+16+4 in turns (eager, bundle, bundle,
     eager, after an untimed pass that captures the graphs) from one state:
     ms/step, it/s, peak memory, overflow counters, capture seconds and the
     graph pool's bytes; the bundles' losses must agree with the eager
     runs' within their spread, every turn must launch one K1, K5, K6, K7,
     K8, K9, K10, K11 and K12 a step, the bundles' launches must equal
     the eager loop's, and one eager step (profiled) must run no
     exp, sigmoid or norm op of its own (ACTIVATION_OPS);
  5. the application: phase 3's stream written as a RecordedStream directory
     (stamps 0.1 s apart) and run through `run.main` with config/fastlivo.yaml
     as shipped (100,000 skybox Gaussians, 16 tile slots), randinit LPIPS,
     a result path, a checkpoint and the phase timers, on the card; the
     launch counters are zeroed just before and read at the end of the
     stream and around `finalize` (its steps in bundles, as in phase 3).
     It checks the exit code, the kernels' launches in the stream and one
     K1 launch per eval view (and one K8, K9 and K10 per render in both,
     one K11 and K12 per train step in the stream and one K11 per eval
     view),
     finite eval metrics above a train-PSNR floor, the PLY's vertex count
     (the skybox left out), the 40 PNG pairs, and that the checkpoint loads back equal
     to the engine that wrote it; then a 64x64 application with a 256-point
     skybox runs through `run.main` on the card and on the CPU, and their
     finalize metrics and PLY vertex counts must agree;
  6. the multi-GPU path (gaussian_lic_tpu_torch/parallel/) on one card:
     (a) K1 (bit for bit) and K2 on the 20k scene binned in the band
     geometry's fallback tiles, 16x64 and 8x128, and on the blend golden's
     list with a NaN-opacity row in front of each tile, against their plain
     versions; (b) on phase 4's 1M state, `render_band` for every band of
     D = 2, 4 and 8 (band binning), stitched and held against the full
     render, K1, K8, K9 and K10 launched D times; (c) on a one-rank NCCL
     process group, the sharded train step against `train_step` for 2 steps (loss, gradients
     and params by tests/test_parallel.py's rule), then 20 timed steps of
     each in turns (ms/step, peak memory), then 100 sharded steps eagerly
     and as the sharded bundles 64+16+16+4 (CUDA graphs over NCCL) in turns
     as phase 4 runs them, with phase 4's loss, launch and activation-op
     checks; (d)
     MappingEngine on that group over phase 3's stream, its bundles CUDA
     graphs (the captures printed), the launch counters zeroed just before
     and read just after, train PSNR within 0.1 dB of phase 3's; (e) `run.main
     --mesh-devices 1` on phase 5's 64x64 application, metrics within
     1e-4 of phase 5's card run. One card cannot run two NCCL ranks: the
     exchange between ranks is tested on the CPU (tests/test_torch_parallel.py);
  7. the dense oracle and the production-scale tools: (a) K1 and K2 against
     an independent reference, the dense oracle (ops/rasterize_ref.py), on
     tests/test_rasterize_tiled.py's scenes at 256x64 (a 200-Gaussian
     forward; the gradients of a 60-Gaussian scene through K1 + K2 against
     autograd of the oracle), and the oracle on the card against the CPU;
     (b) tools/soak_torch.py through its main() at 60 frames of the
     production config (skybox 100,000, 16 tile slots, 100 iterations a
     keyframe, in bundles), which must print SOAK PASS, with the launch
     counters zeroed just before and read just after; (c) tools/validate_scale_torch.py at
     its defaults (VALIDATION PASS); (d) run._demo_frames at the fastlivo
     rig, whose GT comes from the dense oracle, on the card against the CPU.

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
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "config", "fastlivo.yaml")

PSNR_FLOOR = 17.0          # phase 3 train PSNR floor: first H100 run 18.86 dB
IMG_ATOL = 1e-5            # K3 variants' image and final_T vs their plain versions
K1_ATOL = 0.0              # K1 vs plain: bit for bit (the same float operations in order)
GRAD_RTOL = 1e-4           # K2 per-Gaussian grads vs plain, relative to each column's max
SMALL_LOSS_RTOL = 1e-4     # phase 3 small stream: card vs CPU per-keyframe loss
APP_PSNR_FLOOR = 17.0      # phase 5 train PSNR floor: first H100 run 18.73 dB
APP_SMALL_RTOL = 1e-4      # phase 5 64x64 app, card vs CPU eval metrics: first H100 run 3.6e-6
NOBLEND_RTOL = 1e-5        # K3 noblend vs plain, relative to the max: sums of ~1e4 powers
NORED_RTOL = 1e-4          # K4 nored vs plain, relative to the max: 4-pixel sums
FWD_K1_NUMERICS = ("base", "nocull", "batch256", "direct")   # K3 variants: K1 bit for bit
# K4 variants held to K2's plain per-Gaussian output, per column within
# GRAD_RTOL (they sum the pixels in another order)
BWD_K2_NUMERICS = ("base", "sbuf", "smematomic", "nocull")
# K2's entry loop in the first design's SASS, as cuobjdump showed it while
# that design was built: SHFL, STS, LDS
FIRST_K2_LOOP = {"SHFL": 45, "STS": 18, "LDS": 9}
# K2's entry loop now (the loop over a ballot's set bits, one entry a pass):
# the 12-shuffle reduce-scatter, one shared store of a warp sum, and the
# row's three shared loads; 45 shuffles again would fail the check. The
# cull's box load and ballot run once per 32 entries, in the loop around it.
K2_LOOP_COUNTS = {"SHFL": 12, "STS": 1, "LDS": 3}

# Bounds: the least time the card could take for a kernel's work on this
# run's inputs, the larger of its bytes over the memory rate and of its
# operations over the rate of their pipe. Operations per (entry, pixel) pair,
# counted from the kernels' source (blend_common.cuh, blend_*.cu): FP32
# instructions (an FMA is one; the accurate expf is 6 and one MUFU ex2, the
# IEEE 1/x 4 and one MUFU rcp), as (per pair tested, extra per pair applied).
# bound_ms counts the pairs the result needs: those a pixel applies and,
# going forward, the one it stops at (a kernel that skips every other pair
# cannot beat it). walk_bound_ms counts every pair a plain walk tests: up to
# the entry where the pixel stops (forward) or up to its last applied one
# (backward); see blend_pairs.
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
FP32_LANES_PER_SM = 128    # FP32 lanes per SM and clock (67 TFLOP/s at 1,980 MHz, FMA = 2)
MUFU_LANES_PER_SM = 16     # special-function lanes per SM and clock
PAIR_FP32 = {"forward": (19, 7), "forward_no_color": (19, 3), "backward": (19, 26),
             "noexp": (14, 7), "noblend": (12, 0)}
PAIR_MUFU = {"forward": (1, 0), "forward_no_color": (1, 0), "backward": (1, 1),
             "noexp": (0, 0), "noblend": (0, 0)}
ROW_BYTES = 36             # the 9 used floats of a gathered splat row


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(dev) -> dict:
    """The card's SM count and its maximum SM clock (nvidia-smi clocks.max.sm)."""
    import subprocess

    import torch

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.split()[0]
    return dict(sms=torch.cuda.get_device_properties(dev).multi_processor_count,
                hz=float(mhz) * 1e6)


def blend_pairs(splats, starts, lens, grid, exp=None) -> dict:
    """(entry, pixel) pairs of a blend on these inputs, from the plain
    version's arithmetic: `forward`, per pixel the entries up to the one at
    which it stops (its whole range if it never stops); `applied`, the pairs
    it blends; `stopped`, the pixels that stop (at a pair that contributes
    but is not applied); `backward`, per pixel the entries up to its last
    applied one (n_contrib); `all`, every entry of every range at every
    pixel of its tile."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend

    kw = {} if exp is None else dict(exp=exp)
    out = dict(forward=0, applied=0, stopped=0, backward=0,
               all=int(lens.long().sum()) * blend.TILE_PIX)
    for tiles, L in blend._tile_chunks(lens):
        e, _, _ = blend._gather_entries(splats, starts, lens, tiles, L)
        px, py = blend._pixel_coords(tiles, grid.n_tx, grid.tile_h, grid.tile_w)
        *_, alpha, contrib = blend._alpha(e, px, py, **kw)
        t_f = 1.0 - torch.where(contrib, alpha, torch.zeros_like(alpha))
        T_excl = torch.cumprod(torch.cat([torch.ones_like(t_f[:, :1]), t_f[:, :-1]], 1), 1)
        trigger = contrib & (T_excl * t_f < blend.T_EPS)
        del T_excl, t_f
        stops = trigger.any(1)
        stop = trigger.to(torch.int32).argmax(1) + 1
        tested = torch.where(stops, stop, lens[tiles].long()[:, None].expand_as(stop))
        applied = contrib & (torch.cumsum(trigger.to(torch.int32), 1) == 0)
        pos = torch.arange(1, L + 1, device=splats.device)[None, :, None]
        out["forward"] += int(tested.long().sum())
        out["applied"] += int(applied.sum())
        out["stopped"] += int(stops.sum())
        out["backward"] += int(torch.where(applied, pos, 0).amax(1).long().sum())
    return out


def bound_ms(rates, nbytes, tested, applied, cost) -> tuple:
    """(bound ms, "bytes" or "operations") of a kernel that moves `nbytes`,
    tests `tested` pairs and applies `applied` of them, at
    PAIR_FP32/PAIR_MUFU[cost] a pair."""
    ops = {k: c[0] * tested + c[1] * applied
           for k, c in (("fp32", PAIR_FP32[cost]), ("mufu", PAIR_MUFU[cost]))}
    t_ops = max(ops["fp32"] / (rates["sms"] * FP32_LANES_PER_SM * rates["hz"]),
                ops["mufu"] / (rates["sms"] * MUFU_LANES_PER_SM * rates["hz"]))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def bounds(rates, nbytes, pairs, cost, direction) -> dict:
    """bound_ms and bound_by on the pairs the result needs, and
    walk_bound_ms on the pairs a plain walk tests, of a kernel that moves
    `nbytes` and does PAIR_FP32/PAIR_MUFU[cost] on `pairs` (blend_pairs) in
    `direction` ("all" for a kernel whose result sums every pair)."""
    applied = pairs["applied"] if direction != "all" else 0
    needed = {"forward": pairs["applied"] + pairs["stopped"], "backward": pairs["applied"],
              "all": pairs["all"]}[direction]
    b_ms, b_by = bound_ms(rates, nbytes, needed, applied, cost)
    return dict(bound_ms=b_ms, bound_by=b_by,
                walk_bound_ms=bound_ms(rates, nbytes, pairs[direction], applied, cost)[0])


def blend_bytes(sc, output: str) -> int:
    """Bytes a blend kernel must move on scene `sc`: the used splat columns,
    the tile ranges, the per-pixel inputs, and its output (`output`: image
    (color, final_T, n_contrib), `entry` (M_pad, 9) or `gauss` (P, 9) grads;
    the backward also reads sorted_gauss for `gauss`; `bands`, K4
    noatomic's (4, M_pad, 9) band records)."""
    m, g = sc["splats"].shape[0], sc["grid"]
    px = g.padded_width * g.padded_height
    n = m * ROW_BYTES + 8 * g.n_tx * g.n_ty
    if output == "image":
        return n + 20 * px
    n += 20 * px   # dL/dpix, final_T, n_contrib
    if output == "bands":
        return n + 4 * m * ROW_BYTES
    return n + (m * ROW_BYTES if output == "entry" else m * 4 + sc["n_gauss"] * ROW_BYTES)


def sass_loop_counts(sass: str, kernel: str, ops=("SHFL", "STS", "LDS")) -> dict:
    """Counts of `ops` in the innermost loop (a backward branch's span) of
    the first SASS function whose name holds `kernel` and that holds a SHFL
    (a K2 design's entry loop, which carries its warp reduction)."""
    import re

    for part in sass.split("Function : ")[1:]:
        if kernel not in part.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        loops = []
        for addr, text in ins:
            m = re.search(r"BRA\s.*?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                if any("SHFL" in t for t in body):
                    loops.append(body)
        body = min(loops, key=len)
        op = lambda t: re.sub(r"^@!?U?P\w+\s+", "", t).split(".")[0].split()[0]  # noqa: E731
        return dict(instructions=len(body), **{o: sum(op(t) == o for t in body) for o in ops})
    raise AssertionError(f"no kernel {kernel!r} with a SHFL loop in the SASS")


def built_sass(lib_path: str) -> str:
    """cuobjdump -sass of the built kernel library."""
    import subprocess

    from gaussian_lic_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout


def check_k2_reduction(lib_path: str) -> None:
    """K2's entry loop, in the built SASS, must issue exactly K2_LOOP_COUNTS
    shuffle and shared memory instructions (a third of the first design's
    FIRST_K2_LOOP or less)."""
    new = sass_loop_counts(built_sass(lib_path), "blend_backward_kernelILi0E")
    log(f"[1] SASS of the entry loop: K2 {new}; expected {K2_LOOP_COUNTS}; first design "
        f"{FIRST_K2_LOOP}")
    if any(new[o] != n for o, n in K2_LOOP_COUNTS.items()):
        raise AssertionError(f"K2's entry loop issues {new}, not {K2_LOOP_COUNTS}")


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


def reset_launches() -> None:
    """Zeroes the launch counters of the train step's kernels (K1/K2, K5/K6,
    K7, K8-K10, K11/K12)."""
    from gaussian_lic_tpu_torch.engine.trainer import KERNEL_LAUNCHES

    for counter in KERNEL_LAUNCHES:
        for k in counter:
            counter[k] = 0


def kernel_launches() -> dict:
    """Every counter of KERNEL_LAUNCHES in one dict."""
    from gaussian_lic_tpu_torch.engine.trainer import KERNEL_LAUNCHES

    return {k: v for counter in KERNEL_LAUNCHES for k, v in counter.items()}


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------

def kernel_scene(dev, n: int = 20000, seed: int = 1, tile=None) -> dict:
    """Seeded 640x512 scene of `n` Gaussians, with a random seeded dL/dpix,
    binned into the config's tiles or into `tile` (tile_h, tile_w)."""
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
    tile_h, tile_w = tile or (cfg.tile_h, cfg.tile_w)
    sc = splat_args(xyz, scale, quat, opacity, cam, dc=dc, sh_rest=sh_rest, sh_degree=3,
                    tile_h=tile_h, tile_w=tile_w,
                    max_tiles_per_gaussian=cfg.max_tiles_per_gaussian, max_total_splats=4 * n)
    sc["inputs"] = dict(xyz=xyz, scale=scale, quat=quat, opacity=opacity, camera=cam, dc=dc,
                        sh_rest=sh_rest, sh_degree=3, active=None)
    # stored parameters of the scene (log_scale, quat, opa_logit), under the
    # inputs' names: what a map holds and the train step hands K5 and K6
    sc["stored"] = dict(scale=torch.log(scale), quat=quat,
                        opacity=torch.log(opacity / (1.0 - opacity)))
    sc["bin_kw"] = dict(max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                        max_total_splats=4 * n)
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
    inputs = dict(xyz=gm.xyz, scale=gm.scaling, quat=gm.rotation, opacity=gm.opacity,
                  camera=kf.camera(intr, idx), dc=gm.dc, sh_rest=gm.sh_rest,
                  sh_degree=gm.sh_degree, active=gm.active_mask())
    sc = splat_args(*(inputs[k] for k in ("xyz", "scale", "quat", "opacity", "camera")),
                    dc=gm.dc, sh_rest=gm.sh_rest, sh_degree=gm.sh_degree,
                    active=inputs["active"], **_render_kw(cfg, gm.capacity))
    sc["inputs"] = inputs
    sc["stored"] = dict(scale=gm.log_scale, quat=gm.quat, opacity=gm.opa_logit)
    kw = _render_kw(cfg, gm.capacity)
    sc["bin_kw"] = {k: kw[k] for k in ("max_tiles_per_gaussian", "max_total_splats")}
    g = sc["grid"]
    color = blend.blend_forward_plain(sc["splats"], sc["starts"], sc["lens"], n_tx=g.n_tx,
                                      n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)[0]
    color = color.requires_grad_(True)
    gt = kf.images[idx].float() / 255.0
    loss = losses.training_loss(color[:, :intr.height, :intr.width], gt, cfg.lambda_dssim)
    sc["dl"] = torch.autograd.grad(loss, color)[0].contiguous()
    sc["gt"] = gt
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
    from gaussian_lic_tpu_torch.ops import blend_probe as bp
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
    if not (err_img <= K1_ATOL and err_ft <= K1_ATOL):
        raise AssertionError(f"{tag}: K1 disagrees with its plain version beyond {K1_ATOL}")
    keep = blend.warp_cull_keep(*args, **kw)
    kept = float(keep.sum()) / (int(sc["lens"].long().sum()) * keep.shape[2])
    del keep
    log(f"[2] {tag} K1 cull: kept share of (entry, warp block) pairs {kept:.6f} "
        f"(warp_cull_keep, {'x'.join(map(str, blend.k1_block(g.tile_h, g.tile_w)))} blocks)")

    nk = blend.blend_forward(*args, no_color=True, **kw)
    np_ = blend.blend_forward_plain(*args, no_color=True, **kw)
    err_nc = float((nk[1] - np_[1]).abs()[~ties].max())
    if float(nk[0].abs().max()) != 0.0 or int(nk[2].abs().max()) != 0:
        raise AssertionError(f"{tag}: K1 no_color wrote color or n_contrib")
    log(f"[2] {tag} K1 no_color: max|d final_T| {err_nc:.3e}")
    if not err_nc <= K1_ATOL:
        raise AssertionError(f"{tag}: K1 no_color disagrees with its plain version beyond "
                             f"{K1_ATOL}")

    bargs = args + (sc["dl"], out_p[1], out_p[2])
    sg, P = sc["sorted_gauss"], sc["n_gauss"]
    gkw = dict(kw, n_gauss=P)
    gk = blend.blend_backward(*bargs, sg, **gkw)
    gp_entry = blend.blend_backward_plain(*bargs, **kw)
    gp = blend.sum_per_gaussian(gp_entry, sg, P)
    torch.cuda.synchronize()
    err_g = float((gk - gp).abs().max())
    rel_cols = ((gk - gp).abs().amax(0) / gp.abs().amax(0).clamp_min(1e-30)).tolist()
    rel_g = max(rel_cols)
    log(f"[2] {tag} K2: max|d grad| {err_g:.3e}  relative to each column's max: "
        + " ".join(f"{r:.2e}" for r in rel_cols))
    if not rel_g <= GRAD_RTOL:
        raise AssertionError(f"{tag}: K2 disagrees with its plain version beyond {GRAD_RTOL} "
                             "relative")

    def plain_bwd():
        return blend.sum_per_gaussian(blend.blend_backward_plain(*bargs, **kw), sg, P)

    def k4_base():   # K2 launched through the probe's entry
        return bp.probe_backward("base", *bargs, sg, **gkw)

    res = {
        "forward": (max(err_img, err_ft),
                    cuda_ms(lambda: blend.blend_forward(*args, **kw), 20),
                    cuda_ms(lambda: blend.blend_forward_plain(*args, **kw), 3)),
        "forward_no_color": (err_nc,
                             cuda_ms(lambda: blend.blend_forward(*args, no_color=True, **kw), 20),
                             cuda_ms(lambda: blend.blend_forward_plain(*args, no_color=True,
                                                                       **kw), 3)),
        "backward": (err_g,
                     cuda_ms(lambda: blend.blend_backward(*bargs, sg, **gkw), 20),
                     cuda_ms(plain_bwd, 3)),
    }
    for k, (_, tk, tp) in res.items():
        log(f"[2] {tag} time {k}: kernel {tk:.4f} ms  plain {tp:.4f} ms")
    # K1 beside K3 base and K2 beside K4 base, in turns: the same kernels
    k3_base = lambda: bp.probe_forward("base", *args, **kw)   # noqa: E731
    k1_vs = [cuda_ms(f, 20) for f in (k3_base, lambda: blend.blend_forward(*args, **kw),
                                      lambda: blend.blend_forward(*args, **kw), k3_base)]
    log(f"[2] {tag} K1 beside K3 base (the same kernel), in turns K3 K1 K1 K3: "
        + " ".join(f"{v:.4f}" for v in k1_vs) + " ms")
    k2_vs = [cuda_ms(f, 20) for f in (k4_base, lambda: blend.blend_backward(*bargs, sg, **gkw),
                                      lambda: blend.blend_backward(*bargs, sg, **gkw), k4_base)]
    log(f"[2] {tag} K2 beside K4 base (the same kernel), in turns K4 K2 K2 K4: "
        + " ".join(f"{v:.4f}" for v in k2_vs) + " ms")
    sc.update(k1=out_k, ties=ties, k2=gk, k2_plain=gp, k2_in=bargs[3:], times=res,
              k3_base_ms=(k1_vs[0] + k1_vs[3]) / 2, k1_turns_ms=(k1_vs[1] + k1_vs[2]) / 2,
              k1_kept=kept, k4_base_ms=(k2_vs[0] + k2_vs[3]) / 2,
              k2_turns_ms=(k2_vs[1] + k2_vs[2]) / 2)
    return res


def phase_kernels(dev, state: dict, rates: dict, n: int = 20000):
    """Compares the kernels on the seeded n-Gaussian scene and on the
    arguments of phase 4's first train step. The JSON line reports the
    larger error of the two, and the times and bounds at the train step's
    shapes. Returns those rows and the two scenes."""
    light_sc, step_sc = kernel_scene(dev, n), step_scene(state)
    light = compare_kernels(light_sc, f"{n}-Gaussian scene")
    step = compare_kernels(step_sc, f"{state['n']}-Gaussian train step")
    g = step_sc["grid"]
    step_sc["pairs"] = {"base": blend_pairs(step_sc["splats"], step_sc["starts"],
                                            step_sc["lens"], g)}
    log(f"[2] train step pairs: {step_sc['pairs']['base']}")
    src = "gaussian_lic_tpu_torch/csrc/"
    pallas = "gaussian_lic_tpu/ops/blend_pallas.py:"
    rows = [("blend_forward", "blend_forward.cu", "278", "forward", "forward", "image"),
            ("blend_forward_no_color", "blend_forward.cu", "278", "forward_no_color",
             "forward", "image"),
            ("blend_backward", "blend_backward.cu", "578", "backward", "backward", "gauss")]
    out = []
    for name, cu, line, key, direction, output in rows:
        b = bounds(rates, blend_bytes(step_sc, output), step_sc["pairs"]["base"], key, direction)
        out.append(dict(name=name, route="cuda", source=src + cu, replaces=pallas + line,
                        counter=key, max_abs_err=max(light[key][0], step[key][0]),
                        ms=step[key][1], plain_ms=step[key][2], **b, library_ms=None))
        log(f"[2] {name}: {step[key][1]:.4f} ms against a bound of {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}; walk bound {b['walk_bound_ms']:.4f} ms)")
    log(f"[2] K1 at the train step: {step['forward'][1]:.4f} ms; in turns {step_sc['k1_turns_ms']:.4f}"
        f" beside K3 base {step_sc['k3_base_ms']:.4f} ms; kept share {step_sc['k1_kept']:.6f}")
    log(f"[2] K2 at the train step: {step['backward'][1]:.4f} ms; in turns "
        f"{step_sc['k2_turns_ms']:.4f} beside K4 base {step_sc['k4_base_ms']:.4f} ms")
    return out, (light_sc, step_sc)


# ---------------------------------------------------------------------------
# phase 2c: the per-Gaussian kernels K5, K6, K7
# ---------------------------------------------------------------------------

PRE_FWD_RTOL = 1e-6        # K5 vs plain: rows and depth, of each column's max
PRE_RADIUS_SHARE = 1e-4    # K5 vs plain: share of rows whose radius may differ, each by 1
PRE_GRAD_RTOL = 1e-5       # K6 vs plain / autograd / float64 autograd, of each column's max
EDGE_ROWS = ("nan_opacity", "behind", "det_zero", "clamp_x", "clamp_y", "sh_negative",
             "inactive")
# The stored parameters' edge rows besides (rows 14, 16, ..): a log scale
# above 88.7 (exp gives inf), opacity logits of +inf and -inf, a zero
# quaternion (the first normalisation's 0 / 1e-12).
RAW_EDGE_ROWS = ("exp_overflow", "opa_pos_inf", "opa_neg_inf", "zero_quat")
# Activations of the stored parameters (GaussianMap's exp, norm chain and
# sigmoid) as PyTorch ops: what a step must no longer launch on the card.
ACTIVATION_OPS = ("aten::exp", "aten::sigmoid", "aten::linalg_vector_norm", "aten::norm",
                  "aten::sigmoid_backward")
# Quaternions whose norm is exact in any summation order (1, 2, 5), so K5's
# norm and PyTorch's reduction agree and the needle's det is 0 in both.
EXACT_QUATS = ((1, 1, 1, 1), (2, 1, 2, 4), (1, 2, 4, 2), (4, 2, 1, 2), (2, 4, 2, 1),
               (1, 0, 0, 0), (3, 4, 0, 0))
GROUP_FIELDS = (("xyz", "xyz"), ("dc", "dc"), ("sh_rest", "sh_rest"), ("opacity", "opacity"),
                ("log_scale", "scale"), ("quat", "quat"))   # Adam group, its gradient


def to_world(cam, pts):
    """World points of camera-frame points (n, 3): R_cw^T (p - t_cw)."""
    import torch

    R, t = cam.pose.R_cw, cam.pose.t_cw
    p = torch.as_tensor(pts, dtype=torch.float32, device=R.device) - t
    return (R.transpose(0, 1)[None] * p[:, None, :]).sum(-1)


def needle(cam, n: int = 4096, seed: int = 7, raw: bool = False):
    """(xyz, scale, quat) of a needle (one scale 1e5-1e9, two 1e-3) whose
    float32 EWA determinant is exactly 0 at camera `cam`, from n seeded
    candidates; raises if none is. With `raw`, the scale is its log and the
    determinant that of the activated parameters (preprocess.activate)."""
    import torch

    from gaussian_lic_tpu_torch.ops.preprocess import activate
    from gaussian_lic_tpu_torch.ops.projection import projection_terms

    rng = np.random.default_rng(seed)
    z = rng.uniform(3.0, 8.0, n)
    xyz = to_world(cam, np.stack([rng.uniform(-0.3, 0.3, n) * z,
                                  rng.uniform(-0.3, 0.3, n) * z, z], 1))
    f32 = dict(dtype=torch.float32, device=xyz.device)
    scale = torch.as_tensor(np.stack([10.0 ** rng.uniform(5, 9, n), np.full(n, 1e-3),
                                      np.full(n, 1e-3)], 1), **f32)
    q = np.array(EXACT_QUATS, np.float64)[rng.integers(0, len(EXACT_QUATS), n)]
    quat = torch.as_tensor(q * rng.choice([-1.0, 1.0], (n, 4)), **f32)
    if raw:
        scale = torch.log(scale)
        s_act, q_act, _ = activate(scale, quat, torch.zeros(n, **f32))
        t = projection_terms(xyz, s_act, q_act, cam)
    else:
        t = projection_terms(xyz, scale, quat, cam)
    hit = torch.nonzero((t["det"] == 0) & t["in_front"])
    if hit.numel() == 0:
        raise AssertionError("no needle of the search has a float32 det of 0")
    i = int(hit[0, 0])
    return xyz[i], scale[i], quat[i]


def with_edge_rows(inputs: dict, raw: bool = False) -> tuple:
    """A copy of preprocess inputs whose rows 0, 2, .. 12 are the edge rows:
    NaN opacity, behind the camera, det = 0, tx clamped, ty clamped, an SH
    colour below 0, inactive. With `raw` the inputs' scale and opacity are
    the stored log_scale and opa_logit, and rows 14, 16, .. are
    RAW_EDGE_ROWS besides. Returns (inputs, {edge: row})."""
    import torch

    x = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in inputs.items()}
    cam, P = x["camera"], x["xyz"].shape[0]
    if x["active"] is None:
        x["active"] = torch.ones(P, dtype=torch.bool, device=x["xyz"].device)
    names = EDGE_ROWS + (RAW_EDGE_ROWS if raw else ())
    rows = dict(zip(names, range(0, 2 * len(names), 2)))
    x["opacity"][rows["nan_opacity"]] = float("nan")
    x["xyz"][[rows["behind"], rows["clamp_x"], rows["clamp_y"]]] = to_world(
        cam, [[0.3, -0.2, -3.0], [25.0, 0.5, 5.0], [0.5, -30.0, 6.0]])
    r = rows["det_zero"]
    x["xyz"][r], x["scale"][r], x["quat"][r] = needle(cam, raw=raw)
    x["dc"][rows["sh_negative"]] = torch.tensor([-5.0, 0.2, -4.0])
    x["opacity"][rows["inactive"]] = math.log(0.8 / 0.2) if raw else 0.8
    x["active"][rows["inactive"]] = False
    if raw:
        x["scale"][rows["exp_overflow"]] = torch.tensor([89.0, -4.0, -4.0])
        x["opacity"][rows["opa_pos_inf"]] = float("inf")
        x["opacity"][rows["opa_neg_inf"]] = float("-inf")
        x["quat"][rows["zero_quat"]] = 0.0
    return x, rows


def column_errors(got, want, rows: dict, leave_out=(), per_column=False, free=()):
    """The largest error of `got` against `want`, each column relative to its
    max |want| over the scene's rows, and each edge row relative to its own
    max |want| (its values are orders of magnitude off the scene's); NaN
    must be where `want` has NaN. Edge rows in `leave_out` are not held to
    the tolerance, those in `free` not to the NaN either. With
    `per_column`, also the scene rows' error of each column."""
    import torch

    got = got.detach().double().reshape(got.shape[0], -1)
    want = want.detach().double().reshape(want.shape[0], -1)
    held = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    held[[r for name, r in rows.items() if name in free]] = False
    if not torch.equal(torch.isnan(got[held]), torch.isnan(want[held])):
        raise AssertionError("NaN where the plain version has none, or none where it has")
    got, want = got.nan_to_num(), want.nan_to_num()
    edge = torch.zeros(got.shape[0], dtype=torch.bool, device=got.device)
    edge[list(rows.values())] = True
    cols = ((got[~edge] - want[~edge]).abs().amax(0)
            / want[~edge].abs().amax(0).clamp_min(1e-30))
    err = cols.max()
    for name, r in rows.items():
        if name not in leave_out:
            err = torch.maximum(err, (got[r] - want[r]).abs().max()
                                 / want[r].abs().max().clamp_min(1e-30))
    return (float(err), cols.tolist()) if per_column else float(err)


def scene_abs_err(got, want, rows: dict) -> float:
    """max |got - want| over the rows that are not edge rows (those are held
    relative to their own magnitude by column_errors)."""
    import torch

    keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    keep[list(rows.values())] = False
    return float((got[keep].double() - want[keep].double()).abs().max())


def bit_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def same_floats(a, b) -> bool:
    """Bit for bit where either is a number; NaN where the other is NaN."""
    import torch

    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and bit_equal(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def plain_autograd(x: dict, g, dtype=None, raw: bool = False):
    """The six gradients of the plain chain (the parent's main path) for the
    rows' gradient g (P, 9), by autograd, in `dtype` (default: the inputs');
    with `raw`, of the stored parameters through the activations."""
    import torch
    import torch.nn.functional as F

    from gaussian_lic_tpu_torch.camera import Camera, CameraPose
    from gaussian_lic_tpu_torch.ops import preprocess as pre

    cam = x["camera"]
    if dtype is not None:
        cam = Camera(cam.intr, CameraPose(cam.pose.R_cw.to(dtype), cam.pose.t_cw.to(dtype)),
                     cam.full_proj.to(dtype))
    leaves = [x[k].detach().to(dtype or x[k].dtype).requires_grad_(True)
              for k in ("xyz", "scale", "quat", "opacity", "dc", "sh_rest")]
    rows = pre.preprocess_forward_plain(*leaves[:4], cam, leaves[4], leaves[5],
                                        x["sh_degree"], x["active"], raw=raw)["rows"]
    cot = F.pad(g.to(rows.dtype), (0, rows.shape[1] - g.shape[1]))
    return rows, leaves, cot, torch.autograd.grad(rows, leaves, cot, retain_graph=True)


def check_preprocess(sc: dict, tag: str, f64: bool) -> dict:
    """K5, K6 and K7 against their plain versions on scene `sc` of phase 2
    with the edge rows (with_edge_rows); with `f64`, K6 and the float32
    autograd also against a float64 autograd run of the plain chain.
    Returns each kernel's (max abs error, ms, plain ms, bound ms)."""
    import torch

    from gaussian_lic_tpu_torch.ops import adam, blend, preprocess as pre, tiles
    from gaussian_lic_tpu_torch.ops.rasterize import CHUNK
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    x, rows = with_edge_rows(sc["inputs"])
    P, deg, cam = x["xyz"].shape[0], x["sh_degree"], x["camera"]
    geo = tuple(x[k] for k in ("xyz", "scale", "quat", "opacity"))
    fargs = geo + (cam, x["dc"], x["sh_rest"], deg, x["active"])
    k5 = pre.preprocess_forward(*fargs)
    p5 = pre.preprocess_forward_plain(*fargs)
    torch.cuda.synchronize()
    e_rows, e_cols = column_errors(k5[0], p5["table"], rows, per_column=True)
    e_depth = column_errors(k5[1][:, None], p5["depth"][:, None], rows)
    d_rad = (k5[2] - p5["radius"]).abs()
    n_rad = int((d_rad > 0).sum())
    g = sc["grid"]
    kw = dict(max_tiles_per_gaussian=16, max_total_splats=sc["splats"].shape[0], align=CHUNK)
    lists = [tiles.bin_gaussians(t[:P, 0:2], d, t[:P, 2:5], x["opacity"], r, b, g, **kw)
             for t, d, r, b in ((k5[0], k5[1], k5[2], k5[3]),
                                (p5["table"], p5["depth"], p5["radius"], p5["base_active"]))]
    n_sorted = int((lists[0].sorted_gauss != lists[1].sorted_gauss).sum())
    log(f"[2c] {tag} K5: rows {e_rows:.3e} (the scene's columns "
        + " ".join(f"{e:.2e}" for e in e_cols[:blend.N_ATTR])
        + f"), depth {e_depth:.3e} of each column's max; radius "
        f"differs on {n_rad} of {P} rows (at most {float(d_rad.max()):.0f}); base_active "
        f"{'equal' if torch.equal(k5[3], p5['base_active']) else 'DIFFERS'}; sorted-list "
        f"entries that differ {n_sorted} of {lists[0].sorted_gauss.numel()}")
    if not (e_rows <= PRE_FWD_RTOL and e_depth <= PRE_FWD_RTOL
            and n_rad <= PRE_RADIUS_SHARE * P and float(d_rad.max()) <= 1.0
            and torch.equal(k5[3], p5["base_active"])):
        raise AssertionError(f"{tag}: K5 disagrees with its plain version")
    culled = [rows[k] for k in ("nan_opacity", "behind", "det_zero", "inactive")]
    if bool(k5[3][culled].any()):
        raise AssertionError(f"{tag}: a culled edge row is base_active: {k5[3][culled]}")

    # K2's per-Gaussian gradient as K2 hands it over (a (P, 9) view of a
    # 12-float table), the edge rows' set to seeded values
    table = torch.zeros((P + 1, blend.GAUSS_TABLE_STRIDE), device=k5[0].device)
    table[:P, :blend.N_ATTR] = sc["k2"]
    edge = torch.as_tensor(np.random.default_rng(9).normal(size=(len(rows), blend.N_ATTR)),
                           dtype=torch.float32, device=table.device)
    table[list(rows.values()), :blend.N_ATTR] = edge * sc["k2"].abs().amax(0)
    d_attrs = table[:P, :blend.N_ATTR]
    bargs = geo + (cam, x["dc"], x["sh_rest"], deg, d_attrs)
    k6 = pre.preprocess_backward(*bargs)
    p6 = pre.preprocess_backward_plain(*bargs)
    rows_t, leaves, cot, a6 = plain_autograd(x, d_attrs)
    torch.cuda.synchronize()
    e_k6_plain = max(column_errors(a, b, rows) for a, b in zip(k6, p6))
    e_k6_auto = max(column_errors(a, b, rows) for a, b in zip(k6, a6))
    msg = (f"[2c] {tag} K6: against the closed form {e_k6_plain:.3e}, against autograd "
           f"{e_k6_auto:.3e} of each column's max")
    worst = max(e_k6_plain, e_k6_auto)
    if f64:
        # the needle's float64 det is rounding noise (tests/test_torch_preprocess.py)
        a64 = plain_autograd(x, d_attrs, torch.float64)[3]
        e64 = [max(column_errors(a, b, rows, ("det_zero",)) for a, b in zip(got, a64))
               for got in (k6, a6)]
        msg += f"; against float64 autograd: K6 {e64[0]:.3e}, float32 autograd {e64[1]:.3e}"
        worst = max(worst, *e64)
        del a64
    log(msg)
    if not worst <= PRE_GRAD_RTOL:
        raise AssertionError(f"{tag}: K6 disagrees beyond {PRE_GRAD_RTOL}")
    variants = k6_variants(bargs, k6, tag)

    # K7 on the six groups of this scene: K6's gradients, seeded moments
    rng = np.random.default_rng(13)
    params = {name: (torch.log(x[f]) if name == "log_scale" else x[f]).contiguous()
              for name, f in GROUP_FIELDS}
    grads = dict(zip(("xyz", "log_scale", "quat", "opacity", "dc", "sh_rest"), k6))
    states = {name: adam.AdamState(
        torch.as_tensor(rng.normal(size=p.shape) * 1e-3, dtype=torch.float32, device=p.device),
        torch.as_tensor(np.abs(rng.normal(size=p.shape)) * 1e-6, dtype=torch.float32,
                        device=p.device)) for name, p in params.items()}
    visible = (k5[2] > 0) & x["active"]
    lrs = dict(xyz=1.6e-4, dc=2.5e-3, sh_rest=1.25e-4, opacity=0.05, log_scale=5e-3, quat=1e-3)
    k7 = adam.sparse_adam_update_groups(params, grads, states, visible, lrs)

    def plain7():
        out = {n: adam.sparse_adam_update(params[n], grads[n], states[n], visible, lrs[n])
               for n in params}
        return {n: o[0] for n, o in out.items()}, {n: o[1] for n, o in out.items()}

    p7 = plain7()
    same = all(bit_equal(k7[0][n], p7[0][n]) and bit_equal(k7[1][n].exp_avg, p7[1][n].exp_avg)
               and bit_equal(k7[1][n].exp_avg_sq, p7[1][n].exp_avg_sq) for n in params)
    log(f"[2c] {tag} K7: {'bit for bit' if same else 'DIFFERS from'} the plain loop "
        f"({int(visible.sum())} of {P} rows visible)")
    if not same:
        raise AssertionError(f"{tag}: K7 differs from the plain loop")
    in_place = adam_in_place(params, grads, states, visible, lrs, k7, P, tag)
    if P >= 1 << 20:   # the train step: also as the stream's map, 1.1M live in 2,097,152 rows
        wide = adam_at_rows(params, grads, states, visible, lrs, STREAM_ROWS, STREAM_LIVE, tag)
        in_place.update({f"{k}_2m": v for k, v in wide.items()})

    nbytes = preprocess_bytes(P, x["sh_rest"].shape[1])
    res = {
        "preprocess_forward": (
            max(scene_abs_err(k5[0][:P], p5["table"][:P], rows),
                scene_abs_err(k5[1], p5["depth"], rows)),
            cuda_ms(lambda: pre.preprocess_forward(*fargs), 20),
            cuda_ms(lambda: pre.preprocess_forward_plain(*fargs), 20), nbytes["forward"]),
        "preprocess_backward": (
            max(scene_abs_err(a, b, rows) for a, b in zip(k6, a6)),
            cuda_ms(lambda: pre.preprocess_backward(*bargs), 20),
            cuda_ms(lambda: torch.autograd.grad(rows_t, leaves, cot, retain_graph=True), 20),
            nbytes["backward"]),
        "sparse_adam": (
            0.0, cuda_ms(lambda: adam.sparse_adam_update_groups(params, grads, states,
                                                                visible, lrs), 20),
            cuda_ms(plain7, 20), nbytes["adam"]),
    }
    for k, (_, tk, tp, nb) in res.items():
        log(f"[2c] {tag} time {k}: kernel {tk:.4f} ms  plain {tp:.4f} ms  bound "
            f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes)")
    base = variants["base"]
    log(f"[2c] {tag} K6 variants: " + "  ".join(
        f"{v} {ms:.4f} ms ({ms - base:+.4f})" for v, ms in variants.items())
        + f"; K6 itself {res['preprocess_backward'][1]:.4f} ms")
    res["sparse_adam_in_place"] = in_place
    return res


STREAM_ROWS, STREAM_LIVE = 2_097_152, 1_100_000   # fastlivo.stream's map


def adam_in_place(params, grads, states, visible, lrs, want, live: int, tag: str) -> dict:
    """K7's in-place form (`sparse_adam_update_groups_`, the bundles' step)
    on copies of the groups, the first `live` rows below the count: the
    visible rows bit for bit the out-of-place `want`, every other row's bits
    kept. Then both forms timed in CUDA graphs in turns (in place, out of
    place, out of place, in place; 20 calls each), and the in-place form's
    bound: 28 B an element of the visible rows and a mask byte a row below
    the count."""
    import torch

    from gaussian_lic_tpu_torch.ops import adam

    count = torch.tensor(live, dtype=torch.int32, device=visible.device)
    p2 = {n: t.clone() for n, t in params.items()}
    s2 = {n: adam.AdamState(st.exp_avg.clone(), st.exp_avg_sq.clone())
          for n, st in states.items()}
    adam.sparse_adam_update_groups_(p2, grads, s2, visible, lrs, count=count)
    hidden = ~visible
    same = all(bit_equal(a[visible], w[visible]) and bit_equal(a[hidden], b[hidden])
               for n in params
               for a, w, b in ((p2[n], want[0][n], params[n]),
                               (s2[n].exp_avg, want[1][n].exp_avg, states[n].exp_avg),
                               (s2[n].exp_avg_sq, want[1][n].exp_avg_sq, states[n].exp_avg_sq)))
    P, vis = visible.shape[0], int(visible.sum())
    log(f"[2c] {tag} K7 in place: {'bit for bit' if same else 'DIFFERS from'} the out-of-place "
        f"form on the {vis} visible rows, the other rows {'kept' if same else 'or CHANGED'} "
        f"({live} live of {P} rows)")
    if not same:
        raise AssertionError(f"{tag}: K7 in place differs")
    forms = {"in_place": lambda: adam.sparse_adam_update_groups_(p2, grads, s2, visible, lrs,
                                                                 count=count),
             "out_of_place": lambda: adam.sparse_adam_update_groups(params, grads, states,
                                                                    visible, lrs)}
    ms = {k: [] for k in forms}
    for k in ("in_place", "out_of_place", "out_of_place", "in_place"):
        ms[k].append(graph_ms(forms[k]))
    floats = sum(t.numel() for t in params.values()) // P
    nbytes = vis * 28 * floats + live
    out = dict(in_place_ms=sum(ms["in_place"]) / 2, out_of_place_ms=sum(ms["out_of_place"]) / 2,
               in_place_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, visible_rows=vis,
               live_rows=live, rows=P)
    log(f"[2c] {tag} K7 time in CUDA graphs, in turns: in place {ms['in_place']} ms, out of "
        f"place {ms['out_of_place']} ms; in-place bound {out['in_place_bound_ms']:.4f} ms "
        f"({nbytes} bytes: the visible rows), "
        f"{out['in_place_bound_ms'] / out['in_place_ms']:.1%} of it")
    return out


def adam_at_rows(params, grads, states, visible, lrs, rows: int, live: int, tag: str) -> dict:
    """`adam_in_place` on the groups tiled to `rows` rows, the visible mask
    tiled alike and cleared at and past `live` (a map of `live` Gaussians in
    the rows the engine's doubling leaves)."""
    from gaussian_lic_tpu_torch.ops import adam

    reps = -(-rows // visible.shape[0])

    def tile(t):
        return t.repeat((reps,) + (1,) * (t.dim() - 1))[:rows].contiguous()

    p2, g2 = {n: tile(t) for n, t in params.items()}, {n: tile(t) for n, t in grads.items()}
    s2 = {n: adam.AdamState(tile(st.exp_avg), tile(st.exp_avg_sq)) for n, st in states.items()}
    v2 = tile(visible)
    v2[live:] = False
    want = adam.sparse_adam_update_groups(p2, g2, s2, v2, lrs)
    return adam_in_place(p2, g2, s2, v2, lrs, want, live, f"{tag} at {rows} rows")


def parent_activation_backward(quat, saved, d_act):
    """The gradients of the stored (log_scale, quat, opa_logit) for the
    activated values' gradients d_act = (d scale, d rotation, d opacity),
    from what autograd saves of the forward, saved = (exp(log_scale), |quat|,
    |quat| + 1e-12, sigmoid(opa_logit)): autograd's ops for exp, the
    division, the norm and sigmoid, one by one, as the parent's step ran
    them after K6 (timed beside K6's fold)."""
    import torch

    s, n, D, o = saved
    d_s, d_r, d_o = d_act
    d_q = d_r / D
    d_q += (-d_r * ((quat / D) / D)).sum(-1, keepdim=True) * (quat / n).masked_fill_(n == 0, 0)
    return d_s * s, d_q, torch.ops.aten.sigmoid_backward(d_o, o)


def check_preprocess_raw(sc: dict, tag: str, f64: bool) -> dict:
    """K5 and K6 from the stored parameters (log_scale, quat, opa_logit: the
    main path's form) on scene `sc` with the edge rows of
    with_edge_rows(raw=True). K5 bit for bit against the plain chain with the
    activations (table, depth, radius, base_active and the activated
    opacity), the lists binned from both equal; K6 against the closed form,
    autograd of the plain chain and, with `f64`, float64 autograd, within
    PRE_GRAD_RTOL of each column's max, with each output's ulps against the
    float32 autograd printed. Then each timed in CUDA graphs (20 calls) in
    turns beside the parent's path: the activations as PyTorch ops, then K5
    in activated form; K6 in activated form, then the activations' backward
    as autograd runs it (parent_activation_backward). Returns each kernel's
    (max abs error, ms, plain ms, bytes, the parent's ms)."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend, preprocess as pre, tiles
    from gaussian_lic_tpu_torch.ops.rasterize import CHUNK
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    x, rows = with_edge_rows(dict(sc["inputs"], **sc["stored"]), raw=True)
    P, deg, cam = x["xyz"].shape[0], x["sh_degree"], x["camera"]
    stored = tuple(x[k] for k in ("scale", "quat", "opacity"))
    geo = (x["xyz"],) + stored
    fargs = geo + (cam, x["dc"], x["sh_rest"], deg, x["active"])
    k5 = pre.preprocess_forward(*fargs, raw=True)
    p5 = pre.preprocess_forward_plain(*fargs, raw=True)
    torch.cuda.synchronize()
    names = ("table", "depth", "radius", "base_active", "opacity")
    same = {k: (torch.equal(a, p5[k]) if k == "base_active" else same_floats(a, p5[k]))
            for k, a in zip(names, k5)}
    g = sc["grid"]
    kw = dict(max_tiles_per_gaussian=16, max_total_splats=sc["splats"].shape[0], align=CHUNK)
    lists = [tiles.bin_gaussians(t[:P, 0:2], d, t[:P, 2:5], o, r, b, g, **kw)
             for t, d, r, b, o in (k5, tuple(p5[k] for k in names))]
    n_sorted = int((lists[0].sorted_gauss != lists[1].sorted_gauss).sum())
    log(f"[2c] {tag} K5 from the stored parameters: bit for bit with the plain chain and "
        f"its activations: {same}; sorted-list entries that differ {n_sorted} of "
        f"{lists[0].sorted_gauss.numel()}; edge rows {rows}")
    if not all(same.values()) or n_sorted:
        raise AssertionError(f"{tag}: K5 from the stored parameters differs from its plain "
                             "version")
    culled = [rows[k] for k in ("nan_opacity", "behind", "det_zero", "inactive",
                                "opa_neg_inf")]
    if bool(k5[3][culled].any()):
        raise AssertionError(f"{tag}: a culled edge row is base_active: {k5[3][culled]}")

    table = torch.zeros((P + 1, blend.GAUSS_TABLE_STRIDE), device=k5[0].device)
    table[:P, :blend.N_ATTR] = sc["k2"]
    edge = torch.as_tensor(np.random.default_rng(9).normal(size=(len(rows), blend.N_ATTR)),
                           dtype=torch.float32, device=table.device)
    table[list(rows.values()), :blend.N_ATTR] = edge * sc["k2"].abs().amax(0)
    d_attrs = table[:P, :blend.N_ATTR]
    bargs = geo + (cam, x["dc"], x["sh_rest"], deg, d_attrs)
    k6 = pre.preprocess_backward(*bargs, raw=True)
    p6 = pre.preprocess_backward_plain(*bargs, raw=True)
    rows_t, leaves, cot, a6 = plain_autograd(x, d_attrs, raw=True)
    torch.cuda.synchronize()
    e_k6_plain = max(column_errors(a, b, rows) for a, b in zip(k6, p6))
    e_k6_auto = max(column_errors(a, b, rows) for a, b in zip(k6, a6))
    scene = torch.ones(P, dtype=torch.bool, device=d_attrs.device)
    scene[list(rows.values())] = False
    outs = ("xyz", "log_scale", "quat", "opa_logit", "dc", "sh_rest")
    apart = "; ".join(f"{k} " + ("bit for bit" if same_floats(a, b) else
                                 "{} ulps at most, median {}".format(*ulp_spread(a[scene],
                                                                                b[scene])))
                      for k, a, b in zip(outs, k6, a6))
    msg = (f"[2c] {tag} K6 from the stored parameters: against the closed form "
           f"{e_k6_plain:.3e}, against autograd {e_k6_auto:.3e} of each column's max; "
           f"against float32 autograd, the scene's rows: {apart}")
    worst = max(e_k6_plain, e_k6_auto)
    if f64:
        # float64 resolves neither the needle's det nor exp(89) as float32 does
        a64 = plain_autograd(x, d_attrs, torch.float64, raw=True)[3]
        free = ("det_zero", "exp_overflow")
        e64 = [max(column_errors(a, b, rows, free, free=free) for a, b in zip(got, a64))
               for got in (k6, a6)]
        msg += f"; against float64 autograd: K6 {e64[0]:.3e}, float32 autograd {e64[1]:.3e}"
        worst = max(worst, *e64)
        del a64
    log(msg)
    if not worst <= PRE_GRAD_RTOL:
        raise AssertionError(f"{tag}: K6 from the stored parameters disagrees beyond "
                             f"{PRE_GRAD_RTOL}")
    variants = k6_variants(bargs, k6, tag, raw=True)

    # the parent's path: the activations as ops, K5 / K6 on the activated
    # values, the activations' backward as autograd's ops
    acts = pre.activate(*stored)
    n = torch.linalg.norm(x["quat"], dim=-1, keepdim=True)
    saved = (acts[0], n, n + 1e-12, acts[2])
    a_bargs = (x["xyz"],) + acts + bargs[4:]

    def parent_k5():
        pre.preprocess_forward(x["xyz"], *pre.activate(*stored), *fargs[4:])

    def parent_k6():
        d = pre.preprocess_backward(*a_bargs)
        parent_activation_backward(x["quat"], saved, d[1:4])

    turns = in_turns({"K5": lambda: pre.preprocess_forward(*fargs, raw=True),
                      "parent K5": parent_k5,
                      "K6": lambda: pre.preprocess_backward(*bargs, raw=True),
                      "parent K6": parent_k6})
    log(f"[2c] {tag} in CUDA graphs (20 calls) in turns, ms: " + "  ".join(
        f"{k} {' '.join(f'{v:.4f}' for v in ms)}" for k, ms in turns.items()))
    nbytes = preprocess_bytes(P, x["sh_rest"].shape[1])
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    res = {
        "preprocess_forward": (
            max(scene_abs_err(k5[0][:P], p5["table"][:P], rows),
                scene_abs_err(k5[1], p5["depth"], rows)),
            mean["K5"], cuda_ms(lambda: pre.preprocess_forward_plain(*fargs, raw=True), 20),
            nbytes["forward_raw"], mean["parent K5"]),
        "preprocess_backward": (
            max(scene_abs_err(a, b, rows) for a, b in zip(k6, a6)),
            mean["K6"],
            cuda_ms(lambda: torch.autograd.grad(rows_t, leaves, cot, retain_graph=True), 20),
            nbytes["backward_raw"], mean["parent K6"]),
    }
    for k, (_, tk, tp, nb, tpar) in res.items():
        log(f"[2c] {tag} time {k} from the stored parameters: kernel {tk:.4f} ms  the "
            f"parent's path {tpar:.4f} ms  plain {tp:.4f} ms  bound "
            f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms ({nb} bytes)")
    base = variants["base"]
    log(f"[2c] {tag} K6 variants from the stored parameters: " + "  ".join(
        f"{v} {ms:.4f} ms ({ms - base:+.4f})" for v, ms in variants.items()))
    return res


def k6_variants(bargs, k6, tag: str, raw: bool = False) -> dict:
    """K6's timing variants (preprocess.K6_VARIANTS) on K6's arguments
    `bargs` (of the stored parameters with `raw`): base and direct must equal
    K6's outputs `k6` bit for bit (the others are timing only); logs the
    rows whose nine gradients are not all zero. Returns each variant's ms
    (20 launches)."""
    import torch

    from gaussian_lic_tpu_torch.ops import preprocess as pre
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    d_attrs = bargs[-1]
    live = int((d_attrs != 0).any(1).sum())
    log(f"[2c] {tag}: {live} of {d_attrs.shape[0]} rows have a nonzero row gradient")
    out = {}
    for v in pre.K6_VARIANTS:
        got = pre.preprocess_backward_probe(v, *bargs, raw=raw)
        torch.cuda.synchronize()
        if v not in pre.K6_TIMING_ONLY and not all(bit_equal(a, b) for a, b in zip(got, k6)):
            raise AssertionError(f"{tag}: K6 variant {v} differs from K6")
        del got
        out[v] = cuda_ms(lambda: pre.preprocess_backward_probe(v, *bargs, raw=raw), 20)
    return out


def preprocess_bytes(P: int, S: int) -> dict:
    """Bytes K5, K6 and K7 must move for P Gaussians of S SH rest
    coefficients: each input read once, each output written once. K5 reads
    xyz, scale, quat, opacity, dc, sh_rest and the active flag and writes the
    16-float row, depth, radius and base_active (and the zero row); K6 reads
    the nine row gradients and the inputs but opacity and writes the six
    gradients; K7 reads p, g, m, v and writes p', m', v' of 14 + 3 S floats
    a row, and reads the mask. From the stored parameters (`*_raw`), K5 also
    writes the activated opacity and K6 also reads the opacity logit."""
    inputs = 4 * (3 + 3 + 4 + 1 + 3 + 3 * S)
    fwd = P * (inputs + 1 + 4 * 16 + 4 + 4 + 1) + 4 * 16
    bwd = P * (4 * 9 + (inputs - 4) + inputs)
    return dict(forward=fwd, backward=bwd, forward_raw=fwd + 4 * P, backward_raw=bwd + 4 * P,
                adam=P * (4 * 7 * (14 + 3 * S) + 1))


def phase_preprocess(scenes) -> list:
    """K6's SASS beside its probe's base (both input forms), then K5, K6
    (and its variants) and K7 on phase 2's 20k scene (K6 also against
    float64 autograd) and on the 1M train step's inputs, from activated
    values and from the stored parameters; the kernels line's rows, with
    the train step's times and bounds (K5 and K6: from the stored
    parameters, the main path's form, beside the parent's path)."""
    from gaussian_lic_tpu_torch import _build

    check_base_is_production(_build.load().path, K6_BASE, "2c")
    light, step = ({**check_preprocess(sc, f"{sc['n_gauss']}-Gaussian {what}", f64),
                    **check_preprocess_raw(sc, f"{sc['n_gauss']}-Gaussian {what}", f64)}
                   for sc, what, f64 in ((scenes[0], "scene", True),
                                         (scenes[1], "train step", False)))
    src = "gaussian_lic_tpu_torch/csrc/"
    chain = ("gaussian_lic_tpu/models/gaussians.py:84-94 + ops/projection.py:77 + "
             "ops/sh.py:47 + ops/rasterize.py:78")
    rows = [("preprocess_forward", "preprocess_forward.cu", chain),
            ("preprocess_backward", "preprocess_backward.cu", "autodiff of " + chain),
            ("sparse_adam", "sparse_adam.cu", "gaussian_lic_tpu/ops/adam.py:40")]
    out = []
    for name, cu, replaces in rows:
        err, ms, plain_ms, nb, *parent = step[name]
        out.append(dict(name=name, route="cuda", source=src + cu, replaces=replaces,
                        counter=name, max_abs_err=max(err, light[name][0]), ms=ms,
                        plain_ms=plain_ms, bound_ms=nb / HBM_BYTES_PER_S * 1e3,
                        bound_by="bytes", library_ms=None))
        if parent:
            out[-1]["parent_ms"] = parent[0]
        if name == "sparse_adam":
            out[-1].update(step["sparse_adam_in_place"])
        log(f"[2c] {name}: {ms:.4f} ms against a bound of {out[-1]['bound_ms']:.4f} ms "
            f"(bytes), plain {plain_ms:.4f} ms"
            + (f", the parent's path {parent[0]:.4f} ms" if parent else ""))
    return out


# ---------------------------------------------------------------------------
# phase 2d: the binning kernels K8, K9, K10
# ---------------------------------------------------------------------------

BINNING = ("bin_keys", "bin_ranges", "gather_splats")
# K13, one per K8 wherever the binning is bin_gaussians': all but the sharded
# step, whose list merged from the ranks keeps torch.sort
LIVE_SORT = "sort_live"
# K8's operations per slot whose power it evaluates (live, in the rect and
# in the band), counted from csrc/bin_keys.cu: 70 FP32 operations of the
# tile's pixel rect and max_contrib_power, and two IEEE divisions of ~8 FP32
# and one MUFU reciprocal each.
K8_SLOT_FP32 = 86
K8_SLOT_MUFU = 2


K8_BLOCK = 256             # csrc/bin_keys.cuh kThreads: Gaussians a block
K8_CHUNK = 8               # csrc/bin_keys.cuh kChunk: slots a pass of the listed design


def evaluated_mask(xy, radius, live, grid, K, band=None):
    """(K, P) bool: the slots whose power K8 evaluates, live, in the rect
    and, with `band` (ty0, n_ty), in the band."""
    import torch

    from gaussian_lic_tpu_torch.ops import tiles

    rminx, rminy, rmaxx, rmaxy = tiles.gaussian_rects(xy, radius, grid)
    w = rmaxx - rminx
    k = torch.arange(K, dtype=torch.int32, device=xy.device)[:, None]
    ok = live[None] & (k < (w * (rmaxy - rminy))[None])
    if band is not None:
        ty = rminy[None] + torch.div(k, w.clamp_min(1)[None], rounding_mode="floor")
        ok &= (ty >= band[0]) & (ty < band[0] + band[1])
    return ok


def evaluated_slots(xy, radius, live, grid, K, band=None) -> int:
    """The number of slots whose power K8 evaluates (evaluated_mask)."""
    return int(evaluated_mask(xy, radius, live, grid, K, band).sum())


def k8_warp_slots(ok) -> dict:
    """From the (K, P) mask of the slots K8 evaluates (evaluated_mask): the
    evaluated slots; `serial`, the warp-slots in which the first design runs
    the power's body (32 Gaussians a warp, slot k wherever one of its lanes
    evaluates it); `listed`, the warp passes of the listed design (each
    block's evaluated pairs of each K8_CHUNK slots, 32 to a pass); and the
    warp-slots of the first design in all (`warps`)."""
    import torch

    K, P = ok.shape
    pad = -P % K8_BLOCK
    m = torch.cat([ok, ok.new_zeros((K, pad))], 1)
    listed = 0
    for chunk in torch.split(m, K8_CHUNK, 0):
        n = chunk.reshape(chunk.shape[0], -1, K8_BLOCK).sum((0, 2))
        listed += int(((n + 31) // 32).sum())
    return dict(evaluated=int(ok.sum()), serial=int(m.reshape(K, -1, 32).any(2).sum()),
                listed=listed, warps=K * (-(-P // 32)))


def binning_bytes(P: int, K: int, m_eff: int, m_pad: int, T: int, rows: int,
                  live: int) -> dict:
    """Bytes K8, K13, K9 and K10 must move: each input read once, each
    output written once. K8 reads a Gaussian's mean and conic (20 B), depth,
    opacity, radius and its flag (13 B) and writes K keys and its count;
    K13 reads the P K keys once and, for the `live` pairs (4-B key, 4-B
    slot), reads and writes 8 B a pair in each of its 4 radix passes; K9
    reads m_eff 4-B keys and 4-B slots and writes m_pad ids, T starts and
    lengths and P counts; K10 reads m_pad ids and the `rows` distinct rows
    they name (64 B each) and writes m_pad rows."""
    return dict(bin_keys=P * (33 + 4 * K + 4) + 8,
                sort_live=4 * P * K + 4 * 16 * live,
                bin_ranges=m_eff * 8 + m_pad * 4 + 8 * T + 4 * P,
                gather_splats=m_pad * 4 + rows * 64 + m_pad * 64)


def graph_ms(fn, reps: int = 20) -> float:
    """Mean ms of `fn()` over `reps` calls captured in one CUDA graph, as
    the bundles run them (after one call outside the capture that loads its
    kernels), between two CUDA events around a replay: device time without
    the host's gaps between eager launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.collect()      # no dead graph may be freed inside the capture (BundleGraphs._capture)
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    finally:
        gc.enable()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def in_turns(calls: dict, turns: int = 2) -> dict:
    """Each of `calls` timed with graph_ms, in turns: the calls in order,
    then in the reverse order, `turns` times. Returns each call's ms, one
    reading a turn."""
    names = list(calls)
    ms = {k: [] for k in names}
    for t in range(turns):
        for k in names if t % 2 == 0 else names[::-1]:
            ms[k].append(graph_ms(calls[k]))
    return ms


def k8_variants(args, grid, K: int, bits: int, kw: dict, want, tag: str) -> dict:
    """K8's timing variants (tiles.K8_VARIANTS) on K8's arguments: those that
    compute K8's outputs must equal `want`, K8's outputs, bit for bit; then
    every variant is timed beside the others in turns (in_turns). Returns
    each variant's ms."""
    import torch

    from gaussian_lic_tpu_torch.ops import tiles

    for v in tiles.K8_VARIANTS:
        got = tiles.bin_keys_probe(v, *args, grid, K, bits, **kw)
        torch.cuda.synchronize()
        if v not in tiles.K8_TIMING_ONLY and not all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{tag}: K8 variant {v} differs from K8")
    ms = in_turns({v: functools.partial(tiles.bin_keys_probe, v, *args, grid, K, bits, **kw)
                   for v in tiles.K8_VARIANTS})
    log(f"[2d] {tag} K8 variants in turns (ms, 20 calls in a CUDA graph; all but "
        f"{', '.join(tiles.K8_TIMING_ONLY)} bit for bit K8): "
        + "  ".join(f"{v} " + "/".join(f"{t:.4f}" for t in ms[v]) for v in ms))
    return ms


def k9_variants(list_args, k8, m_eff: int, cut: int, tag: str) -> dict:
    """K9's timing variants (tiles.K9_VARIANTS) on the sorted list
    `list_args` (sorted keys, slots, m_pad's align, P, T, depth bits) with
    K8's outputs `k8` (keys, touched, sums): those that compute K9's outputs
    must equal its plain version bit for bit at m_eff and at the budget cut
    `cut`; then every variant is timed at m_eff beside K9 (the wrapper) in
    turns (in_turns). Returns each variant's ms."""
    import torch

    from gaussian_lic_tpu_torch.ops import tiles

    sk, ss, align, P, T, bits = list_args
    kw = dict(slot_keys=k8[0], touched=k8[1], sums=k8[2])
    for m in (m_eff, cut):
        mp = -(-m // align) * align
        want = tiles.bin_ranges_plain(sk, ss, m, mp, P, T, bits)
        for v in tiles.K9_VARIANTS:
            if v in tiles.K9_TIMING_ONLY:
                continue
            got = tiles.bin_ranges_probe(v, sk, ss, m, mp, P, T, bits, **kw)
            torch.cuda.synchronize()
            if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{tag}: K9 variant {v} differs from K9's plain version "
                                     f"at {m} entries")
    mp = -(-m_eff // align) * align
    calls = {"K9": lambda: tiles.bin_ranges(sk, ss, m_eff, mp, P, T, bits, **kw)}
    calls.update({v: functools.partial(tiles.bin_ranges_probe, v, sk, ss, m_eff, mp, P, T, bits,
                                       **kw) for v in tiles.K9_VARIANTS})
    ms = in_turns(calls)
    log(f"[2d] {tag} K9 variants in turns at {m_eff} entries (ms, 20 calls in a CUDA graph, "
        f"each with its own fills; all but {', '.join(tiles.K9_TIMING_ONLY)} bit for bit K9's "
        f"plain version at {m_eff} and {cut} entries): "
        + "  ".join(f"{v} " + "/".join(f"{t:.4f}" for t in ms[v]) for v in ms))
    return ms


def kernel_resources(lib_path: str, names, phase: str) -> None:
    """Registers, stack, spills and shared memory of every built kernel whose
    name holds one of `names` (cuobjdump --dump-resource-usage)."""
    import re
    import subprocess

    from gaussian_lic_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-resource-usage", lib_path], capture_output=True,
                         text=True, check=True).stdout
    seen = set()
    for name, res in re.findall(r"Function (\S+):\n\s*(REG:.*)", out):
        if any(k in name for k in names) and name not in seen:
            seen.add(name)
            log(f"[{phase}] resources {name}: {res.strip()}")


def check_binning(sc: dict, rates: dict, tag: str) -> dict:
    """K8, K9 and K10 against their plain versions on scene `sc` of phase 2
    with phase 2c's edge rows, through K5 as the main path runs it: K8 with
    global tile ids (the sharded binning); K8, K9 on the stable sort of its
    keys and K10 on K9's list in the whole grid's band (bin_gaussians; also
    at half its live entries, a budget cut) and in every band of D = 2, 4
    and 8 with the whole grid's depth bits (render_band), K9 with K8's
    outputs (bin_gaussians' call) and without (the sharded path's merged
    list), and K9's variants (k9_variants). Every output bit
    for bit, and K10 against `index_select`. Each timed beside its plain version, K10
    also beside `index_select`, 20 calls in a CUDA graph (graph_ms, the
    rows' times: the bundles run binning in graphs) and eagerly (cuda_ms,
    host gaps included), and the sort on K8's keys as int64 and as int32 in
    turns. Returns each kernel's (max abs error, ms, plain ms, bound ms,
    bound by, library ms)."""
    import torch

    from gaussian_lic_tpu_torch.ops import preprocess as pre, tiles
    from gaussian_lic_tpu_torch.ops.rasterize import CHUNK
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    x, _ = with_edge_rows(sc["inputs"])
    P = x["xyz"].shape[0]
    table, depth, radius, active, _ = pre.preprocess_forward(
        *(x[k] for k in ("xyz", "scale", "quat", "opacity", "camera", "dc", "sh_rest",
                         "sh_degree", "active")))
    args = (table[:P, 0:2], depth, table[:P, 2:5], x["opacity"], radius, active)
    g, K, M = sc["grid"], sc["bin_kw"]["max_tiles_per_gaussian"], sc["bin_kw"]["max_total_splats"]
    bits, T = tiles.rank_bits_for(g.num_tiles), g.num_tiles
    m_eff = min(M, P * K)
    m_pad = -(-m_eff // CHUNK) * CHUNK

    def check(what: str, got, want) -> None:
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{tag}: {what} differs from its plain version")

    got = tiles.bin_keys(*args, g, K, bits)
    check("K8 with global tile ids", got, tiles.bin_keys_plain(*args, g, K, bits))
    log(f"[2d] {tag} K8 with global tile ids (the sharded binning): bit for bit its plain "
        f"version ({int(got[2][1])} live slots, {int(got[2][0])} rect tiles truncated)")
    # the grid (bin_gaussians), then every band of D with the grid's depth
    # bits (render_band); in the grid also at a budget cut
    for D, b in [(1, 0)] + [(D, b) for D in BAND_MESHES for b in range(D)]:
        n_ty = g.n_ty // D
        kw = dict(band_ty0=b * n_ty, band_n_ty=n_ty)
        k8 = tiles.bin_keys(*args, g, K, bits, **kw)
        check(f"K8 in band {b} of {D}", k8, tiles.bin_keys_plain(*args, g, K, bits, **kw))
        sk, ss = torch.sort(k8[0], stable=True)
        ss = ss.to(torch.int32)   # K9's slot ids
        num_valid = int(k8[2][1])
        # K13: the first num_valid entries of the whole sort, and its count
        live = tiles.sort_live_slots(k8[0])
        check(f"K13 in band {b} of {D}", (live[0][:num_valid], live[1][:num_valid], live[2]),
              (sk[:num_valid], ss[:num_valid], k8[2][1]))
        for m in (m_eff, max(num_valid // 2, 1)) if D == 1 else (m_eff,):
            mp = -(-m // CHUNK) * CHUNK
            want = tiles.bin_ranges_plain(sk, ss, m, mp, P, n_ty * g.n_tx, bits)
            # the merged list of the sharded path: no K8 outputs, a histogram
            check(f"K9 without K8's outputs in band {b} of {D} at {m} entries",
                  tiles.bin_ranges(sk, ss, m, mp, P, n_ty * g.n_tx, bits), want)
            k9 = tiles.bin_ranges(sk, ss, m, mp, P, n_ty * g.n_tx, bits, slot_keys=k8[0],
                                  touched=k8[1], sums=k8[2])
            check(f"K9 in band {b} of {D} at {m} entries", k9, want)
            check(f"K10 in band {b} of {D} at {m} entries", (tiles.gather_splats(table, k9[0]),),
                  (tiles.gather_splats_plain(table, k9[0]),))
            # K9 on K13's list (bin_gaussians' call): entries past num_valid read as dead
            check(f"K9 on K13's list in band {b} of {D} at {m} entries",
                  tiles.bin_ranges(live[0], live[1], m, mp, P, n_ty * g.n_tx, bits,
                                   slot_keys=k8[0], touched=k8[1], sums=k8[2]), want)
            if D == 1:
                log(f"[2d] {tag} K8, K13, K9 and K10 in the grid at {m} entries ({num_valid} live "
                    f"slots, {int(k8[2][0])} rect tiles truncated, {int((k9[2] == 0).sum())} "
                    f"of {T} tiles empty): bit for bit their plain versions")
        if D == 1:   # the main path's list: timed below
            keys, sk_main, ss_main, k8_main = k8[0], sk, ss, k8
    live = active & (radius > 0)
    dk = tiles.depth_key(depth, bits)
    dargs = (args[0], None, args[2], args[3], args[4], live)
    check("K8 from depth keys (compute_slot_keys_kmajor)",
          tiles.bin_keys(*dargs, g, K, bits, dkey=dk),
          tiles.bin_keys_plain(*dargs, g, K, bits, dkey=dk))
    sk, ss = sk_main, ss_main
    k8kw = dict(slot_keys=k8_main[0], touched=k8_main[1], sums=k8_main[2])
    ids = tiles.bin_ranges(sk, ss, m_eff, m_pad, P, T, bits, **k8kw)[0]
    if not torch.equal(tiles.gather_splats(table, ids), table.index_select(0, ids)):
        raise AssertionError(f"{tag}: K10 differs from index_select")
    log(f"[2d] {tag} K8, K13, K9 and K10 in every band of D = "
        f"{', '.join(map(str, BAND_MESHES))} (the grid's depth bits) and K8 from depth keys: "
        f"bit for bit their plain versions; K10 equals index_select")
    grid_band = dict(band_ty0=0, band_n_ty=g.n_ty)
    variants = k8_variants(args, g, K, bits, grid_band, tiles.bin_keys(*args, g, K, bits,
                                                                       **grid_band), tag)
    k9_ms = k9_variants((sk, ss, CHUNK, P, T, bits), k8_main, m_eff,
                        max(int(k8_main[2][1]) // 2, 1), tag)

    calls = {   # kernel, plain version, library call
        "bin_keys": (lambda: tiles.bin_keys(*args, g, K, bits, **grid_band),
                     lambda: tiles.bin_keys_plain(*args, g, K, bits, **grid_band), None),
        "bin_ranges": (lambda: tiles.bin_ranges(sk, ss, m_eff, m_pad, P, T, bits, **k8kw),
                       lambda: tiles.bin_ranges_plain(sk, ss, m_eff, m_pad, P, T, bits), None),
        "gather_splats": (lambda: tiles.gather_splats(table, ids),
                          lambda: tiles.gather_splats_plain(table, ids),
                          lambda: table.index_select(0, ids)),
        # the plain version reads its count back (nonzero): eager only
        "sort_live": (lambda: tiles.sort_live_slots(keys), None,
                      lambda: torch.sort(keys, stable=True)),
    }
    ms, eager = {}, {}
    for k, fns in calls.items():
        ms[k] = tuple(None if f is None else graph_ms(f) for f in fns)
        eager[k] = tuple(None if f is None else cuda_ms(f, 20) for f in fns)
    plain_sort = cuda_ms(lambda: tiles.sort_live_slots_plain(keys), 20)
    ms["sort_live"] = (ms["sort_live"][0], plain_sort, ms["sort_live"][2])
    eager["sort_live"] = (eager["sort_live"][0], plain_sort, eager["sort_live"][2])
    keys64 = tiles.keys_from_int32(keys)
    sort_ms = [graph_ms(f) for f in (
        lambda: torch.sort(keys64, stable=True), lambda: torch.sort(keys, stable=True),
        lambda: tiles.sort_live_slots(keys), lambda: tiles.sort_live_slots(keys),
        lambda: torch.sort(keys, stable=True), lambda: torch.sort(keys64, stable=True))]
    n_live = int(k8_main[2][1])
    log(f"[2d] {tag} stable sort of {keys.numel()} keys ({n_live} live, "
        f"{n_live / keys.numel():.4%} of the slots), 20 calls in a CUDA graph, in turns "
        f"torch.sort int64, int32, K13, K13, torch.sort int32, int64: "
        + " ".join(f"{v:.4f}" for v in sort_ms) + " ms")
    nbytes = binning_bytes(P, K, m_eff, m_pad, T, int(torch.unique(ids).numel()), n_live)
    ws = k8_warp_slots(evaluated_mask(args[0], radius, live, g, K, (0, g.n_ty)))
    slots = ws["evaluated"]
    ops_ms = max(slots * K8_SLOT_FP32 / (rates["sms"] * FP32_LANES_PER_SM * rates["hz"]),
                 slots * K8_SLOT_MUFU / (rates["sms"] * MUFU_LANES_PER_SM * rates["hz"])) * 1e3
    res = {}
    for k, (tk, tp, lib) in ms.items():
        b_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
        by = "bytes"
        if k == "bin_keys" and ops_ms > b_ms:
            b_ms, by = ops_ms, "operations"
        res[k] = (0.0, tk, tp, b_ms, by, lib)
        ek, ep, el = eager[k]
        log(f"[2d] {tag} time {k}, in a CUDA graph (eager): kernel {tk:.4f} ({ek:.4f}) ms  "
            f"plain {tp:.4f} ({ep:.4f}) ms"
            + ("" if lib is None else f"  {'torch.sort' if k == 'sort_live' else 'index_select'}"
                                      f" {lib:.4f} ({el:.4f}) ms")
            + f"  bound {b_ms:.4f} ms ({by}; {nbytes[k]} bytes"
            + (f", {slots} evaluated slots: {ops_ms:.4f} ms of operations" if k == "bin_keys"
               else "") + ")"
            + (f"; with K8's touched read ({4 * P} B more) "
               f"{b_ms + 4 * P / HBM_BYTES_PER_S * 1e3:.4f} ms" if k == "bin_ranges" else ""))
    log(f"[2d] {tag} K8's {slots} evaluated slots: the first design runs the power's body in "
        f"{ws['serial']} of {ws['warps']} warp-slots ({slots / max(32 * ws['serial'], 1):.1%} "
        f"of their lanes busy), the listed design in {ws['listed']} warp passes "
        f"({slots / max(32 * ws['listed'], 1):.1%})")
    res["sort_ms"] = sort_ms
    res["variants"], res["warp_slots"], res["k9_variants"] = variants, ws, k9_ms
    return res


def phase_binning(scenes, rates: dict) -> list:
    """K8, K9 and K10 on phase 2's 20k scene and on the 1M train step's
    inputs (check_binning); the kernels line's rows, with the train step's
    times and bounds."""
    from gaussian_lic_tpu_torch import _build

    check_base_is_production(_build.load().path, K8_BASE + K9_BASE, "2d")
    kernel_resources(_build.load().path, ("bin_keys_kernel", "bin_ranges", "radix_"), "2d")
    light = check_binning(scenes[0], rates, f"{scenes[0]['n_gauss']}-Gaussian scene")
    step = check_binning(scenes[1], rates, f"{scenes[1]['n_gauss']}-Gaussian train step")
    src = "gaussian_lic_tpu_torch/csrc/"
    rows = [("bin_keys", "gaussian_lic_tpu/ops/tiles.py:181"),
            ("sort_live", "gaussian_lic_tpu/ops/tiles.py:325"),
            ("bin_ranges", "gaussian_lic_tpu/ops/tiles.py:327"),
            ("gather_splats", "gaussian_lic_tpu/ops/rasterize.py:116")]
    out = []
    for name, replaces in rows:
        err, ms, plain_ms, b_ms, by, lib = step[name]
        out.append(dict(name=name, route="cuda", source=src + name + ".cu", replaces=replaces,
                        counter=name, max_abs_err=max(err, light[name][0]), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=lib))
        log(f"[2d] {name}: {ms:.4f} ms against a bound of {b_ms:.4f} ms ({by}), plain "
            f"{plain_ms:.4f} ms" + ("" if lib is None else
                                    f", {'torch.sort' if name == 'sort_live' else 'index_select'}"
                                    f" {lib:.4f} ms"))
    return out


def check_binning_launches(launches: dict, tag: str, sharded: bool = False) -> None:
    """One K8, one K9 and one K10 per render: each as many launches as K1
    (color and no_color together), and at least one; and one K13 per K8
    unless the sharded step bins (`sharded`)."""
    renders = launches["forward"] + launches["forward_no_color"]
    if renders <= 0 or any(launches[k] != renders for k in BINNING):
        raise AssertionError(f"{tag}: not one K8, K9 and K10 launch per render ({renders} "
                             f"K1 launches): {launches}")
    if not sharded and launches[LIVE_SORT] != launches["bin_keys"]:
        raise AssertionError(f"{tag}: not one K13 launch per K8: {launches}")


# ---------------------------------------------------------------------------
# phase 2e: the loss kernels K11, K12
# ---------------------------------------------------------------------------

SSIM = ("ssim_forward", "ssim_backward")
SSIM_SUM_RTOL = 1e-6       # K11's two sums vs the plain chain's (another summation order)
# K12 vs float32 autograd of the plain chain, of the gradient's max: the
# closed form and autograd round apart, ~2.5e-6 on the CPU tests' inputs
# (tests/test_torch_ssim.py). Against float64 autograd K12 must be as close
# as float32 autograd is, within SSIM_F64_FACTOR, or within SSIM_GRAD_RTOL:
# both lose digits where sigma^2 = blur(x^2) - mu^2 cancels (2.4e-5 of the
# max for both on the 20k scene's render, on an H100).
SSIM_GRAD_RTOL = 1e-5
SSIM_F64_FACTOR = 2.0
SSIM_SHAPES = ((3, 24, 40), (3, 37, 53), (3, 1, 40), (3, 7, 9))   # the CPU tests'
# Operations per pixel, counted from csrc/ssim_forward.cu and
# ssim_backward.cu (an IEEE division as 8 FP32 operations and one MUFU
# reciprocal): K11 per window pixel, 5 quantities x 2 passes x (11 multiplies
# + 10 adds), the 3 products, the map (16 and a division), |x - y| and the two
# sums (3), the partial maps (17 and three divisions); K12 per pixel, 3 maps x
# 2 passes x 21 and the combination (8).
K11_PIXEL_FP32 = 272
K11_PIXEL_MUFU = 4
K12_PIXEL_FP32 = 134


def ssim_bytes(C: int, H: int, W: int, rows: int) -> dict:
    """Bytes K11 and K12 must move on a (C, H, W) image with a window of
    `rows` rows: K11 reads the image and its target and writes the three
    partial maps of the window and its sums; K12 reads both images, the
    partial maps and the two incoming gradients, and writes d img."""
    img, win = C * H * W * 4, C * rows * W * 4
    return dict(ssim_forward=2 * img + 3 * win + 8, ssim_backward=3 * img + 3 * win + 8)


def ssim_bounds(rates: dict, C: int, H: int, W: int, rows: int) -> dict:
    """(bound ms, bound by, bytes ms, operations ms, bytes) of K11 (with its
    partial maps) and K12: the bound is the larger of the bytes over the
    memory rate and the operations over their pipe's rate."""
    lanes = rates["sms"] * rates["hz"]
    nbytes = ssim_bytes(C, H, W, rows)
    ops = dict(ssim_forward=max(C * rows * W * K11_PIXEL_FP32 / (lanes * FP32_LANES_PER_SM),
                                C * rows * W * K11_PIXEL_MUFU / (lanes * MUFU_LANES_PER_SM)),
               ssim_backward=C * H * W * K12_PIXEL_FP32 / (lanes * FP32_LANES_PER_SM))
    out = {}
    for k in SSIM:
        b, o = nbytes[k] / HBM_BYTES_PER_S * 1e3, ops[k] * 1e3
        out[k] = (max(b, o), "bytes" if b >= o else "operations", b, o, nbytes[k])
    return out


def ulps(a, b) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (0 where they are equal, signs of zero alike)."""
    import torch

    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def ulp_spread(a, b) -> tuple:
    """(the largest, the median) distance of two float32 tensors in units in
    the last place, over their entries."""
    import torch

    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = (ia - ib).abs().flatten()
    return (int(d.max()), int(d.median())) if d.numel() else (0, 0)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def check_ssim(x, y, r0: int, r1: int, n_pixels: int, tag: str, f64: bool = False,
               lam: float = 0.2) -> dict:
    """K11 and K12 on (x, y) with the window [r0, r1) against their plain
    versions: the partial maps and K12 bit for bit (the same rounded
    operations in order), the sums within SSIM_SUM_RTOL; K12 against
    autograd of the plain chain (training_loss or training_loss_band_part)
    within SSIM_GRAD_RTOL of the gradient's max, with `f64` also against a
    float64 autograd run (as close as float32 autograd, SSIM_F64_FACTOR).
    Returns the errors."""
    import torch

    from gaussian_lic_tpu_torch.ops import losses

    sums, maps = losses.ssim_forward(x, y, r0, r1)
    p_sums, p_maps = losses.ssim_forward_plain(x, y, r0, r1)
    nomaps = losses.ssim_forward(x, y, r0, r1, partials=False)[0]
    g = torch.tensor([-lam / n_pixels, (1.0 - lam) / n_pixels], device=x.device)
    d = losses.ssim_backward(x, y, maps, g, r0, r1)
    p_d = losses.ssim_backward_plain(x, y, p_maps, g, r0, r1)
    whole = r0 == 0 and r1 == x.shape[1]

    def plain_grad(dtype):
        xr = x.detach().to(dtype, copy=True).requires_grad_(True)
        loss = (losses.training_loss_plain(xr, y.to(dtype), lam) if whole else
                losses.training_loss_band_part_plain(xr, y.to(dtype), n_pixels, lam))
        return torch.autograd.grad(loss, xr)[0]

    for v in losses.K11_VARIANTS:   # the variants that compute K11's outputs
        if v in losses.K11_TIMING_ONLY:
            continue
        v_sums, v_maps = losses.ssim_forward_probe(v, x, y, r0, r1)
        v_rel = float(((v_sums.double() - p_sums.double()).abs()
                       / p_sums.double().abs().clamp_min(1e-30)).max())
        if ulps(v_maps, p_maps) or v_rel > SSIM_SUM_RTOL:
            raise AssertionError(f"{tag}: K11 variant {v} disagrees with the plain version "
                                 f"({ulps(v_maps, p_maps)} ulps, sums rel {v_rel:.3e})")
    for v in losses.K12_VARIANTS:   # the variants that compute K12's d
        if v in losses.K12_TIMING_ONLY:
            continue
        v_ulps = ulps(losses.ssim_backward_probe(v, x, y, maps, g, r0, r1), p_d)
        if v_ulps:
            raise AssertionError(f"{tag}: K12 variant {v} disagrees with the plain version "
                                 f"({v_ulps} ulps)")
    res = dict(map_ulps=ulps(maps, p_maps), d_ulps=ulps(d, p_d),
               sum_rel=float(((sums.double() - p_sums.double()).abs()
                              / p_sums.double().abs().clamp_min(1e-30)).max()),
               sum_abs=float((sums.double() - p_sums.double()).abs().max() / n_pixels),
               map_abs=float((maps - p_maps).abs().max()) if maps.numel() else 0.0,
               d_abs=float((d - p_d).abs().max()),
               autograd=rel_err(d, plain_grad(torch.float32)))
    f64_tol = 0.0
    if f64:
        g64 = plain_grad(torch.float64)
        res["autograd64"] = rel_err(d, g64)
        res["autograd32_64"] = rel_err(plain_grad(torch.float32), g64)
        f64_tol = max(SSIM_GRAD_RTOL, SSIM_F64_FACTOR * res["autograd32_64"])
    if (res["map_ulps"] or res["d_ulps"] or not torch.equal(nomaps, sums)
            or res["sum_rel"] > SSIM_SUM_RTOL or res["autograd"] > SSIM_GRAD_RTOL
            or res.get("autograd64", 0.0) > f64_tol):
        raise AssertionError(f"{tag}: K11/K12 disagree with their plain versions: {res}")
    return res


def library_blur(x, groups: int):
    """The library call for the blurs: a separable depthwise F.conv2d pair
    (11 x 1, then 1 x 11, zero padding) over `groups` channels."""
    import torch
    import torch.nn.functional as F

    from gaussian_lic_tpu_torch.ops.losses import _TAPS

    taps = torch.tensor(_TAPS, device=x.device)
    wv = taps.view(1, 1, 11, 1).expand(groups, 1, 11, 1).contiguous()
    wh = taps.view(1, 1, 1, 11).expand(groups, 1, 1, 11).contiguous()
    return lambda: F.conv2d(F.conv2d(x, wv, padding=(5, 0), groups=groups), wh,
                            padding=(0, 5), groups=groups)


def time_ssim(x, y, lam: float = 0.2) -> dict:
    """K11 and K12 on (x, y), the whole image, each 20 calls in a CUDA graph
    (graph_ms) beside its plain version, the plain chain's forward and
    autograd backward (the path before the kernels; its backward is the
    graph of forward + backward less the forward's), and the library's
    blurs (a depthwise F.conv2d pair, TF32 off: 15 channels for K11's five
    quantities, 9 for K12's three maps). Returns ms by name."""
    import torch

    from gaussian_lic_tpu_torch.ops import losses

    n = x.numel()
    g = torch.tensor([-lam / n, (1.0 - lam) / n], device=x.device)
    _, maps = losses.ssim_forward(x, y)
    xr = x.clone().requires_grad_(True)
    C, H, W = x.shape
    five = torch.cat([x, y, x * x, y * y, x * y])[None]
    three = maps.reshape(1, 3 * C, H, W)
    fns = dict(
        k11=lambda: losses.ssim_forward(x, y),
        k11_eval=lambda: losses.ssim_forward(x, y, partials=False),
        k11_plain=lambda: losses.ssim_forward_plain(x, y),
        k12=lambda: losses.ssim_backward(x, y, maps, g),
        k12_plain=lambda: losses.ssim_backward_plain(x, y, maps, g),
        chain_fwd=lambda: losses.training_loss_plain(x, y, lam),
        chain_fwd_bwd=lambda: torch.autograd.grad(losses.training_loss_plain(xr, y, lam), xr),
        k11_k12=lambda: torch.autograd.grad(losses.training_loss(xr, y, lam), xr),
        lib15=library_blur(five, 5 * C), lib9=library_blur(three, 3 * C))
    ms = {k: graph_ms(f) for k, f in fns.items()}
    ms["chain_bwd"] = ms["chain_fwd_bwd"] - ms["chain_fwd"]
    return ms


def k11_variants(x, y, tag: str) -> dict:
    """K11's timing variants (losses.K11_VARIANTS) on (x, y), the whole
    image with partial maps, timed beside each other in turns (in_turns);
    check_ssim holds the ones that compute K11's outputs. Returns each
    variant's ms."""
    from gaussian_lic_tpu_torch.ops import losses

    ms = in_turns({v: functools.partial(losses.ssim_forward_probe, v, x, y)
                   for v in losses.K11_VARIANTS})
    log(f"[2e] {tag} K11 variants in turns (ms, 20 calls in a CUDA graph; all but "
        f"{', '.join(losses.K11_TIMING_ONLY)} give K11's partial maps bit for bit): "
        + "  ".join(f"{v} " + "/".join(f"{t:.4f}" for t in ms[v]) for v in ms))
    return ms


def k12_variants(x, y, tag: str, lam: float = 0.2) -> dict:
    """K12's timing variants (losses.K12_VARIANTS) on (x, y), the whole
    image with K11's partial maps, timed beside K12 (the wrapper) and each
    other in turns (in_turns); check_ssim holds the ones that compute K12's
    d. Returns each variant's ms."""
    import torch

    from gaussian_lic_tpu_torch.ops import losses

    n = x.numel()
    g = torch.tensor([-lam / n, (1.0 - lam) / n], device=x.device)
    maps = losses.ssim_forward(x, y)[1]
    calls = {"K12": lambda: losses.ssim_backward(x, y, maps, g)}
    calls.update({v: functools.partial(losses.ssim_backward_probe, v, x, y, maps, g)
                  for v in losses.K12_VARIANTS})
    ms = in_turns(calls)
    log(f"[2e] {tag} K12 variants in turns (ms, 20 calls in a CUDA graph; all but "
        f"{', '.join(losses.K12_TIMING_ONLY)} give K12's d bit for bit): "
        + "  ".join(f"{v} " + "/".join(f"{t:.4f}" for t in ms[v]) for v in ms))
    return ms


def ssim_inputs(sc: dict, gt=None, seed: int = 3):
    """(image, target) of scene `sc` on the card: K1's render at the scene's
    size and `gt`, or a smooth-ish seeded target made from the render (as
    tests/test_torch_ssim.py's images)."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend

    g = sc["grid"]
    color = blend.blend_forward(sc["splats"], sc["starts"], sc["lens"], n_tx=g.n_tx,
                                n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)[0]
    img = color[:, :g.height, :g.width].contiguous()
    if gt is None:
        rng = np.random.default_rng(seed)
        noise = torch.as_tensor(rng.normal(size=tuple(img.shape)).astype(np.float32),
                                device=img.device)
        gt = (img * 0.7 + 0.2 + noise * 0.02).clamp(0.0, 1.0)
    return img, gt.contiguous()


def phase_ssim(scenes, rates: dict) -> list:
    """K11 and K12 on phase 2's two inputs (the 20k scene's render against a
    seeded target, with float64 autograd; the 1M train step's render
    against its keyframe's image), the whole image and every band of D = 2,
    4 and 8 with its halo rows, and on the CPU tests' shapes (check_ssim);
    then timed on the train step's image (time_ssim). Returns the kernels
    line's rows."""
    import torch
    import torch.nn.functional as F

    from gaussian_lic_tpu_torch.ops import losses

    from gaussian_lic_tpu_torch import _build

    check_base_is_production(_build.load().path, K11_BASE + K12_BASE, "2e")
    kernel_resources(_build.load().path, ("ssim_forward", "ssim_backward"), "2e")
    h = losses.HALO
    worst = {k: 0.0 for k in ("map_abs", "sum_abs", "d_abs", "autograd", "autograd64")}

    def checked(res: dict) -> dict:
        for k in worst:
            worst[k] = max(worst[k], res.get(k, 0.0))
        return res

    for sc, gt, f64 in ((scenes[0], None, True), (scenes[1], scenes[1]["gt"], False)):
        tag = f"{sc['n_gauss']}-Gaussian " + ("scene" if f64 else "train step")
        x, y = ssim_inputs(sc, gt)
        C, H, W = x.shape
        res = checked(check_ssim(x, y, 0, H, x.numel(), tag, f64=f64))
        log(f"[2e] {tag} {C}x{H}x{W}: K11's partial maps and K12 bit for bit their plain "
            f"versions ({res['map_ulps']} and {res['d_ulps']} ulps); sums rel "
            f"{res['sum_rel']:.3e} (tolerance {SSIM_SUM_RTOL}); K12 vs autograd of the plain "
            f"chain {res['autograd']:.3e} of the max"
            + (f", vs float64 autograd {res['autograd64']:.3e} (float32 autograd itself "
               f"{res['autograd32_64']:.3e}; tolerance the larger of {SSIM_F64_FACTOR} x that "
               f"and {SSIM_GRAD_RTOL})" if f64 else "")
            + f" (tolerance {SSIM_GRAD_RTOL})")
        xp, yp = F.pad(x, (0, 0, h, h)), F.pad(y, (0, 0, h, h))
        band_err = 0.0
        for D in BAND_MESHES:
            hb = H // D
            for b in range(D):
                ext = [t[:, b * hb:(b + 1) * hb + 2 * h] for t in (xp, yp)]
                res = checked(check_ssim(*ext, h, h + hb, x.numel(), f"{tag} band {b} of {D}"))
                band_err = max(band_err, res["autograd"])
        log(f"[2e] {tag}: every band of D = {', '.join(map(str, BAND_MESHES))} with its halo "
            f"rows (strided views): bit for bit; K12 vs autograd of the band part at most "
            f"{band_err:.3e} of the max")
    for shape in SSIM_SHAPES:
        rng = np.random.default_rng(sum(shape))
        a = rng.uniform(size=shape).astype(np.float32)
        b = np.clip(a * 0.7 + 0.2 + rng.normal(size=shape).astype(np.float32) * 0.02, 0, 1)
        x, y = (torch.as_tensor(v, device=scenes[1]["gt"].device) for v in (a, b))
        checked(check_ssim(x, y, 0, shape[1], x.numel(), f"{shape}", f64=True))
    log(f"[2e] the CPU tests' shapes {', '.join('x'.join(map(str, s)) for s in SSIM_SHAPES)}: "
        f"bit for bit, within tolerance; worst over phase 2e {json.dumps(worst)}")

    x, y = ssim_inputs(scenes[1], scenes[1]["gt"])
    C, H, W = x.shape
    k11_variants(x, y, f"{scenes[1]['n_gauss']}-Gaussian train step {C}x{H}x{W}")
    k12_variants(x, y, f"{scenes[1]['n_gauss']}-Gaussian train step {C}x{H}x{W}")
    ms = time_ssim(x, y)
    b = ssim_bounds(rates, C, H, W, H)
    log(f"[2e] time at {C}x{H}x{W}, 20 calls in a CUDA graph: K11 {ms['k11']:.4f} ms "
        f"(without partial maps, eval's {ms['k11_eval']:.4f}), plain {ms['k11_plain']:.4f}, "
        f"F.conv2d blurs (15 ch) {ms['lib15']:.4f}; K12 {ms['k12']:.4f} ms, plain "
        f"{ms['k12_plain']:.4f}, F.conv2d blurs (9 ch) {ms['lib9']:.4f}; loss + gradient "
        f"through K11 + K12 {ms['k11_k12']:.4f} ms against the plain chain's forward "
        f"{ms['chain_fwd']:.4f} + autograd backward {ms['chain_bwd']:.4f} = "
        f"{ms['chain_fwd_bwd']:.4f} ms")
    src = "gaussian_lic_tpu_torch/csrc/"
    rows = [("ssim_forward", "gaussian_lic_tpu/ops/losses.py:45", "k11", "k11_plain", "lib15",
             max(worst["map_abs"], worst["sum_abs"])),
            ("ssim_backward", "gaussian_lic_tpu/ops/losses.py:91", "k12", "k12_plain", "lib9",
             worst["d_abs"])]
    out = []
    for name, replaces, k, kp, lib, err in rows:
        b_ms, by, bytes_ms, ops_ms, nbytes = b[name]
        out.append(dict(name=name, route="cuda", source=src + name + ".cu", replaces=replaces,
                        counter=name, max_abs_err=err, ms=ms[k], plain_ms=ms[kp],
                        bound_ms=b_ms, bound_by=by, library_ms=ms[lib]))
        log(f"[2e] {name}: {ms[k]:.4f} ms against a bound of {b_ms:.4f} ms ({by}; bytes "
            f"{bytes_ms:.4f} ms for {nbytes} B, operations {ops_ms:.4f} ms), plain "
            f"{ms[kp]:.4f} ms, F.conv2d {ms[lib]:.4f} ms")
    return out


def check_loss_launches(launches: dict, tag: str) -> None:
    """One K11 and one K12 per train step: as many launches as K7's (one a
    step), and at least one."""
    steps = launches["sparse_adam"]
    if steps <= 0 or any(launches[k] != steps for k in SSIM):
        raise AssertionError(f"{tag}: not one K11 and one K12 launch per step ({steps} K7 "
                             f"launches): {launches}")


# ---------------------------------------------------------------------------
# phase 2b: the blend probes K3/K4
# ---------------------------------------------------------------------------

def check_probe_forward(tag, v, against, out, ref, tol, ties) -> float:
    """Max abs error of K3 variant `v`'s outputs against `ref` (named
    `against`), outside the pixels that `ties()` names (asked for only when
    some pixel disagrees; None: no pixel is excused); raises beyond `tol` or
    on an n_contrib mismatch outside them."""
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
    excused = ties() if ties is not None and bool(bad.any()) else torch.zeros_like(bad)
    err = float(px_err[~excused].max())
    log(f"[2b] {tag} K3 {v} vs {against}: max|d image|,|d final_T| {err:.3e}  n_contrib mismatches "
        f"{int(nc_bad.sum())} (tie pixels excused {int(excused.sum())})")
    if bool((bad & ~excused).any()):
        raise AssertionError(f"{tag}: K3 {v} disagrees with {against} beyond {tol} at "
                             f"{int((bad & ~excused).sum())} pixels"
                             + (" that are not ties" if ties is not None else ""))
    return err


def check_probe_backward(tag, v, against, out, ref, tol) -> float:
    """Max abs error of K4 variant `v`'s grads against `ref` (named
    `against`); raises beyond `tol` relative to each column's max (nored:
    to the max of `ref`)."""
    out, ref = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    d = (out - ref).abs()
    err = float(d.max())
    if v == "nored":
        rels = [err / max(float(ref.abs().max()), 1e-30)]
    else:
        rels = (d.amax(0) / ref.abs().amax(0).clamp_min(1e-30)).tolist()
    log(f"[2b] {tag} K4 {v} vs {against}: max|d grad| {err:.3e}  relative to "
        + ("max " if v == "nored" else "each column's max ") + " ".join(f"{r:.2e}" for r in rels))
    if not max(rels) <= tol:
        raise AssertionError(f"{tag}: K4 {v} disagrees with {against} beyond {tol} relative")
    return err


def compare_probes(sc: dict, tag: str, full: bool) -> dict:
    """Every K3/K4 variant on scene `sc` of phase 2. The variants that
    compute K1's outputs are held bit for bit against phase 2's K1 output,
    those that compute K2's per column against K2's plain per-Gaussian output
    (base also against K2's); with `full`, every variant is also held against
    its plain version, and otherwise only the others run their plain
    version, once (the rest take phase 2's plain time). Returns
    {(direction, variant): (max abs err, ms, plain ms)}; logs each
    variant's time and the mean entries its walk visited per tile."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    args = (sc["splats"], sc["starts"], sc["lens"])
    walked = torch.zeros(g.n_tx * g.n_ty, dtype=torch.int32, device=sc["splats"].device)
    res, mean_walked = {}, {}
    for v in bp.FORWARD_VARIANTS:
        plain = functools.partial(bp.probe_forward_plain, v)
        out = bp.probe_forward(v, *args, walked=walked, **kw)
        mean_walked[("forward", v)] = float(walked.double().mean())
        errs, plain_ms = [], sc["times"]["forward"][2]
        if full or v not in FWD_K1_NUMERICS:
            ref, plain_ms = timed(lambda: plain(*args, **kw))
            errs.append(check_probe_forward(tag, v, "plain", out, ref, IMG_ATOL,
                                            lambda: tie_pixels(plain, sc, kw)))
            del ref
        if v in FWD_K1_NUMERICS:
            errs.append(check_probe_forward(tag, v, "K1", out, sc["k1"], K1_ATOL, None))
        res[("forward", v)] = (max(errs), cuda_ms(lambda: bp.probe_forward(v, *args, **kw), 20),
                               plain_ms)
        del out

    bargs = args + sc["k2_in"] + (sc["sorted_gauss"],)   # phase 2's dL/dpix, final_T, n_contrib
    gkw = dict(kw, n_gauss=sc["n_gauss"])
    for v in bp.BACKWARD_VARIANTS:
        out = bp.probe_backward(v, *bargs, walked=walked, **gkw)
        mean_walked[("backward", v)] = float(walked.double().mean())
        errs, plain_ms = [], sc["times"]["backward"][2]
        if full or v not in BWD_K2_NUMERICS:
            ref, plain_ms = timed(lambda: bp.probe_backward_plain(v, *bargs, **gkw))
            errs.append(check_probe_backward(tag, v, "plain", out, ref,
                                             NORED_RTOL if v == "nored" else GRAD_RTOL))
            del ref
        if v in BWD_K2_NUMERICS:
            errs.append(check_probe_backward(tag, v, "K2 plain", out, sc["k2_plain"], GRAD_RTOL))
        if v == "base":
            errs.append(check_probe_backward(tag, v, "K2", out, sc["k2"], GRAD_RTOL))
        res[("backward", v)] = (max(errs),
                                cuda_ms(lambda: bp.probe_backward(v, *bargs, **gkw), 20), plain_ms)
        del out
    for (d, v), (_, tk, tp) in res.items():
        log(f"[2b] {tag} time {d} {v}: kernel {tk:.4f} ms (vs base "
            f"{tk - res[(d, 'base')][1]:+.4f})  plain {tp:.4f} ms  walked/tile "
            f"{mean_walked[(d, v)]:.1f}")
    return res


def sass_opcodes(sass: str, kernel: str) -> list:
    """The opcode sequence of every SASS function whose name holds `kernel`."""
    import re

    out = []
    for part in sass.split("Function : ")[1:]:
        if kernel in part.split("\n", 1)[0]:
            out.append([t.split()[0] for t in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([^;]*);",
                                                         part) if t.strip()])
    return out


BLEND_BASES = (("K1 / K3 base", "blend_forward_kernelILi0E"),
               ("K2 / K4 base", "blend_backward_kernelILi0E"))
K6_BASE = (("K6 / K6 probe base, from the stored parameters",
            "preprocess_backward_kernelILi0ELb1E"),
           ("K6 / K6 probe base, from activated values", "preprocess_backward_kernelILi0ELb0E"))
K8_BASE = (("K8 / K8 probe base", "bin_keys_kernelILi0E"),)
K9_BASE = (("K9 / K9 probe base", "bin_ranges_kernelILi0E"),)
K12_BASE = (("K12 / K12 probe base", "ssim_backward_kernelILi0E"),)
K11_BASE = (("K11 / K11 probe base", "ssim_forward_kernelILi0ELb1E"),
            ("K11 without partial maps / its probe base", "ssim_forward_kernelILi0ELb0E"))


def check_base_is_production(lib_path: str, pairs=BLEND_BASES, phase: str = "2b") -> None:
    """K1 and K3 base are one template instantiation (kFwdBase of
    blend_forward.cuh) built in two sources, K2 and K4 base likewise, K6
    and its probe's base (K6_BASE, kK6Base of preprocess_backward.cuh), K8
    and K11 and their probes' bases (K8_BASE, K11_BASE: kK8Base of
    bin_keys.cuh, kK11Base of ssim_forward.cuh):
    the built SASS of each pair must hold the same opcodes in the same
    order."""
    sass = built_sass(lib_path)
    for name, kernel in pairs:
        bodies = sass_opcodes(sass, kernel)
        same = len(bodies) == 2 and bodies[0] == bodies[1]
        log(f"[{phase}] SASS of {name}: {len(bodies)} functions of "
            f"{' / '.join(str(len(b)) for b in bodies)} instructions, identical opcodes {same}")
        if not same:
            raise AssertionError(f"{name}: the probe's base is not the production kernel's code")


def load_tool(name: str):
    """tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_probes(state: dict, scenes, iters: int = 3) -> list:
    """K3/K4 against K1/K2 and their plain versions on phase 2's scenes,
    base's SASS beside K1's and K2's, then the probes' own path: the two
    probe tools' run() on the probe scene, between a reset and a read of the
    probe launch counters."""
    from gaussian_lic_tpu_torch import _build
    from gaussian_lic_tpu_torch.ops import blend_probe as bp
    from gaussian_lic_tpu_torch.utils.synthetic import probe_scene

    check_base_is_production(_build.load().path)
    light_sc, step_sc = scenes
    light = compare_probes(light_sc, f"{light_sc['n_gauss']}-Gaussian scene", full=True)
    step = compare_probes(step_sc, f"{state['n']}-Gaussian train step", full=False)
    log(f"[2b] K4 nocull (K2's walk without the cull) {step[('backward', 'nocull')][1]:.4f} ms "
        f"against K2 {step_sc['times']['backward'][1]:.4f} ms at the train step")

    sc = probe_scene(state["cfg"], state["intr"], state["gm"], state["kf"])
    tools = load_tool("probe_torch_kernel"), load_tool("probe_torch_bwd")
    bp.reset_launches()
    tools[0].run(sc, iters, log=lambda s: log(f"[2b] probe path: {s}"))
    tools[1].run(sc, iters, log=lambda s: log(f"[2b] probe path: {s}"))
    launches = dict(bp.LAUNCHES)
    log(f"[2b] launches in the probe path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a probe variant never launched on the probe path: {launches}")

    pairs = step_sc["pairs"]
    g = step_sc["grid"]
    const = bp.noattr_list(step_sc["splats"])
    pairs["noattr"] = blend_pairs(const, step_sc["starts"], step_sc["lens"], g)
    pairs["noexp"] = blend_pairs(step_sc["splats"], step_sc["starts"], step_sc["lens"], g,
                                 exp=bp._noexp)
    del const
    log(f"[2b] train step pairs: noattr {pairs['noattr']}, noexp {pairs['noexp']}")
    # (pairs, cost, tested pairs) of each probe's work
    work = {("forward", "noexp"): ("noexp", "noexp", "forward"),
            ("forward", "noattr"): ("noattr", "forward", "forward"),
            ("forward", "noblend"): ("base", "noblend", "all")}
    src = "gaussian_lic_tpu_torch/csrc/"
    rows = []
    for d, variants, cu, replaces in (
            ("forward", bp.FORWARD_VARIANTS, "blend_probe_forward.cu", "tools/probe_kernel.py:235"),
            ("backward", bp.BACKWARD_VARIANTS, "blend_probe_backward.cu", "tools/probe_bwd.py:354")):
        for v in variants:
            key = (d, v)
            which, cost, tested = work.get(key, ("base", d, d))
            output = "image" if d == "forward" else ("bands" if v == "noatomic" else "gauss")
            b = bounds(state["rates"], blend_bytes(step_sc, output), pairs[which], cost,
                       tested)
            rows.append(dict(name=f"probe_{d}_{v}", route="cuda", source=src + cu,
                             replaces=replaces, launches=launches[f"{d}_{v}"],
                             max_abs_err=max(light[key][0], step[key][0]),
                             ms=step[key][1], plain_ms=step[key][2], **b, library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def run_engine(cfg, frames, dev, verbose: bool, mesh=None):
    from gaussian_lic_tpu_torch.engine.trainer import MappingEngine

    eng = MappingEngine(cfg, device=dev, mesh=mesh)
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


def engine_train_psnr(eng) -> float:
    """Mean PSNR of the engine's map over its keyframes (phase 3's quality)."""
    import torch

    from gaussian_lic_tpu_torch.ops import losses
    from gaussian_lic_tpu_torch.ops.rasterize import _splat_budget_for, render_map

    cfg = eng.cfg
    psnrs = []
    with torch.no_grad():
        for i in range(eng.kf_count):
            out = render_map(eng.gm, eng.train_camera(i), tile_h=cfg.tile_h,
                             tile_w=cfg.tile_w,
                             max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                             max_total_splats=_splat_budget_for(eng.gm.capacity, cfg))
            gt = eng.kf_buffer.images[i].float() / 255.0
            psnrs.append(float(losses.psnr(out.image.clamp(0.0, 1.0), gt)))
    return float(np.mean(psnrs))


def phase_slice(dev, kernels: list, n_points: int = 50000, n_frames: int = 40,
                points_per_frame: int = 5000) -> dict:
    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.config import Params, load_params
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

    reset_launches()
    eng, rows = run_engine(cfg, frames, dev, verbose=True)
    launches = kernel_launches()
    log(f"[3] launches in the stream: {launches}")
    log(f"[3] bundles: compiles {eng.timers.compiles}; {graph_line(eng.graphs)}")

    kf_losses = [r[2] for r in rows]
    if not all(math.isfinite(v) for v in kf_losses):
        raise AssertionError(f"non-finite keyframe loss: {kf_losses}")
    if not kf_losses[-1] < kf_losses[0]:
        raise AssertionError(f"loss did not fall: {kf_losses[0]} -> {kf_losses[-1]}")
    for k in kernels:
        k["launches"] = launches[k["counter"]]
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on the main path")
    check_binning_launches(launches, "phase 3")
    check_loss_launches(launches, "phase 3")

    train_psnr = engine_train_psnr(eng)
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
    return dict(train_psnr=train_psnr, keyframes=rows, launches=launches, frames=frames,
                cfg=cfg)


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


BUNDLE_STEPS = 100         # a keyframe's steps: 64 + 16 + 16 + 4 at the shipped sizes
# The bundles' 100-step losses against the eager runs': K2's atomics sum in
# a new order each run, so two eager runs differ in the last bits and drift
# apart over the steps (sparse Adam is sign-like on noise gradients): 3.2e-5
# relative between two eager runs at 1M on an H100. Every bundle loss must
# lie within SPREAD_FACTOR x the two eager runs' gap of both (a gap of 2
# samples is a loose estimate of the spread), or within LOSS_RTOL_FLOOR
# relative; a bundle that lost a step or its state is off by far more.
SPREAD_FACTOR = 3.0
LOSS_RTOL_FLOOR = 2e-4


def graph_line(g) -> str:
    """Captures (k: seconds), the graph pool's bytes and the warm-up
    launches of a BundleGraphs (an engine's is `eng.graphs`)."""
    caps = ", ".join(f"{k}: {sec:.3f} s" for k, sec, _ in g.captures)
    return (f"captures [{caps}], pool {g.pool_bytes / 2**20:.1f} MiB, warm-up launches "
            f"{g.warmup_launches}")


def activation_ops(fn) -> dict:
    """The ops of ACTIVATION_OPS that `fn()` runs, with their counts (the
    profiler's op list of the call, the autograd engine's threads included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.name in ACTIVATION_OPS:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def bundle_turns(dev, card: str, tag: str, what: str, step, make_bundle, graphs, gm0, opt0,
                 kf, sizes, steps: int, sharded: bool = False) -> dict:
    """`steps` steps of `step` from (gm0, opt0), eagerly one by one and as
    the bundles `make_bundle(k)` of `sizes` (CUDA graphs in `graphs`), in
    turns (eager, bundle, bundle, eager) after an untimed pass that
    captures the graphs. Each turn starts from the same state and keyframe
    ids; its window ends in synchronize() and the loss's host fetch. The
    bundles' losses must lie within the eager runs' spread, every turn must
    launch one K1, K5, K6, K7, K8, K9, K10, K11 and K12 a step, and the
    bundles' launches must equal the eager loop's. One eager step (what the
    bundles capture) must run none of the activations as ops of their own
    (ACTIVATION_OPS: K5 and K6 apply them and their backward). Unless the
    step is the sharded one (`sharded`), it must also launch one K13 a step."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    idxs = torch.as_tensor(np.random.default_rng(5).integers(0, kf.images.shape[0], steps),
                           device=dev)
    bundles = {k: make_bundle(k) for k in set(sizes)}

    def eager():
        gm, opt, m = gm0, opt0, None
        for i in range(steps):
            gm, opt, m = step(gm, opt, kf, idxs[i], i + 1)
        return m

    def bundled():
        gm, opt, m, pos = gm0, opt0, None, 0
        for k in sizes:
            gm, opt, m = bundles[k](gm, opt, kf, idxs[pos:pos + k], pos + 1)
            pos += k
        return m

    def turn(fn) -> dict:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        m = fn()
        torch.cuda.synchronize()
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        return dict(ms=dt / steps * 1e3, loss=loss, launches=kernel_launches(),
                    peak=torch.cuda.max_memory_allocated(dev),
                    reserved=torch.cuda.memory_reserved(dev), budget_lost=int(m["budget_lost"]),
                    truncated=int(m["truncated"]), n_visible=int(m["n_visible"]))

    ops = activation_ops(lambda: step(gm0, opt0, kf, idxs[0], 1))
    log(f"[{tag}] activation ops of one eager step (exp, sigmoid, the norm and their "
        f"backward): {ops or 'none'}")
    if ops:
        raise AssertionError(f"a step runs the activations as ops of their own: {ops}")
    first = turn(bundled)           # captures the graphs
    log(f"[{tag}] bundles {'+'.join(map(str, sizes))} of {steps} steps: first pass (captures "
        f"included) {first['ms']:.3f} ms/step; {graph_line(graphs)}")
    runs = [(name, turn(fn)) for name, fn in (("eager", eager), ("bundle", bundled),
                                               ("bundle", bundled), ("eager", eager))]
    for name, r in runs:
        log(f"[{tag}] {what} ({card}), {name}: {r['ms']:.3f} ms/step, "
            f"{1e3 / r['ms']:.3f} it/s, peak memory {r['peak'] / 2**30:.3f} GiB "
            f"({held / 2**30:.3f} GiB held before; reserved {r['reserved'] / 2**30:.3f} GiB, "
            f"the graph pool's included), loss {r['loss']:.7f}, visible "
            f"{r['n_visible']}, budget_lost {r['budget_lost']}, truncated {r['truncated']}, "
            f"launches {r['launches']}")
    eager_l = [r["loss"] for name, r in runs if name == "eager"]
    bundle_l = [r["loss"] for name, r in runs if name == "bundle"] + [first["loss"]]
    spread = max(eager_l) - min(eager_l)
    tol = max(SPREAD_FACTOR * spread, LOSS_RTOL_FLOOR * abs(eager_l[0]))
    gap = max(abs(b - e) for b in bundle_l for e in eager_l)
    log(f"[{tag}] {steps}-step loss: eager {eager_l}, bundles {bundle_l}; eager gap "
        f"{spread:.3e}, bundles vs eager at most {gap:.3e} (tolerance {tol:.3e}: "
        f"{SPREAD_FACTOR} x the eager gap, at least {LOSS_RTOL_FLOOR} relative)")
    if not all(math.isfinite(v) for v in eager_l + bundle_l):
        raise AssertionError(f"non-finite loss: {eager_l + bundle_l}")
    if gap > tol:
        raise AssertionError("the bundles' loss lies outside the eager runs' spread")
    want = runs[0][1]["launches"]
    once = (("forward", "preprocess_forward", "preprocess_backward", "sparse_adam") + BINNING
            + SSIM + (() if sharded else (LIVE_SORT,)))
    if (any(want[k] != steps for k in once)
            or any(r["launches"] != want for _, r in runs + [("", first)])):
        raise AssertionError(f"the launches are not one K1, K5, K6, K7, K8, K9, K10, K11 and "
                             f"K12 (and K13 but sharded) a step, or the bundles' differ from "
                             f"the eager loop's: "
                             + str([r["launches"] for _, r in runs]))
    ms = {name: [r["ms"] for nm, r in runs if nm == name] for name in ("eager", "bundle")}
    return dict(ms_per_step=ms, losses=dict(eager=eager_l, bundle=bundle_l), first=first,
                captures=list(graphs.captures), pool_bytes=graphs.pool_bytes)


def phase_steps(dev, card: str, state: dict, steps: int = BUNDLE_STEPS) -> dict:
    """`steps` train steps from the 1M state, eagerly and as the engine's
    bundles (CUDA graphs), in turns (bundle_turns)."""
    from gaussian_lic_tpu_torch.engine.trainer import (
        BundleGraphs, _decompose_bundles, _make_train_bundle, train_step,
    )

    n, cfg, intr, gm0, kf, opt0 = (state[k] for k in ("n", "cfg", "intr", "gm", "kf", "opt"))
    del state["gm"], state["opt"]   # the runs start from gm0/opt0
    gc.collect()                    # engines of phase 3 held in reference cycles
    graphs = BundleGraphs()
    return bundle_turns(
        dev, card, "4", f"{n} Gaussians 640x512", functools.partial(train_step, intr=intr, cfg=cfg),
        lambda k: _make_train_bundle(intr, cfg, k, graphs), graphs, gm0, opt0, kf,
        _decompose_bundles(steps, cfg.opt_bundle_sizes), steps)


# ---------------------------------------------------------------------------
# phase 5: the application
# ---------------------------------------------------------------------------

def recording_engine(rec: dict):
    """An engine factory for `run.main` that keeps the engine in `rec` and
    records per-keyframe seconds, the launch counters at the end of the
    stream (the first call of measure_phase_split or finalize), the phase
    split, and finalize's seconds, launches and results."""
    from gaussian_lic_tpu_torch.engine.trainer import MappingEngine

    def make(*args, **kw):
        eng = MappingEngine(*args, **kw)
        rec.update(engine=eng, keyframe_seconds=[], stream_launches=None)
        add_frame, phase_split, finalize = eng.add_frame, eng.measure_phase_split, eng.finalize

        def stream_end():
            if rec["stream_launches"] is None:
                rec["stream_launches"] = kernel_launches()

        def timed_add_frame(frame):
            t0 = time.perf_counter()
            is_kf = add_frame(frame)   # ends in a host fetch of the step metrics
            if is_kf:
                rec["keyframe_seconds"].append(time.perf_counter() - t0)
            return is_kf

        def recorded_phase_split(*a, **k):
            stream_end()
            rec["phase_split"] = phase_split(*a, **k)
            return rec["phase_split"]

        def recorded_finalize():
            stream_end()
            before = kernel_launches()
            t0 = time.perf_counter()
            rec["results"] = finalize()   # ends in host copies (metrics, PLY)
            rec["finalize_seconds"] = time.perf_counter() - t0
            rec["eval_launches"] = {k: kernel_launches()[k] - v for k, v in before.items()}
            return rec["results"]

        eng.add_frame, eng.measure_phase_split, eng.finalize = (
            timed_add_frame, recorded_phase_split, recorded_finalize)
        return eng

    return make


def write_stream(frames, path: str, period: float = 0.1) -> None:
    """`frames` as a RecordedStream directory, stamps `period` s apart."""
    import dataclasses

    from gaussian_lic_tpu_torch.engine.stream import RecordedStream

    os.makedirs(path)
    for i, f in enumerate(frames):
        RecordedStream.write_frame(path, i, dataclasses.replace(f, timestamp=i * period))


def run_app(argv, label: str) -> dict:
    """`run.main(argv)` with a recording engine; raises unless it exits 0."""
    from gaussian_lic_tpu_torch import run

    rec = {}
    t0 = time.perf_counter()
    rc = run.main(argv, engine_factory=recording_engine(rec))
    rec["seconds"] = time.perf_counter() - t0
    log(f"[5] {label}: run.main exit code {rc} in {rec['seconds']:.2f} s")
    if rc != 0:
        raise AssertionError(f"{label}: run.main exited {rc}")
    return rec


def check_checkpoint(path: str, eng, dev) -> float:
    """Loads the checkpoint at `path` and holds it against `eng`'s state;
    returns the seconds to write the same state again."""
    import torch

    from gaussian_lic_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    t0 = time.perf_counter()
    gm, opt, extra = load_checkpoint(path, device=dev)
    load_s = time.perf_counter() - t0
    bad = [f for f in ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit", "count",
                       "exposure") if not torch.equal(getattr(gm, f), getattr(eng.gm, f))]
    bad += [f"opt_{k}" for k in eng.opt_state
            if not (torch.equal(opt[k].exp_avg, eng.opt_state[k].exp_avg)
                    and torch.equal(opt[k].exp_avg_sq, eng.opt_state[k].exp_avg_sq))]
    if (bad or set(opt) != set(eng.opt_state) or gm.skybox_count != eng.gm.skybox_count
            or gm.sh_degree != eng.gm.sh_degree or int(extra["kf_count"]) != eng.kf_count):
        raise AssertionError(f"the checkpoint does not load back equal to the engine: {bad}")
    t0 = time.perf_counter()
    save_checkpoint(path + ".again.npz", eng.gm, eng.opt_state, extra={"kf_count": eng.kf_count})
    save_s = time.perf_counter() - t0
    log(f"[5] checkpoint: loads back equal to the engine's state (load {load_s:.3f} s, "
        f"write {save_s:.3f} s, {os.path.getsize(path) / 2**20:.1f} MiB)")
    return save_s


def small_app_stream(path: str) -> str:
    """A 9-frame 64x64 stream with a 256-point skybox config; returns the
    config's path."""
    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    intr = Intrinsics(64, 64, 40.0, 40.0, 32.0, 32.0)
    rng = np.random.default_rng(4)
    frames = make_sequence(make_world(rng, n_points=300, intr=intr), n_frames=9,
                           points_per_frame=100, rng=rng)
    write_stream(frames, os.path.join(path, "stream"))
    cfg = os.path.join(path, "small.yaml")
    with open(cfg, "w") as f:
        f.write("width: 64\nheight: 64\nfx: 40.0\nfy: 40.0\ncx: 32.0\ncy: 32.0\n"
                "select_every_k_frame: 3\nskybox_points_num: 256\ninitial_capacity: 1024\n"
                "densify_budget: 256\nmax_train_keyframes: 4\nmax_tiles_per_gaussian: 16\n")
    return cfg


def phase_app(dev, card: str, frames, tmp: str, config: str = CONFIG) -> dict:
    from gaussian_lic_tpu_torch.config import load_params
    from gaussian_lic_tpu_torch.io.ply import load_ply

    sky = load_params(config).skybox_points_num   # 100000 in fastlivo.yaml
    stream = os.path.join(tmp, "stream")
    write_stream(frames, stream)
    out = os.path.join(tmp, "out")
    ckpt = os.path.join(tmp, "ckpt.npz")
    reset_launches()
    rec = run_app(["--input", stream, "--config", config, "--lpips-path", "randinit",
                   "--result-path", out, "--checkpoint", ckpt, "--phase-timers",
                   "--device", str(dev)], "fastlivo.yaml application")
    eng, res = rec["engine"], rec["results"]
    n_views = eng.kf_count + len(eng.test_cameras)
    stream_l, eval_l = rec["stream_launches"], rec["eval_launches"]
    log(f"[5] ({card}) keyframe seconds: "
        + " ".join(f"{s:.4f}" for s in rec["keyframe_seconds"]))
    log(f"[5] ({card}) finalize seconds {rec['finalize_seconds']:.3f} for {n_views} views "
        f"({eng.kf_count} train, {len(eng.test_cameras)} test); phase split "
        f"{json.dumps(rec['phase_split'])}")
    log(f"[5] launches in the stream {stream_l}; in finalize {eval_l}")
    log(f"[5] bundles: compiles {eng.timers.compiles}; {graph_line(eng.graphs)}")
    log("[5] results " + json.dumps(res))
    if min(stream_l.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the application's stream: {stream_l}")
    check_binning_launches(stream_l, "phase 5's stream")
    check_binning_launches(eval_l, "phase 5's finalize")
    check_loss_launches(stream_l, "phase 5's stream")
    if n_views != len(frames) or eval_l["forward"] < n_views:
        raise AssertionError(f"K1 ran {eval_l['forward']} times for {n_views} eval views "
                             f"of {len(frames)} frames")
    if eval_l["ssim_forward"] != n_views or eval_l["ssim_backward"]:
        raise AssertionError(f"not one K11 (and no K12) per eval view: {eval_l} for "
                             f"{n_views} views")
    metrics = [f"{s}_{m}" for s in ("train", "test") for m in ("psnr", "ssim", "lpips")]
    if not all(res.get(k) is not None and math.isfinite(res[k]) for k in metrics):
        raise AssertionError(f"non-finite or missing eval metrics: {res}")
    if not res["train_psnr"] > APP_PSNR_FLOOR:
        raise AssertionError(f"train PSNR {res['train_psnr']} below the floor {APP_PSNR_FLOOR}")
    n_ply = load_ply(os.path.join(out, "point_cloud.ply"))["xyz"].shape[0]
    if eng.gm.skybox_count != sky or n_ply != int(eng.gm.count) - sky:
        raise AssertionError(f"PLY holds {n_ply} vertices for {int(eng.gm.count)} Gaussians "
                             f"with a {eng.gm.skybox_count}-point skybox")
    pngs = [sorted(os.listdir(os.path.join(out, sub))) for sub in ("render", "gt")]
    if pngs[0] != pngs[1] or len(pngs[0]) != n_views:
        raise AssertionError(f"{len(pngs[0])} render and {len(pngs[1])} gt PNGs for "
                             f"{n_views} views")
    log(f"[5] PLY {n_ply} vertices (gaussians {int(eng.gm.count)} - skybox {sky}); "
        f"{n_views} PNG pairs; train PSNR {res['train_psnr']:.4f} dB (floor {APP_PSNR_FLOOR})")
    ckpt_s = check_checkpoint(ckpt, eng, dev)
    log(f"[5] ({card}) checkpoint seconds {ckpt_s:.3f}")

    # the same small application on the card and on the CPU
    small = os.path.join(tmp, "small")
    cfg = small_app_stream(small)
    runs = {}
    for d in (str(dev), "cpu"):
        r = run_app(["--input", os.path.join(small, "stream"), "--config", cfg,
                     "--lpips-path", "randinit", "--result-path", os.path.join(small, d),
                     "--device", d, "--quiet"], f"64x64 application on {d}")
        r["ply"] = load_ply(os.path.join(small, d, "point_cloud.ply"))["xyz"].shape[0]
        runs[d] = r
    a, b = runs[str(dev)], runs["cpu"]
    rel = {k: abs(a["results"][k] - b["results"][k]) / abs(b["results"][k]) for k in metrics}
    log(f"[5] 64x64 application card vs CPU: PLY vertices {a['ply']} vs {b['ply']}, "
        f"metric rel diffs {json.dumps(rel)} (tolerance {APP_SMALL_RTOL})")
    if a["ply"] != b["ply"] or max(rel.values()) > APP_SMALL_RTOL:
        raise AssertionError("the application on the card disagrees with the one on the CPU")
    return dict(results=res, keyframe_seconds=rec["keyframe_seconds"],
                finalize_seconds=rec["finalize_seconds"], checkpoint_seconds=ckpt_s,
                phase_split=rec["phase_split"], small=dict(config=cfg, stream=os.path.join(
                    small, "stream"), results=a["results"], ply=a["ply"]))


# ---------------------------------------------------------------------------
# phase 6: the multi-GPU path (parallel/) on one card
# ---------------------------------------------------------------------------

SHARD_TILES = ((16, 64), (8, 128))   # the band geometry's fallback tiles
BAND_MESHES = (2, 4, 8)
BAND_ATOL = 1e-5           # stitched bands vs the full render (tests/test_parallel.py)
ENGINE_PSNR_DB = 0.1       # mesh engine vs phase 3's engine, train PSNR
STEP_TIMED, STEP_WARM = 20, 3


def check_blend_kernels(sc: dict, tag: str) -> dict:
    """K1 (color, no_color) bit for bit outside termination ties and K2 per
    column (GRAD_RTOL) against their plain versions on one scene; returns
    the errors and K1's time."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    args = (sc["splats"], sc["starts"], sc["lens"])
    errs = {}
    ties = tie_pixels(blend.blend_forward_plain, sc, kw)
    for no_color in (False, True):
        out = blend.blend_forward(*args, no_color=no_color, **kw)
        ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
        ok = ~(ties | (out[2] != ref[2]))
        if bool(((out[2] != ref[2]) & ~ties).any()):
            raise AssertionError(f"{tag}: K1 n_contrib differs outside termination ties")
        err = max(float((out[0] - ref[0]).abs().amax(0)[ok].max()),
                  float((out[1] - ref[1]).abs()[ok].max()))
        errs["forward_no_color" if no_color else "forward"] = err
        if not err <= K1_ATOL:
            raise AssertionError(f"{tag}: K1 (no_color={no_color}) differs from its plain "
                                 f"version by {err}")
    _, ft, nc = blend.blend_forward_plain(*args, **kw)
    P, ids = sc["n_gauss"], sc["sorted_gauss"]
    gk = blend.blend_backward(*args, sc["dl"], ft, nc, ids, n_gauss=P, **kw)
    gp = blend.sum_per_gaussian(blend.blend_backward_plain(*args, sc["dl"], ft, nc, **kw), ids, P)
    torch.cuda.synchronize()
    rel = max(((gk - gp).abs().amax(0) / gp.abs().amax(0).clamp_min(1e-30)).tolist())
    errs["backward"] = float((gk - gp).abs().max())
    if not rel <= GRAD_RTOL:
        raise AssertionError(f"{tag}: K2 differs from its plain version by {rel} relative")
    k1_ms = cuda_ms(lambda: blend.blend_forward(*args, **kw), 20)
    log(f"[6a] {tag}: K1 max|d| {errs['forward']:.3e} (no_color {errs['forward_no_color']:.3e}), "
        f"{int(ties.sum())} tie pixels; K2 max|d grad| {errs['backward']:.3e} "
        f"(relative to the column max {rel:.3e}); K1 {k1_ms:.4f} ms, "
        f"warp blocks {'x'.join(map(str, blend.k1_block(g.tile_h, g.tile_w)))}")
    return errs


def check_nan_row(dev) -> None:
    """The blend golden's list with a NaN-opacity row in front of each tile:
    K1 is its plain version bit for bit; K2 agrees on every other Gaussian
    and gives the NaN rows' Gaussians no gradient."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.utils.synthetic import nan_opacity_list

    with np.load(os.path.join(REPO, "tests", "torch_goldens", "blend.npz")) as z:
        d = dict(z)
    sp, st, ln, nan_at = nan_opacity_list(d["splats"], d["tile_starts"], d["tile_lens"])
    args = tuple(torch.as_tensor(a, device=dev) for a in (sp, st, ln))
    kw = dict(n_tx=2, n_ty=2, tile_h=32, tile_w=32)
    for no_color in (False, True):
        out = blend.blend_forward(*args, no_color=no_color, **kw)
        ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"K1 (no_color={no_color}) applies a NaN-opacity row")
    n_gauss = 300
    ids = np.random.default_rng(13).integers(0, n_gauss - 4, sp.shape[0]).astype(np.int32)
    ids[nan_at] = np.arange(n_gauss - 4, n_gauss)
    ids = torch.as_tensor(ids, device=dev)
    _, ft, nc = blend.blend_forward_plain(*args, **kw)
    dl = torch.as_tensor(d["dl_dcolor"], device=dev)
    gk = blend.blend_backward(*args, dl, ft, nc, ids, n_gauss=n_gauss, **kw)
    gp = blend.sum_per_gaussian(blend.blend_backward_plain(*args, dl, ft, nc, **kw), ids, n_gauss)
    rest = slice(0, n_gauss - 4)
    rel = max(((gk[rest] - gp[rest]).abs().amax(0)
               / gp[rest].abs().amax(0).clamp_min(1e-30)).tolist())
    nan_rows = gk[n_gauss - 4:]
    log(f"[6a] NaN-opacity rows: K1 bit for bit (color, no_color); K2 on the other "
        f"Gaussians {rel:.3e} relative, on the NaN rows' Gaussians max|grad| "
        f"{float(nan_rows.abs().max()):.3e}")
    if not (rel <= GRAD_RTOL and bool((nan_rows == 0).all())):
        raise AssertionError("K2 does not skip the NaN-opacity rows as its plain version does")


def check_bands(state: dict) -> None:
    """render_band for every band of D = 2, 4 and 8 on one card (band
    binning), stitched and held against the full render of the same state;
    K1 must launch D times per D."""
    import torch

    from gaussian_lic_tpu_torch.engine.trainer import _render_kw
    from gaussian_lic_tpu_torch.ops import blend, tiles
    from gaussian_lic_tpu_torch.ops.rasterize import render_map
    from gaussian_lic_tpu_torch.parallel.sharded import _band_geometry, render_band

    cfg, intr, gm, kf = (state[k] for k in ("cfg", "intr", "gm", "kf"))
    kw = _render_kw(cfg, gm.capacity)
    cam = kf.camera(intr, 1)
    with torch.no_grad():
        full = render_map(gm, cam, **kw)
        for D in BAND_MESHES:
            grid, band_n_ty = _band_geometry(intr, cfg, D)
            blend.reset_launches()
            tiles.reset_launches()
            parts = [render_band(
                gm.xyz, gm.log_scale, gm.quat, gm.opa_logit, cam, dc=gm.dc,
                sh_rest=gm.sh_rest, sh_degree=gm.sh_degree, active=gm.active_mask(),
                band_ty0=b * band_n_ty, band_n_ty=band_n_ty, tile_h=grid.tile_h,
                tile_w=grid.tile_w, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                max_total_splats=kw["max_total_splats"]) for b in range(D)]
            torch.cuda.synchronize()
            launches = blend.LAUNCHES["forward"]
            img = torch.cat([p[0] for p in parts], 1)[:, :intr.height, :intr.width]
            ft = torch.cat([p[1] for p in parts], 0)[:intr.height, :intr.width]
            lost = sum(int(p[3]) for p in parts) + int(full.budget_lost)
            err = (float((img - full.image).abs().max()), float((ft - full.final_T).abs().max()))
            log(f"[6b] {D} bands of {band_n_ty} rows of {grid.tile_h}x{grid.tile_w} tiles: "
                f"max|d image| {err[0]:.3e}, max|d final_T| {err[1]:.3e} against the full "
                f"render; K1 launches {launches}; budget lost {lost}")
            if lost or launches != D or not max(err) <= BAND_ATOL:
                raise AssertionError(f"{D} stitched bands disagree with the full render")
            check_binning_launches(dict(tiles.LAUNCHES, **blend.LAUNCHES), f"{D} bands")


def step_results(m, gm) -> dict:
    return dict(loss=float(m["loss"]), n_visible=int(m["n_visible"]), grads=m["grads"],
                params=dict(gm.trainable()))


def check_steps_match(got: list, want: list, cfg) -> None:
    """tests/test_parallel.py:122-175's rule: loss within 1e-6, pre-Adam
    gradients rtol 3e-4 / atol 3e-7, params within 2e-5 on the lanes whose
    gradient is not float noise (< 3e-6 in both runs), noise lanes 10 lr."""
    import torch

    from gaussian_lic_tpu_torch.models.gaussians import LearningRates

    lrs = LearningRates.from_params(cfg)._asdict()
    noise = {}
    for i, (a, b) in enumerate(zip(got, want)):
        dl = abs(a["loss"] - b["loss"])
        worst = {}
        for k in a["grads"]:
            ga, gb = a["grads"][k], b["grads"][k]
            bad = (ga - gb).abs() > 3e-7 + 3e-4 * gb.abs()
            noise[k] = noise.get(k, torch.zeros_like(bad)) | (torch.maximum(ga.abs(), gb.abs())
                                                              < 3e-6)
            dp = (a["params"][k] - b["params"][k]).abs()
            worst[k] = (int(bad.sum()), float(torch.where(noise[k], 0.0, dp).max()),
                        float(torch.where(noise[k], dp, 0.0).max()))
            if worst[k][0] or worst[k][1] > 2e-5 or worst[k][2] > 10 * lrs[k]:
                raise AssertionError(f"step {i} {k}: {worst[k]} (grad mismatches, clean-lane "
                                     "param gap, noise-lane param gap)")
        log(f"[6c] step {i}: loss {a['loss']:.7f} vs {b['loss']:.7f} (|d| {dl:.2e}); visible "
            f"{a['n_visible']} vs {b['n_visible']}; per group (grad mismatches, clean param "
            f"gap, noise param gap) {worst}")
        if not (dl < 1e-6 and a["n_visible"] == b["n_visible"]):
            raise AssertionError(f"step {i}: the sharded step's loss or visible count differs")


def check_sharded_step(state: dict, mesh) -> dict:
    """make_sharded_train_step on the one-rank mesh against train_step on the
    1M state for 2 steps, then 20 steps of each timed in turns."""
    import torch

    from gaussian_lic_tpu_torch.engine.trainer import train_step
    from gaussian_lic_tpu_torch.parallel import make_sharded_train_step, shard_state

    cfg, intr, gm, kf, opt = (state[k] for k in ("cfg", "intr", "gm", "kf", "opt"))
    dev = gm.device
    sharded = make_sharded_train_step(intr, cfg, mesh, with_grads=True)
    single = functools.partial(train_step, intr=intr, cfg=cfg, with_grads=True)
    runs = {}
    for name, step in (("single", single), ("sharded", sharded)):
        g, o = (gm, opt) if name == "single" else shard_state(gm, opt, mesh)
        out = []
        for i in range(2):
            g, o, m = step(g, o, kf, i + 1, i + 1)
            out.append(step_results(m, g))
        runs[name] = out
    check_steps_match(runs["sharded"], runs["single"], cfg)
    del runs

    timed_step = {"single": functools.partial(train_step, intr=intr, cfg=cfg),
                  "sharded": make_sharded_train_step(intr, cfg, mesh)}
    res = {}
    for name in ("single", "sharded", "sharded", "single"):
        g, o = (gm, opt) if name == "single" else shard_state(gm, opt, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(STEP_WARM):
            g, o, m = timed_step[name](g, o, kf, i % 4, i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEP_TIMED):
            g, o, m = timed_step[name](g, o, kf, i % 4, STEP_WARM + i + 1)
        torch.cuda.synchronize()
        loss = float(m["loss"])
        ms = (time.perf_counter() - t0) / STEP_TIMED * 1e3
        res.setdefault(name, []).append((ms, torch.cuda.max_memory_allocated(dev), loss))
        del g, o, m
    for name, runs_ in res.items():
        log(f"[6c] {name} step at D = 1 ({state['n']} Gaussians, 640x512): ms/step "
            + " / ".join(f"{r[0]:.3f}" for r in runs_) + "; peak memory "
            + " / ".join(f"{r[1] / 2**30:.3f}" for r in runs_) + " GiB; loss "
            + " / ".join(f"{r[2]:.6f}" for r in runs_))
    return res


def check_sharded_bundles(dev, card: str, state: dict, mesh, steps: int = BUNDLE_STEPS) -> dict:
    """`steps` sharded steps from the 1M state's shard, eagerly and as the
    sharded bundles (CUDA graphs over the mesh's NCCL group), in turns
    (bundle_turns)."""
    from gaussian_lic_tpu_torch.engine.trainer import BundleGraphs, _decompose_bundles
    from gaussian_lic_tpu_torch.parallel import (
        make_sharded_train_bundle, make_sharded_train_step, shard_state,
    )

    cfg, intr = state["cfg"], state["intr"]
    gs, os_ = shard_state(state["gm"], state["opt"], mesh)
    graphs = BundleGraphs()
    return bundle_turns(
        dev, card, "6c", f"sharded, D = 1, {state['n']} Gaussians 640x512",
        make_sharded_train_step(intr, cfg, mesh),
        lambda k: make_sharded_train_bundle(intr, cfg, mesh, k, graphs), graphs, gs, os_,
        state["kf"], _decompose_bundles(steps, cfg.opt_bundle_sizes), steps, sharded=True)


def phase_sharded(dev, card: str, slice_res: dict, app_res: dict, tmp: str) -> dict:
    """The multi-GPU path on one card: (a) K1/K2 at the band geometry's
    fallback tiles and on NaN-opacity rows; (b) D = 2, 4, 8 bands rendered
    one by one and stitched; (c) the sharded step on a one-rank NCCL mesh
    against the single-device step, and its bundles (CUDA graphs) against
    its eager steps; (d) MappingEngine on that mesh over phase 3's stream;
    (e) `run.main --mesh-devices 1` on phase 5's 64x64 app."""
    import torch
    import torch.distributed as dist

    from gaussian_lic_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    for tile in SHARD_TILES:
        check_blend_kernels(kernel_scene(dev, tile=tile), f"20000-Gaussian scene in "
                            f"{tile[0]}x{tile[1]} tiles")
    check_nan_row(dev)
    log(f"[6a] seconds {time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    state = bench_state(dev)
    check_bands(state)
    log(f"[6b] seconds {time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    mesh = make_mesh(1, device=dev)
    log(f"[6c] mesh: {dist.get_backend(mesh.group)} process group of {mesh.size} rank on "
        f"{mesh.device} ({card})")
    steps = check_sharded_step(state, mesh)
    bundles = check_sharded_bundles(dev, card, state, mesh)
    del state
    gc.collect()
    log(f"[6c] seconds {time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    reset_launches()
    eng, _ = run_engine(slice_res["cfg"], slice_res["frames"], dev, verbose=False, mesh=mesh)
    launches = kernel_launches()
    psnr = engine_train_psnr(eng)
    log(f"[6d] engine on the mesh over phase 3's stream: train PSNR {psnr:.4f} dB against "
        f"{slice_res['train_psnr']:.4f} single-device; gaussians {int(eng.gm.count)}; "
        f"launches {launches}; compiles {eng.timers.compiles}; {graph_line(eng.graphs)} "
        f"({time.perf_counter() - t0:.2f} s)")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the sharded path: {launches}")
    check_binning_launches(launches, "phase 6d", sharded=True)
    check_loss_launches(launches, "phase 6d")
    if not eng.graphs.captures:
        raise AssertionError("the mesh engine ran its bundles without CUDA graphs")
    if not abs(psnr - slice_res["train_psnr"]) < ENGINE_PSNR_DB:
        raise AssertionError(f"the mesh engine's train PSNR {psnr} is not within "
                             f"{ENGINE_PSNR_DB} dB of phase 3's")
    del eng
    gc.collect()

    t0 = time.perf_counter()
    small = app_res["small"]
    rec = run_app(["--input", small["stream"], "--config", small["config"],
                   "--lpips-path", "randinit", "--result-path", os.path.join(tmp, "mesh1"),
                   "--device", str(dev), "--mesh-devices", "1", "--quiet"],
                  "64x64 application, --mesh-devices 1")
    if rec["engine"].mesh is None:
        raise AssertionError("--mesh-devices 1 ran without a mesh")
    rel = {k: abs(rec["results"][k] - v) / abs(v) for k, v in small["results"].items()
           if k.split("_")[0] in ("train", "test")}
    log(f"[6e] --mesh-devices 1 vs phase 5's card run: metric rel diffs {json.dumps(rel)} "
        f"(tolerance {APP_SMALL_RTOL}; {time.perf_counter() - t0:.2f} s)")
    if max(rel.values()) > APP_SMALL_RTOL:
        raise AssertionError("--mesh-devices 1 disagrees with the single-device application")
    dist.destroy_process_group()
    return dict(steps=steps, bundles=bundles, engine_psnr=psnr)


# ---------------------------------------------------------------------------
# phase 7: the dense oracle, the production-scale tools, the synthetic GT
# ---------------------------------------------------------------------------

ORACLE_RIG = dict(width=256, height=64, fx=80.0, fy=80.0, cx=128.0, cy=32.0)
ORACLE_GEOM = ("xyz", "scale", "quat", "opacity")
# render_tiled (K1) vs render_dense: tests/test_rasterize_tiled.py:139-149's bounds
ORACLE_IMG_MAX, ORACLE_IMG_MEAN, ORACLE_T_MAX = 0.02, 1e-4, 0.03
ORACLE_GRAD_RTOL = 1e-4    # K1 + K2 grads vs autograd of render_dense, of each column's max
ORACLE_CARD_ATOL = 1e-5    # render_dense on the card vs on the CPU
DEMO_LSB, DEMO_SHARE = 1, 1e-3   # run._demo_frames' uint8 images, card vs CPU
SOAK_FRAMES = 60           # 12 keyframes, 78 steps
DEMO_FRAMES = 2            # the CPU's dense GT takes ~15 s a frame at 640x512


def oracle_scene(rng, m: int, opa_range=(0.2, 0.9)) -> dict:
    """tests/test_rasterize_tiled.py:27-41's random_scene, as numpy arrays."""
    xyz = np.stack([rng.uniform(-6, 6, m), rng.uniform(-1, 1, m), rng.uniform(3, 10, m)],
                   1).astype(np.float32)
    scale = (np.abs(rng.normal(size=(m, 3))) * 0.08 + 0.03).astype(np.float32)
    quat = rng.normal(size=(m, 4)).astype(np.float32)
    opacity = rng.uniform(*opa_range, m).astype(np.float32)
    dc = (rng.normal(size=(m, 3)) * 0.4).astype(np.float32)
    shr = (rng.normal(size=(m, 15, 3)) * 0.05).astype(np.float32)
    return dict(xyz=xyz, scale=scale, quat=quat, opacity=opacity, dc=dc, sh_rest=shr)


def oracle_camera(dev):
    from gaussian_lic_tpu_torch.camera import Intrinsics, look_at, make_camera

    R_wc, t_wc = look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    return make_camera(Intrinsics(**ORACLE_RIG), R_wc, t_wc, device=dev)


def oracle_grads(params: dict, target, cam, renderer) -> dict:
    """Gradients of mean((image - target)^2) by the six parameter groups
    (tests/test_rasterize_tiled.py:199-233)."""
    import torch

    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    out = renderer(p["xyz"], torch.exp(p["log_scale"]), p["quat"], torch.sigmoid(p["opa_logit"]),
                   cam, dc=p["dc"], sh_rest=p["sh_rest"], sh_degree=3)
    loss = torch.mean((out.image - target) ** 2)
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def check_oracle(dev) -> dict:
    """(a) K1 and K2 against the dense oracle on the card, an independent
    reference: the 200-Gaussian forward, the 60-Gaussian gradients, and the
    card's oracle against the CPU's."""
    import torch

    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.ops.rasterize import render_tiled
    from gaussian_lic_tpu_torch.ops.rasterize_ref import render_dense

    sc = oracle_scene(np.random.default_rng(7), 200)

    def scene_on(d):
        """(positional args, keyword args) of the renderers on device d."""
        t = {k: torch.as_tensor(v, device=d) for k, v in sc.items()}
        return [t[k] for k in ORACLE_GEOM] + [oracle_camera(d)], dict(dc=t["dc"],
                                                                    sh_rest=t["sh_rest"])

    (args, kw), (args_cpu, kw_cpu) = scene_on(dev), scene_on("cpu")
    blend.reset_launches()
    with torch.no_grad():
        tiled = render_tiled(*args, **kw, max_total_splats=1 << 14)
        dense = render_dense(*args, **kw)
        dense_cpu = render_dense(*args_cpu, **kw_cpu)
    d_img = (tiled.image - dense.image).abs()
    res = dict(img_max=float(d_img.max()), img_mean=float(d_img.mean()),
               final_t=float((tiled.final_T - dense.final_T).abs().max()),
               radii=float((tiled.radii - dense.radii).abs().max()),
               card_cpu=max(float((dense.image.cpu() - dense_cpu.image).abs().max()),
                            float((dense.final_T.cpu() - dense_cpu.final_T).abs().max())),
               n_contrib_card_cpu=int((dense.n_contrib.cpu() != dense_cpu.n_contrib).sum()))
    log(f"[7a] 200 Gaussians at 256x64, K1 vs the dense oracle on the card: image max|d| "
        f"{res['img_max']:.3e} (bound {ORACLE_IMG_MAX}), mean {res['img_mean']:.3e} "
        f"(bound {ORACLE_IMG_MEAN}), final_T max|d| {res['final_t']:.3e} (bound "
        f"{ORACLE_T_MAX}), radii max|d| {res['radii']:.3e}, overflow {int(tiled.overflow)}")
    log(f"[7a] the oracle, card vs CPU: image/final_T max|d| {res['card_cpu']:.3e} (tolerance "
        f"{ORACLE_CARD_ATOL}), n_contrib mismatches {res['n_contrib_card_cpu']}")
    if (int(tiled.overflow) or res["img_max"] >= ORACLE_IMG_MAX
            or res["img_mean"] >= ORACLE_IMG_MEAN or res["final_t"] >= ORACLE_T_MAX
            or not torch.equal(tiled.visible, dense.visible)
            or not torch.allclose(tiled.radii, dense.radii)):
        raise AssertionError(f"K1 disagrees with the dense oracle: {res}")
    if not res["card_cpu"] <= ORACLE_CARD_ATOL:
        raise AssertionError(f"the dense oracle on the card disagrees with the CPU's: {res}")

    rng = np.random.default_rng(8)
    g = oracle_scene(rng, 60, opa_range=(0.2, 0.8))
    params = dict(xyz=g["xyz"], log_scale=np.log(g["scale"]), quat=g["quat"],
                  opa_logit=np.log(g["opacity"] / (1 - g["opacity"])), dc=g["dc"],
                  sh_rest=g["sh_rest"])
    params = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    target = torch.as_tensor(rng.uniform(size=(3, ORACLE_RIG["height"], ORACLE_RIG["width"]))
                             .astype(np.float32), device=dev)
    cam = args[-1]
    g_dense = oracle_grads(params, target, cam, render_dense)
    g_tiled = oracle_grads(params, target, cam,
                           lambda *a, **k: render_tiled(*a, **k, max_total_splats=1 << 14))
    torch.cuda.synchronize()
    res["launches"] = dict(blend.LAUNCHES)
    res["grad_rel"] = {}
    for k in params:
        a, b = g_tiled[k].reshape(60, -1), g_dense[k].reshape(60, -1)
        res["grad_rel"][k] = float(((a - b).abs().amax(0) / b.abs().amax(0).clamp_min(1e-12)).max())
    log(f"[7a] 60 Gaussians, gradients through K1 + K2 vs autograd of the oracle, relative to "
        f"each column's max: {json.dumps(res['grad_rel'])} (tolerance {ORACLE_GRAD_RTOL}); "
        f"launches {res['launches']}")
    if max(res["grad_rel"].values()) > ORACLE_GRAD_RTOL:
        raise AssertionError(f"K1 + K2 gradients disagree with the dense oracle: {res}")
    if res["launches"]["forward"] <= 0 or res["launches"]["backward"] <= 0:
        raise AssertionError(f"K1 or K2 did not launch against the oracle: {res['launches']}")
    return res


def load_tool(name: str):
    """tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_soak(dev, tmp: str, frames: int = SOAK_FRAMES, extra=()) -> dict:
    """(b) tools/soak_torch.py through its own main() at the production
    config (skybox 100,000, K = 16, 100 iterations a keyframe), launch
    counters zeroed just before and read just after."""

    out = os.path.join(tmp, "soak.json")
    reset_launches()
    rc = load_tool("soak_torch").main(["--frames", str(frames), "--device", str(dev),
                                       "--out", out, *extra])
    launches = kernel_launches()
    with open(out) as f:
        summary = json.load(f)["summary"]
    log(f"[7b] soak exit code {rc}; launches {launches}; compiles {summary['recompiles']}")
    if rc != 0:
        raise AssertionError(f"tools/soak_torch.py exited {rc}: {summary}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the soak: {launches}")
    return dict(summary=summary, launches=launches)


def check_demo_frames(dev, n_frames: int = DEMO_FRAMES) -> dict:
    """(d) the synthetic GT repair on the card: run._demo_frames at the
    fastlivo rig (600 points: the dense oracle) on the card against the CPU."""
    from gaussian_lic_tpu_torch import run
    from gaussian_lic_tpu_torch.config import load_params

    cfg = load_params(CONFIG)
    card = run._demo_frames(cfg, n_frames=n_frames, device=dev)
    cpu = run._demo_frames(cfg, n_frames=n_frames, device="cpu")
    lsb, off, values = 0, 0, 0
    for a, b in zip(card, cpu):
        d = np.abs(a.image.astype(np.int32) - b.image.astype(np.int32))
        lsb, off, values = max(lsb, int(d.max())), off + int((d > 0).sum()), values + d.size
        if not (np.array_equal(a.points, b.points) and np.array_equal(a.R_wc, b.R_wc)):
            raise AssertionError("_demo_frames' LiDAR points or poses differ across devices")
    log(f"[7d] _demo_frames at {cfg.width}x{cfg.height}, {n_frames} frames, card vs CPU: "
        f"max {lsb} LSB, {off} of {values} values differ (tolerance {DEMO_LSB} LSB on "
        f"{DEMO_SHARE:.1%})")
    if len(card) != len(cpu) or lsb > DEMO_LSB or off > DEMO_SHARE * values:
        raise AssertionError("the demo's GT frames on the card disagree with the CPU's")
    return dict(lsb=lsb, off=off, values=values)


def phase_tools(dev, tmp: str) -> dict:
    """(a) K1/K2 against the dense oracle; (b) the soak tool at 60 frames;
    (c) the validation tool at its defaults; (d) the demo's GT frames, card
    against CPU."""
    res = {}
    t0 = time.perf_counter()
    res["oracle"] = check_oracle(dev)
    log(f"[7a] seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    res["soak"] = run_soak(dev, tmp)
    log(f"[7b] seconds {time.perf_counter() - t0:.2f}")
    gc.collect()
    t0 = time.perf_counter()
    rc = load_tool("validate_scale_torch").main(["--device", str(dev)])
    log(f"[7c] validate_scale_torch exit code {rc}; seconds {time.perf_counter() - t0:.2f}")
    if rc != 0:
        raise AssertionError(f"tools/validate_scale_torch.py exited {rc}")
    gc.collect()
    t0 = time.perf_counter()
    res["demo"] = check_demo_frames(dev)
    log(f"[7d] seconds {time.perf_counter() - t0:.2f}")
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
    check_k2_reduction(lib.path)

    t0 = time.perf_counter()
    state = bench_state(dev)
    state["rates"] = card_rates(dev)
    log(f"[2] bounds at {state['rates']['sms']} SMs, max SM clock "
        f"{state['rates']['hz'] / 1e6:.0f} MHz")
    kernels, scenes = phase_kernels(dev, state, state["rates"])
    log(f"[2] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    kernels += phase_preprocess(scenes)
    log(f"[2c] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    kernels += phase_binning(scenes, state["rates"])
    log(f"[2d] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    kernels += phase_ssim(scenes, state["rates"])
    log(f"[2e] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    probes = phase_probes(state, scenes)
    del scenes
    log(f"[2b] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    slice_res = phase_slice(dev, kernels)
    log(f"[3] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    phase_steps(dev, card, state)
    log(f"[4] phase seconds {time.perf_counter() - t0:.2f}")
    del state
    gc.collect()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        app_res = phase_app(dev, card, slice_res["frames"], tmp)
        log(f"[5] phase seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        phase_sharded(dev, card, slice_res, app_res, tmp)
        log(f"[6] phase seconds {time.perf_counter() - t0:.2f}")
        del slice_res, app_res
        gc.collect()
        t0 = time.perf_counter()
        phase_tools(dev, tmp)
    log(f"[7] phase seconds {time.perf_counter() - t0:.2f}")
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
