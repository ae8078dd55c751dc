"""The binning and loss kernels (K8-K12) and their timing variants, alone on the card.

    python tools/probe_torch_binning_loss.py

Runs chip_smoke.py's phases 2d and 2e without the rest of the smoke test:
builds the kernels, makes phase 2's two inputs (the seeded 20k-Gaussian
scene and the 1M-Gaussian train step's arguments), then K8, K9 and K10
against their plain versions with K8's and K9's timing variants
(tiles.K8_VARIANTS, tiles.K9_VARIANTS) and K8's warp-slot counts, and K11
and K12 against theirs with K11's and K12's timing variants
(losses.K11_VARIANTS, losses.K12_VARIANTS), each variant timed beside the
others in turns, 20 calls in a CUDA graph, and each kernel's registers,
spills and shared memory (cuobjdump). Then the device time of each kernel
that the wrappers launch (K8: base, fold, listed; K9: base, hist, first,
with their fills; K11: base, nofold, persist, the first design; K12: base,
the first design), from torch.profiler over a replay of 20 calls in a CUDA
graph.
Prints the phases' lines, the first of them the card's name and power
limit. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import gc
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_split(fn, reps: int = 20) -> dict:
    """Device time of each kernel of `fn()`, ms a call: `reps` calls captured
    in one CUDA graph (after one call outside the capture), one replay under
    torch.profiler, each kernel's device time over `reps`. A wrapper's own
    launches (fills, reductions) show beside its kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    finally:
        gc.enable()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us and e.device_type.name == "CUDA":
            out[e.key[:90]] = us / 1e3 / reps
    del graph
    return out


def log_split(cs, tag: str, fn) -> None:
    split = device_split(fn)
    cs.log(f"[split] {tag}: " + "  ".join(f"{v:.4f} ms {k}" for k, v in
                                          sorted(split.items(), key=lambda kv: -kv[1])))


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_binning_loss.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gaussian_lic_tpu_torch import _build
    from gaussian_lic_tpu_torch.utils.cuda_timing import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    cs.log(f"[1] card: {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    lib = _build.load()
    for line in lib.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            cs.log(f"[1] ptxas: {line.strip()}")
    cs.log(f"[1] kernels built in {lib.build_seconds:.2f} s")
    state = cs.bench_state(dev)
    rates = cs.card_rates(dev)
    scenes = (cs.kernel_scene(dev), cs.step_scene(state))
    t0 = time.perf_counter()
    cs.phase_binning(scenes, rates)
    cs.log(f"[2d] phase seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    cs.phase_ssim(scenes, rates)
    cs.log(f"[2e] phase seconds {time.perf_counter() - t0:.2f}")
    # each wrapper's kernels, device time alone, on the train step's inputs
    from gaussian_lic_tpu_torch.ops import losses, preprocess as pre, tiles

    sc = scenes[1]
    x = sc["inputs"]
    table, depth, radius, active, _ = pre.preprocess_forward(
        *(x[k] for k in ("xyz", "scale", "quat", "opacity", "camera", "dc", "sh_rest",
                         "sh_degree", "active")))
    P = x["xyz"].shape[0]
    g, K = sc["grid"], sc["bin_kw"]["max_tiles_per_gaussian"]
    bits = tiles.rank_bits_for(g.num_tiles)
    args = (table[:P, 0:2], depth, table[:P, 2:5], x["opacity"], radius, active, g, K, bits, 0,
            g.n_ty)
    for v in ("base", "fold", "listed"):
        log_split(cs, f"K8 {v}", lambda: tiles.bin_keys_probe(v, *args))
    from gaussian_lic_tpu_torch.ops.rasterize import CHUNK

    k8 = tiles.bin_keys(*args)
    sk, ss = torch.sort(k8[0], stable=True)
    ss = ss.to(torch.int32)   # K9's slot ids
    m_eff = min(sc["bin_kw"]["max_total_splats"], P * K)
    m_pad = -(-m_eff // CHUNK) * CHUNK
    k9kw = dict(slot_keys=k8[0], touched=k8[1], sums=k8[2])
    for v in ("base", "hist", "first"):
        log_split(cs, f"K9 {v}", lambda: tiles.bin_ranges_probe(v, sk, ss, m_eff, m_pad, P,
                                                                g.num_tiles, bits, **k9kw))
    # K8 and K10 at three L2 fetch sizes (a device-wide hint; restored after)
    import ctypes

    prev, first = ctypes.c_int(0), ctypes.c_int(0)
    lib.cdll.glic_l2_fetch_granularity(-1, ctypes.byref(first))
    ids = torch.arange(P + 1, dtype=torch.int32, device=dev)
    for size in (32, 64, 128):
        rc = lib.cdll.glic_l2_fetch_granularity(size, ctypes.byref(prev))
        times = {v: cs.graph_ms(lambda: tiles.bin_keys_probe(v, *args))
                 for v in ("base", "listed", "memonly")}
        times["K10"] = cs.graph_ms(lambda: tiles.gather_splats(table, ids))
        cs.log(f"[l2] fetch granularity {size} B (rc {rc}, was {prev.value}): "
               + "  ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    lib.cdll.glic_l2_fetch_granularity(first.value, ctypes.byref(prev))
    img, gt = cs.ssim_inputs(sc, sc["gt"])
    for v in ("base", "nofold", "persist", "first"):
        log_split(cs, f"K11 {v}", lambda: losses.ssim_forward_probe(v, img, gt))
    n = img.numel()
    d_sums = torch.tensor([-0.2 / n, 0.8 / n], device=dev)
    maps = losses.ssim_forward(img, gt)[1]
    for v in ("base", "first"):
        log_split(cs, f"K12 {v}", lambda: losses.ssim_backward_probe(v, img, gt, maps, d_sums))
    return 0


if __name__ == "__main__":
    sys.exit(main())
