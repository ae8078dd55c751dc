"""Train-step time of several checkouts of the port, in turns, on one GPU.

    python tools/ab_train_step.py OLD_DIR NEW_DIR [--rounds 2] [--kernels]

Each round runs the checkouts in the order A B B A (for two; forward then
backward for more), each in a fresh process that imports that checkout's own
`chip_smoke.py` and runs its `bench_state` + `phase_steps`: 100 steps of the
1M-Gaussian fastlivo train step from one state, eagerly and as the engine's
bundles 64+16+16+4 (CUDA graphs), in turns eager, bundle, bundle, eager,
ms/step from a host clock around work that ends in `synchronize()` and a
loss fetch. Comparing two versions inside one call on one card in turns is
what makes their difference readable (the card's power limit and the host's
load vary between calls). Prints each run's phase-4 lines (the card's name
and power limit in them), then each checkout's ms/step in run order, in
bundles and eager (each the mean of the run's two turns). With
`--kernels`, each run times the train step's kernels alone instead on the
arguments of that train step (`step_scene`): K1 and K2 on its splat list,
K5 and K6 on its parameters and camera (K6 on K2's (P, 9) output), K7 on
the six groups with K6's gradients and zero moments (CUDA events, 50
launches each after a warm-up); K8 on K5's output, K9 on the stable sort
of K8's keys (with K8's keys, touched and sums where the checkout's
`bin_ranges` takes them, as `bin_gaussians` passes them), K10 on K9's
list, K11 and K12 on K1's image and the keyframe's, each 20 calls in a
CUDA graph (`chip_smoke.graph_ms`: eager times of these short kernels are
the host's launch gaps); K5f and K6f, the preprocess with the activations
of the stored parameters as that checkout's train step runs them, 20 calls
in a CUDA graph: K5 and K6 from the stored log_scale, quat and opa_logit
where its preprocess takes them (`raw`), else the activations as PyTorch
ops, then K5; K6, then the activations' backward as autograd's ops. A
checkout without K8-K10 or K11-K12 prints n/a; the lists are of each
kernel's ms.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from gaussian_lic_tpu_torch.utils.cuda_timing import card_line
dev = torch.device("cuda:0")
cs.phase_steps(dev, card_line(), cs.bench_state(dev))
"""

_KERNELS = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from gaussian_lic_tpu_torch.ops import adam, blend, preprocess as pre
from gaussian_lic_tpu_torch.utils.cuda_timing import card_line, cuda_ms
dev = torch.device("cuda:0")
state = cs.bench_state(dev)
sc = cs.step_scene(state)
g = sc["grid"]
kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
args = (sc["splats"], sc["starts"], sc["lens"])
_, ft, nc = blend.blend_forward(*args, **kw)
k2_call = lambda: blend.blend_backward(*args, sc["dl"], ft, nc, sc["sorted_gauss"],
                                       n_gauss=sc["n_gauss"], **kw)
ms = {"K1": cuda_ms(lambda: blend.blend_forward(*args, **kw), 50, warmup=3),
      "K2": cuda_ms(k2_call, 50, warmup=3)}
x = sc["inputs"]
geo = tuple(x[k] for k in ("xyz", "scale", "quat", "opacity"))
fargs = geo + (x["camera"], x["dc"], x["sh_rest"], x["sh_degree"], x["active"])
bargs = geo + (x["camera"], x["dc"], x["sh_rest"], x["sh_degree"], k2_call())
ms["K5"] = cuda_ms(lambda: pre.preprocess_forward(*fargs), 50, warmup=3)
ms["K6"] = cuda_ms(lambda: pre.preprocess_backward(*bargs), 50, warmup=3)
import inspect
gm = state["gm"]
stored = (gm.log_scale, gm.quat, gm.opa_logit)
rest = (x["camera"], x["dc"], x["sh_rest"], x["sh_degree"])
d_rows = bargs[-1]
if "raw" in inspect.signature(pre.preprocess_forward).parameters:   # the fold
    k5f = lambda: pre.preprocess_forward(x["xyz"], *stored, *rest, x["active"], raw=True)
    k6f = lambda: pre.preprocess_backward(x["xyz"], *stored, *rest, d_rows, raw=True)
else:   # the activations as PyTorch ops around K5 and K6 (and autograd's backward ops)
    def activate(ls, q, ol):
        return torch.exp(ls), q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12), torch.sigmoid(ol)
    acts = activate(*stored)
    qn = torch.linalg.norm(gm.quat, dim=-1, keepdim=True)
    qd = qn + 1e-12
    k5f = lambda: pre.preprocess_forward(x["xyz"], *activate(*stored), *rest, x["active"])
    def k6f():
        d = pre.preprocess_backward(x["xyz"], *acts, *rest, d_rows)
        d_q = d[2] / qd
        d_q += (-d[2] * ((gm.quat / qd) / qd)).sum(-1, keepdim=True) * (gm.quat / qn).masked_fill_(qn == 0, 0)
        return d[1] * acts[0], d_q, torch.ops.aten.sigmoid_backward(d[3], acts[2])
ms["K5f"] = cs.graph_ms(k5f)
ms["K6f"] = cs.graph_ms(k6f)
params = dict(xyz=x["xyz"], log_scale=torch.log(x["scale"]), quat=x["quat"],
              opacity=x["opacity"], dc=x["dc"], sh_rest=x["sh_rest"])
params = {k: v.contiguous() for k, v in params.items()}
grads = dict(zip(("xyz", "log_scale", "quat", "opacity", "dc", "sh_rest"),
                 pre.preprocess_backward(*bargs)))
states = {k: adam.AdamState(torch.zeros_like(p), torch.zeros_like(p)) for k, p in params.items()}
visible = (pre.preprocess_forward(*fargs)[2] > 0) & x["active"]
lrs = dict(xyz=1.6e-4, dc=2.5e-3, sh_rest=1.25e-4, opacity=0.05, log_scale=5e-3, quat=1e-3)
ms["K7"] = cuda_ms(lambda: adam.sparse_adam_update_groups(params, grads, states, visible, lrs),
                   50, warmup=3)
from gaussian_lic_tpu_torch.ops import losses, tiles
from gaussian_lic_tpu_torch.ops.rasterize import CHUNK
if hasattr(tiles, "bin_keys"):   # K8, K9 and K10 (a checkout before them has none)
    table, depth, radius, active = pre.preprocess_forward(*fargs)[:4]
    P = x["xyz"].shape[0]
    K, M = sc["bin_kw"]["max_tiles_per_gaussian"], sc["bin_kw"]["max_total_splats"]
    bits, T = tiles.rank_bits_for(g.num_tiles), g.num_tiles
    kargs = (table[:P, 0:2], depth, table[:P, 2:5], x["opacity"], radius, active, g, K, bits,
             0, g.n_ty)
    k8 = tiles.bin_keys(*kargs)
    sk, ss = torch.sort(k8[0], stable=True)
    m_eff = min(M, P * K)
    m_pad = -(-m_eff // CHUNK) * CHUNK
    # K8's outputs, as bin_gaussians passes them, where this checkout's K9
    # takes them (the same list and budget either way)
    import inspect
    k9kw = (dict(slot_keys=k8[0], touched=k8[1], sums=k8[2])
            if "touched" in inspect.signature(tiles.bin_ranges).parameters else {})
    ids = tiles.bin_ranges(sk, ss, m_eff, m_pad, P, T, bits, **k9kw)[0]
    ms["K8"] = cs.graph_ms(lambda: tiles.bin_keys(*kargs))
    ms["K9"] = cs.graph_ms(lambda: tiles.bin_ranges(sk, ss, m_eff, m_pad, P, T, bits, **k9kw))
    ms["K10"] = cs.graph_ms(lambda: tiles.gather_splats(table, ids))
if hasattr(losses, "ssim_forward"):   # K11 and K12 (a checkout before them has neither)
    img = blend.blend_forward(*args, **kw)[0][:, :g.height, :g.width].contiguous()
    gt = sc["gt"]
    n = img.numel()
    d_sums = torch.tensor([-0.2 / n, 0.8 / n], device=dev)
    maps = losses.ssim_forward(img, gt)[1]
    ms["K11"] = cs.graph_ms(lambda: losses.ssim_forward(img, gt))
    ms["K12"] = cs.graph_ms(lambda: losses.ssim_backward(img, gt, maps, d_sums))
print(f"[ab] {card_line()}: " + "  ".join(f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
"""
KERNELS = ("K1", "K2", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12", "K5f", "K6f")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout directories (each holds chip_smoke.py)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", action="store_true",
                    help="time the train step's kernels K1, K2 and K5-K12 alone (and K5f, "
                         "K6f: K5 and K6 with the activations)")
    args = ap.parse_args(argv)
    child = _KERNELS if args.kernels else _CHILD
    whats = (tuple(f"{k} ms" for k in KERNELS) if args.kernels
             else ("bundle ms/step", "eager ms/step"))
    trees = [os.path.abspath(t) for t in args.trees]
    for t in trees:
        if not os.path.isfile(os.path.join(t, "chip_smoke.py")):
            print(f"ab_train_step.py: {t} holds no chip_smoke.py", file=sys.stderr)
            return 2
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    ms = {t: [] for t in trees}
    for t in order:
        out = subprocess.run([sys.executable, "-c", child, t], capture_output=True, text=True)
        values = _readings(out.stdout, args.kernels)
        if out.returncode != 0 or values is None:
            print(out.stdout[-2000:] + out.stderr[-2000:], file=sys.stderr)
            print(f"ab_train_step.py: the run of {t} failed ({out.returncode})", file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("[ab]" if args.kernels else "[4]"):
                print(f"{t}: {line}", flush=True)
                if args.kernels:   # each kernel's reading by the name it printed
                    values = dict(zip(re.findall(r"(K\d+f?) [0-9.]+ ms", line), values))
        ms[t].append(values if args.kernels else dict(zip(whats, values)))
    for t in trees:
        for what in whats:
            key = what.split()[0] if args.kernels else what
            print(f"{t}: {what} " + " ".join(f"{v[key]:.4f}" if key in v else "n/a"
                                             for v in ms[t]))
    return 0


def _readings(stdout: str, kernels: bool):
    """The kernels' ms of a `--kernels` run, in the order its [ab] line
    names them; else (bundle, eager) ms/step of a phase-4 run, each the mean
    of its turns. None if the run printed none."""
    if kernels:
        m = re.search(r"^\[ab\].*$", stdout, re.M)
        found = re.findall(r"K\d+f? ([0-9.]+) ms", m.group(0)) if m else []
        return tuple(float(v) for v in found) or None
    turns = {mode: [float(v) for v in re.findall(rf"^\[4\].*\), {mode}: ([0-9.]+) ms/step",
                                                 stdout, re.M)]
             for mode in ("bundle", "eager")}
    if not all(turns.values()):
        return None
    return tuple(sum(v) / len(v) for v in turns.values())


if __name__ == "__main__":
    sys.exit(main())
