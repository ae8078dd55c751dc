"""Streaming mapping engine: initialize -> per-keyframe extend + optimize -> eval.

The counterpart of the JAX package's `engine/trainer.py` (reference mapping
thread, mapping.cpp:124-200, and gaussian.cpp:499-719):

  * `train_step` — render (tiled rasterizer, CUDA blend kernels on the card)
    -> 0.8*L1 + 0.2*(1-SSIM) (gaussian.cpp:691), plus the erank term when
    `lambda_erank > 0` -> autograd backward -> visibility-masked sparse Adam
    on all six groups (optim_utils.h; K7, one launch, on the card; in place
    at the visible rows inside a bundle's CUDA graph).
  * `extend_step` — densification (extend, gaussian.cpp:499-638): alpha-only
    render of the newest keyframe, project the accumulated LiDAR points,
    per-pixel min-depth dedup on the device with two stable sorts, filter
    (in-image, obs-depth > 0, alpha < 0.99), masked append.
  * `_make_train_bundle` — k train steps as one dispatch, the counterpart of
    the JAX package's lax.scan bundle: on the card one CUDA graph of the k
    steps (`BundleGraphs`), captured once per static shape and replayed; on
    the CPU the k eager steps. `parallel.make_sharded_train_bundle` is its
    sharded twin, on the same `BundleGraphs`.
  * `MappingEngine` — the host-side driver with the reference's keyframe
    cadence (every k-th frame trains, the others become held-out test views,
    gaussian.cpp:75-108) and <=100 random-past-keyframe steps per keyframe
    (gaussian.cpp:640-719), run as bundles of `cfg.opt_bundle_sizes` (100 ->
    64 + 16 + 16 + 4); at the end of the run `finalize` (eval on train and
    held-out views, PLY export) and `measure_phase_split` (the
    forward/backward/optimizer split of a step). With a `mesh`
    (parallel.sharded) its steps run tile-band-sharded over the ranks, in
    the same bundles (on the card: CUDA graphs over NCCL).
"""

from __future__ import annotations

import functools
import gc
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from gaussian_lic_tpu_torch.camera import Camera, Intrinsics, matvec
from gaussian_lic_tpu_torch.config import Params
from gaussian_lic_tpu_torch.engine.dataset import (
    FrameInput,
    KeyframeBuffer,
    KeyframeIndex,
    PointAccumulator,
    TestCamera,
    build_camera,
)
from gaussian_lic_tpu_torch.engine.evaluate import evaluate_visual_quality
from gaussian_lic_tpu_torch.io.ply import save_map_ply
from gaussian_lic_tpu_torch.models.gaussians import (
    GaussianMap,
    LearningRates,
    append_gaussians,
    initialize_map,
    point_attributes,
)
from gaussian_lic_tpu_torch.ops import adam as adam_ops
from gaussian_lic_tpu_torch.ops import blend, losses, preprocess
from gaussian_lic_tpu_torch.ops import tiles as tiles_ops
from gaussian_lic_tpu_torch.ops.erank import erank_regularizer
from gaussian_lic_tpu_torch.ops.rasterize import _splat_budget_for, render_map
from gaussian_lic_tpu_torch.utils import trace
from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms
from gaussian_lic_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

PARAM_GROUPS = ("xyz", "dc", "sh_rest", "opacity", "log_scale", "quat")
# The launch counters of the kernels a train step runs (K1/K2, K5/K6, K7,
# K8-K10, K11/K12).
KERNEL_LAUNCHES = (blend.LAUNCHES, preprocess.LAUNCHES, adam_ops.LAUNCHES,
                   tiles_ops.LAUNCHES, losses.LAUNCHES)
MAP_FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit", "count", "exposure")

Device = Union[str, torch.device]


@dataclass
class PhaseTimers:
    """Reference-style accumulated phase timers (mapping.cpp:188-195): the
    seconds of `add_frame`'s spans `frame.ingest` (every frame), `frame.extend`
    and `frame.optimize`, host clock, no synchronize beyond the program's own
    (utils/trace.py `timed`). `compiles` counts what the JAX engine
    compiles: each new bundle size (again after a splat-budget growth), each
    new extend bucket, and the capacity, keyframe-buffer and splat-budget
    growths."""

    optimize_steps: float = 0.0
    adding: float = 0.0
    extending: float = 0.0
    compiles: int = 0


def _render_kw(cfg: Params, capacity: int) -> dict:
    return dict(
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        max_total_splats=_splat_budget_for(capacity, cfg),
    )


def train_step(
    gm: GaussianMap,
    opt_state: Dict[str, adam_ops.AdamState],
    kf: KeyframeBuffer,
    idx: KeyframeIndex,
    exp_step: Union[int, torch.Tensor],
    *,
    intr: Intrinsics,
    cfg: Params,
    with_grads: bool = False,
    in_place: bool = False,
):
    """One train step on keyframe `idx` -> (gm', opt', metrics). Metrics are
    device tensors (no host sync): loss, n_visible, overflow, budget_lost,
    truncated, and with `with_grads` the raw pre-Adam gradients. `idx` and
    `exp_step` may be 0-d device tensors (a CUDA graph's step); the step
    reads the host for nothing and writes none of its inputs. With
    `in_place` (`_make_train_bundle`'s CUDA graphs, which own their state)
    sparse Adam updates gm's six groups and their moments in place at the
    visible rows, and gm' and opt' hold those same tensors."""
    lrs = LearningRates.from_params(cfg)
    cam = kf.camera(intr, idx)
    gt = kf.image(idx).float() / 255.0

    trainable = {k: v.detach().requires_grad_(True) for k, v in gm.trainable().items()}
    gm2 = gm.with_trainable(trainable)
    leaves = [trainable[name] for name in PARAM_GROUPS]
    if cfg.apply_exposure:
        exposure = gm.exposure.detach().requires_grad_(True)
        gm2 = gm2.replace(exposure=exposure)
        leaves.append(exposure)
    out = render_map(gm2, cam, apply_exposure=cfg.apply_exposure,
                     **_render_kw(cfg, gm.capacity))
    loss = losses.training_loss(out.image, gt, cfg.lambda_dssim)
    if cfg.lambda_erank > 0:
        loss = loss + erank_regularizer(gm2.scaling, cfg.lambda_erank)
    grad_list = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {
        name: torch.zeros_like(leaf) if g is None else g
        for name, leaf, g in zip(PARAM_GROUPS + ("exposure",), leaves, grad_list)
    }

    visible = out.visible & gm.active_mask()
    lr_map = dict(
        xyz=lrs.xyz, dc=lrs.dc, sh_rest=lrs.sh_rest,
        opacity=lrs.opacity, log_scale=lrs.log_scale, quat=lrs.quat,
    )
    with torch.no_grad():
        states = {name: opt_state[name] for name in PARAM_GROUPS}
        if in_place:
            adam_ops.sparse_adam_update_groups_(gm.trainable(), grads, states, visible, lr_map,
                                                count=gm.count)
            gm_new, new_opt = gm, states
        else:
            new_trainable, new_opt = adam_ops.sparse_adam_update_groups(
                {name: trainable[name].detach() for name in PARAM_GROUPS}, grads, states,
                visible, lr_map)
            gm_new = gm.with_trainable(new_trainable)
        if cfg.apply_exposure:
            exp_p, exp_st = adam_ops.dense_adam_update(
                gm.exposure, grads["exposure"], opt_state["exposure"],
                lr=cfg.exposure_lr, step_count=exp_step,
            )
            gm_new = gm_new.replace(exposure=exp_p)
            new_opt["exposure"] = exp_st
        elif "exposure" in opt_state:
            new_opt["exposure"] = opt_state["exposure"]

    metrics = {
        "loss": loss.detach(),
        "n_visible": visible.sum(dtype=torch.int32),
        "overflow": out.overflow,
        "budget_lost": out.budget_lost,
        "truncated": out.truncated,
    }
    if with_grads:
        metrics["grads"] = {name: grads[name] for name in PARAM_GROUPS}
    return gm_new, new_opt, metrics


Step = Callable[..., tuple]   # (gm, opt, kf, idx, exp_step) -> (gm', opt', metrics)


def _bundle_metrics(steps: List[dict]) -> dict:
    """The JAX bundle's aggregation of its steps' metrics: loss and
    n_visible of the last step, visible_sum summed, budget_lost and
    truncated maxed (a mid-bundle overflow must trigger the splat-budget
    growth), overflow their sum."""
    bl = torch.stack([m["budget_lost"] for m in steps]).amax()
    tr = torch.stack([m["truncated"] for m in steps]).amax()
    return {
        "loss": steps[-1]["loss"],
        "n_visible": steps[-1]["n_visible"],
        "visible_sum": torch.stack([m["n_visible"] for m in steps]).sum(dtype=torch.int32),
        "budget_lost": bl,
        "truncated": tr,
        "overflow": bl + tr,
    }


def _run_steps(step: Step, gm, opt_state, kf, idxs, es0):
    """len(idxs) steps, step i on keyframe idxs[i] with exposure step es0 + i
    -> (gm', opt', the bundle's metrics)."""
    metrics = []
    for i in range(len(idxs)):
        gm, opt_state, m = step(gm, opt_state, kf, idxs[i], es0 + i)
        metrics.append(m)
    return gm, opt_state, _bundle_metrics(metrics)


def _decompose_bundles(n: int, sizes: tuple) -> List[int]:
    """Greedy decomposition of n iterations into the bundle sizes, as the
    JAX engine's (a size of 1 is implied; Params holds the sizes > 0)."""
    sizes = tuple(sorted(set(sizes) | {1}, reverse=True))
    out: List[int] = []
    for s in sizes:
        while n >= s:
            out.append(s)
            n -= s
    return out


class BundleGraphs:
    """The CUDA graphs of one engine's bundles and the static tensors they
    are captured against.

    One static set holds the map's fields, the Adam moments and the first
    exposure step; every k-step graph of one static shape is captured
    against it and shares one memory pool, and has its own static (k,)
    keyframe ids. Step i of a graph reads ids[i] and es0 + i, and the graph
    ends by copying into the set each tensor of its last step's map and
    moments that is not the set's own: none for `_make_train_bundle`'s step,
    which updates the set in place, all of them for a step that writes
    fresh tensors (the sharded step). So the state returned after a replay
    IS the set and the next bundle starts from it with nothing copied. A
    state that is not the set (after an extend, a growth or a checkpoint
    load) is copied in first; a new shape, keyframe buffer or config (its
    splat budget, its sizes) drops the graphs and makes a new set, since
    all of them are baked in.

    Before the first capture of a set, one step runs eagerly on a side
    stream (a warm-up: it loads the kernels and starts autograd's device
    thread, which a capture must not do), on a clone of the set that is
    then dropped, so the set does not advance.
    The kernels' counters (`KERNEL_LAUNCHES`: K1/K2, K5/K6, K7, K8-K10,
    K11/K12) count the launches whose results the run uses: each graph records the launches
    of its capture (which executes nothing) and adds them at every replay;
    the warm-up's are set aside in `warmup_launches`. A capture or replay
    that fails raises: nothing here falls back to the eager steps. `captures` holds (k, seconds, bytes the
    set's pool reserves after it) per capture.

    A sharded step's set (`mesh` given) is this rank's shard; its graphs
    hold the step's NCCL collectives, which the warm-up issues once first
    (it creates the communicator, which a capture must not do). Every rank
    captures and replays the same graphs in the same order, since every
    rank takes the same host decisions. Captures run in "thread_local"
    error mode: an illegal call of the capturing thread still fails the
    capture; other threads' calls (NCCL's watchdog polls the events of
    earlier collectives) do not count against it."""

    def __init__(self):
        self.key = None
        self.state: Dict[str, torch.Tensor] = {}
        self.captured: Dict[int, tuple] = {}   # k -> (graph, ids, metric outputs, launches)
        self.pool = None
        self.pool_bytes = 0
        self.captures: List[tuple] = []
        self.warmup_launches = {k: 0 for c in KERNEL_LAUNCHES for k in c}

    def run(self, step: Step, cfg: Params, k: int, gm: GaussianMap, opt_state: dict,
            kf: KeyframeBuffer, idxs, es0, mesh=None):
        """The bundle of the k steps of `step` (train_step at `cfg`, or the
        sharded step on `mesh`) on CUDA tensors: copy-in where needed, set
        the ids and es0, replay (capture first at a new k) -> (gm', opt',
        metrics copied out of the graph)."""
        key = (cfg, mesh, gm.device,
               tuple(tuple(getattr(gm, f).shape) for f in MAP_FIELDS),
               tuple((name, tuple(st.exp_avg.shape)) for name, st in opt_state.items()),
               tuple((t.data_ptr(), tuple(t.shape))
                     for t in (kf.R_cw, kf.t_cw, kf.full_proj, kf.images)))
        S = self.state
        with trace.span("bundle.copy_in"):
            if key != self.key:
                self.captured.clear()        # frees their pool
                self.pool, self.pool_bytes, self.key = None, 0, key
                S.clear()
                S.update({name: t.clone() for name, t in self._tensors(gm, opt_state)})
                S["es0"] = torch.zeros((), dtype=torch.int64, device=gm.device)
            else:
                self._store(gm, opt_state)
        S["es0"].fill_(es0)
        if k not in self.captured:
            with trace.span("bundle.capture", k):
                self._capture(step, k, gm, opt_state, kf)
            trace.count("bundle.captures")
        graph, ids, outs, launches = self.captured[k]
        ids.copy_(torch.as_tensor(idxs, device=gm.device))
        with trace.span("bundle.replay", k):
            graph.replay()
        trace.count("bundle.replays")
        for counter in KERNEL_LAUNCHES:
            for name in counter:
                counter[name] += launches[name]
        gm_s, opt_s = self._static(gm, opt_state)
        return gm_s, opt_s, {name: t.clone() for name, t in outs.items()}

    @staticmethod
    def _tensors(gm: GaussianMap, opt_state: dict):
        """(name in the set, tensor) of each map field and Adam moment."""
        return ([(f, getattr(gm, f)) for f in MAP_FIELDS]
                + [(f"{c}_{name}", t) for name, st in opt_state.items()
                   for c, t in (("m", st.exp_avg), ("v", st.exp_avg_sq))])

    def _store(self, gm: GaussianMap, opt_state: dict) -> None:
        """Copies into the set each map field and moment that is not it."""
        for name, t in self._tensors(gm, opt_state):
            if t is not self.state[name]:
                self.state[name].copy_(t)

    def _static(self, gm: GaussianMap, opt_state: dict):
        """The set as a map (gm's static fields) and an Adam state dict."""
        S = self.state
        return (gm.replace(**{f: S[f] for f in MAP_FIELDS}),
                {name: adam_ops.AdamState(S[f"m_{name}"], S[f"v_{name}"])
                 for name in opt_state})

    def _warm_up(self, step: Step, gm_s: GaussianMap, opt_s: dict, kf: KeyframeBuffer,
                 ids: torch.Tensor) -> None:
        """One step on a side stream from a clone of the set, dropped after."""
        dev = gm_s.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), blend.launches_apart(*KERNEL_LAUNCHES) as warm:
            gm_w = gm_s.replace(**{f: getattr(gm_s, f).clone() for f in MAP_FIELDS})
            opt_w = {name: adam_ops.AdamState(st.exp_avg.clone(), st.exp_avg_sq.clone())
                     for name, st in opt_s.items()}
            _run_steps(step, gm_w, opt_w, kf, ids, self.state["es0"])
            del gm_w, opt_w
        torch.cuda.current_stream(dev).wait_stream(side)
        for name, n in warm.items():
            self.warmup_launches[name] += n

    def _capture(self, step: Step, k: int, gm: GaussianMap, opt_state: dict,
                 kf: KeyframeBuffer) -> None:
        gm_s, opt_s = self._static(gm, opt_state)
        dev = gm.device
        ids = torch.zeros(k, dtype=torch.int64, device=dev)
        if not self.captured:
            self._warm_up(step, gm_s, opt_s, kf, ids[:1])
        # A CUDA graph destroyed while another is being captured invalidates
        # the capture, and the collector may reach a dead reference cycle
        # that holds one (an engine dropped earlier) at any allocation:
        # collect first and not during the capture (torch.cuda.graph no
        # longer collects by itself)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with blend.launches_apart(*KERNEL_LAUNCHES) as launches:
                with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                    # entering synchronised and emptied the cache: what the
                    # allocator reserves from here on is this capture's pool
                    reserved = torch.cuda.memory_reserved(dev)
                    gm_k, opt_k, outs = _run_steps(step, gm_s, opt_s, kf, ids,
                                                   self.state["es0"])
                    self._store(gm_k, opt_k)
                    del gm_k, opt_k
        finally:
            if collecting:
                gc.enable()
        if self.pool is None:
            self.pool = graph.pool()
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.captured[k] = (graph, ids, outs, launches)
        self.captures.append((k, time.perf_counter() - t0, self.pool_bytes))


def _bundle_of(step: Step, cfg: Params, k: int, graphs: Optional[BundleGraphs] = None,
               mesh=None, graph_step: Optional[Step] = None):
    """The k steps of `step` (made at `cfg`; the sharded step when `mesh` is
    given) as one dispatch: (gm, opt, kf, idxs (k,), es0) -> (gm', opt',
    metrics), step i on keyframe idxs[i] with exposure step es0 + i, metrics
    aggregated over the bundle as `_bundle_metrics` says.

    Dispatch by the state's device, as the kernel wrappers do: CUDA tensors
    run one CUDA graph of the k steps of `graph_step` (`step` when None; it
    may update the graphs' set in place), captured on the first call against
    the static tensors of `graphs` (shared by an engine's bundles; a
    private set when None) and replayed; CPU tensors run the k eager steps
    of `step`, which give the same floats as k calls of it and write none
    of the caller's tensors. A mesh whose group cannot be captured (gloo)
    raises on CUDA tensors."""
    graphs = BundleGraphs() if graphs is None else graphs
    graph_step = step if graph_step is None else graph_step

    def train_bundle(gm: GaussianMap, opt_state: dict, kf: KeyframeBuffer, idxs, es0):
        if len(idxs) != k:
            raise ValueError(f"a {k}-step bundle got {len(idxs)} keyframe ids")
        kind = gm.device.type
        if kind == "cpu":
            return _run_steps(step, gm, opt_state, kf, idxs, es0)
        if kind != "cuda":
            raise ValueError(f"train bundles run on CPU or CUDA tensors, got {gm.device}")
        if mesh is not None:
            backend = str(dist.get_backend(mesh.group))
            if "nccl" not in backend:
                raise ValueError(f"a CUDA graph cannot capture the collectives of a {backend} "
                                 "process group: run CUDA tensors on an NCCL group")
        return graphs.run(graph_step, cfg, k, gm, opt_state, kf, idxs, es0, mesh=mesh)

    return train_bundle


def _make_train_bundle(intr: Intrinsics, cfg: Params, k: int,
                       graphs: Optional[BundleGraphs] = None):
    """k train steps as one dispatch, the JAX package's `_make_train_bundle`
    (`_bundle_of` of `train_step`; in its CUDA graphs, which own their set,
    the step that updates the set in place)."""
    step = functools.partial(train_step, intr=intr, cfg=cfg)
    return _bundle_of(step, cfg, k, graphs, graph_step=functools.partial(step, in_place=True))


@torch.no_grad()
def extend_step(
    gm: GaussianMap,
    kf: KeyframeBuffer,
    kf_idx: int,
    pts: torch.Tensor,        # (M,3) world points (padded)
    cols: torch.Tensor,       # (M,3)
    obs_depth: torch.Tensor,  # (M,) camera depth at observation frame
    pts_valid: torch.Tensor,  # (M,) bool
    *,
    intr: Intrinsics,
    cfg: Params,
):
    """Densify from keyframe `kf_idx` -> (gm', number appended as a tensor)."""
    W, H = intr.width, intr.height
    BIG = 1 << 30
    cam = kf.camera(intr, kf_idx)
    with trace.span("extend.render"):
        out = render_map(gm, cam, no_color=True, **_render_kw(cfg, gm.capacity))
    alpha = 1.0 - out.final_T  # (H,W) (gaussian.cpp:507)

    # project into the newest keyframe (gaussian.cpp:541-551: x*fx/z + cx, floored)
    p_cam = matvec(cam.pose.R_cw, pts) + cam.pose.t_cw
    z = p_cam[:, 2]
    safe_z = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))

    def pix(v, f, c):
        # clamp before the int conversion: out-of-range stays out of the image
        return torch.clamp(torch.floor(v * f / safe_z + c), -BIG, BIG).to(torch.int64)

    xpix = pix(p_cam[:, 0], intr.fx, intr.cx)
    ypix = pix(p_cam[:, 1], intr.fy, intr.cy)
    in_img = (xpix >= 0) & (xpix < W) & (ypix >= 0) & (ypix < H)
    xc = torch.clamp(xpix, 0, W - 1)
    yc = torch.clamp(ypix, 0, H - 1)
    not_opaque = alpha[yc, xc] < 0.99  # gaussian.cpp:599
    positive = obs_depth > 0.0         # gaussian.cpp:595

    cand = pts_valid & in_img
    # per-pixel min-camera-depth dedup (replaces the CPU hash map,
    # gaussian.cpp:553-581): order by (pixel, z, original index) with two
    # stable sorts, z first
    pix_id = torch.where(cand, yc * W + xc, torch.full_like(xc, BIG))
    by_z = torch.sort(z, stable=True).indices
    s_idx = by_z[torch.sort(pix_id[by_z], stable=True).indices]
    s_pid = pix_id[s_idx]
    first = torch.ones_like(s_pid, dtype=torch.bool)
    first[1:] = s_pid[1:] != s_pid[:-1]
    winner = first & (s_pid < BIG)

    sp = pts[s_idx]
    sc = cols[s_idx]
    sd = obs_depth[s_idx]
    valid = winner & cand[s_idx] & positive[s_idx] & not_opaque[s_idx]
    focal = (intr.fx + intr.fy) / 2.0  # gaussian.cpp:547
    _, dc, _, log_scale, _, opa = point_attributes(
        sp, sc, sd, focal, cfg.scaling_scale, gm.sh_rest.shape[1]
    )
    gm_new = append_gaussians(gm, sp, dc, log_scale, opa, valid)
    return gm_new, valid.sum(dtype=torch.int32)


class MappingEngine:
    """Host-side streaming driver (the mapping thread, mapping.cpp:124-185).
    Every tensor of the run lives on `device`: the card by default (raises
    without CUDA); `device="cpu"` runs the plain versions of the kernels.

    With a `mesh` (parallel.make_mesh; every rank makes its own engine and
    feeds it the same frames) the run lives on the mesh's device and each
    optimize() runs the sharded bundles (parallel.make_sharded_train_bundle;
    on the card CUDA graphs over NCCL) on this rank's shard of the map, then
    gathers the map back whole. Every rank holds the whole map between
    keyframes and takes the same host decisions (the same frames, numpy RNG
    and summed overflow counters), so extend, finalize and checkpoints run
    as without a mesh; only rank 0 writes files and prints."""

    def __init__(self, cfg: Params, result_path: Optional[str] = None,
                 lpips_path: Optional[str] = None, device: Device = DEFAULT_DEVICE,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device,
                                                                          "MappingEngine")
        self.is_main = mesh is None or mesh.rank == 0
        if not self.is_main:
            result_path = None   # rank 0 writes the eval dumps and the PLY
        self.intr = Intrinsics(
            width=cfg.width, height=cfg.height,
            fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
            znear=cfg.znear, zfar=cfg.zfar,
        )
        self.result_path = result_path
        self.lpips_path = lpips_path
        self.gm: Optional[GaussianMap] = None
        self.opt_state: Optional[Dict] = None
        self.kf_buffer = KeyframeBuffer.empty(cfg.max_train_keyframes, self.intr,
                                              device=self.device)
        self.kf_count = 0
        self.test_cameras: List[TestCamera] = []
        self.accum = PointAccumulator()
        self.all_frame_num = 0
        self.exposure_steps = 0
        self.timers = PhaseTimers()
        self.rng = np.random.default_rng(cfg.seed)
        self.last_metrics: Dict[str, float] = {}
        self._overflow_warned = False
        self._kf_names: List[str] = []
        self._extend_shapes: set = set()
        self._bundles: Dict[int, Callable] = {}
        self.graphs = BundleGraphs()   # the bundles' CUDA graphs on the card

    # ------------------------------------------------------------------ frames

    @property
    def initialized(self) -> bool:
        return self.gm is not None

    def add_frame(self, frame: FrameInput) -> bool:
        """Process one aligned frame; returns True if it became a keyframe
        (Dataset::addFrame + mapping loop steps [2]-[5]). The span `frame`
        (the frame id its id) holds `frame.ingest`, then for a keyframe
        `frame.initialize` or `frame.extend`, and `frame.optimize`."""
        frame_id = self.all_frame_num
        with trace.span("frame", frame_id):
            with trace.timed("frame.ingest", frame_id) as ingest:
                is_kf = self._ingest(frame, frame_id)
            self.timers.adding += ingest.seconds
            if not is_kf:
                return False
            if not self.initialized:
                with trace.span("frame.initialize", frame_id):
                    self._initialize()
            else:
                with trace.timed("frame.extend", frame_id) as extend:
                    self._extend(self.kf_count - 1)
                self.timers.extending += extend.seconds
            with trace.timed("frame.optimize", frame_id) as opt:
                self.optimize()
            self.timers.optimize_steps += opt.seconds
        return True

    def _ingest(self, frame: FrameInput, frame_id: int) -> bool:
        """Takes the frame's points, then its pose and image: a held-out
        test view, or the next keyframe of the buffer (True)."""
        self.accum.add(frame)
        self.all_frame_num += 1
        if (frame_id + 1) % self.cfg.select_every_k_frame != 0:
            self.test_cameras.append(
                TestCamera(
                    name=f"test_{frame_id:04d}",
                    R_wc=np.asarray(frame.R_wc, np.float32),
                    t_wc=np.asarray(frame.t_wc, np.float32),
                    image_u8=frame.image_u8(),
                )
            )
            return False
        cam = build_camera(self.intr, frame, device=self.device)
        if self.kf_count >= self.kf_buffer.images.shape[0]:
            self.kf_buffer = self.kf_buffer.grow(2 * self.kf_buffer.images.shape[0])
            self.timers.compiles += 1
            trace.count("kf_buffer.growths")
        self.kf_buffer.set_frame(self.kf_count, cam, frame.image_u8())
        self.kf_count += 1
        self._kf_names.append(f"train_{frame_id:04d}")
        return True

    # ------------------------------------------------------------- init/extend

    def _initialize(self) -> None:
        pts, cols, depths = self.accum.take()
        cfg = self.cfg
        self.gm = initialize_map(
            pts, cols, depths,
            focal=(cfg.fx + cfg.fy) / 2.0,
            scaling_scale=cfg.scaling_scale,
            sh_degree=cfg.sh_degree,
            capacity=cfg.initial_capacity,
            skybox_points_num=cfg.skybox_points_num,
            skybox_radius=cfg.skybox_radius,
            seed=cfg.seed,
            device=self.device,
        )
        self.opt_state = {
            name: adam_ops.AdamState.zeros_like(self.gm.trainable()[name])
            for name in PARAM_GROUPS
        }
        if cfg.apply_exposure:
            self.opt_state["exposure"] = adam_ops.AdamState.zeros_like(self.gm.exposure)

    def _grow_if_needed(self, incoming: int) -> None:
        needed = trace.sync("extend_count", int, self.gm.count) + incoming
        cap = self.gm.capacity
        if needed <= cap:
            return
        new_cap = cap
        while new_cap < needed:
            new_cap *= 2
        self.gm = self.gm.grow(new_cap)
        trace.count("map.growths")
        self.opt_state = {
            name: adam_ops.AdamState(
                _pad_like(st.exp_avg, self.gm.trainable()[name]),
                _pad_like(st.exp_avg_sq, self.gm.trainable()[name]),
            )
            if name in PARAM_GROUPS
            else st
            for name, st in self.opt_state.items()
        }
        self.timers.compiles += 1

    def _extend(self, kf_idx: int) -> int:
        cfg = self.cfg
        pts, cols, depths = self.accum.take()
        n = pts.shape[0]
        # every accumulated point is processed (gaussian.cpp:541-627); batches
        # pad to a power-of-two multiple of densify_budget, as in the JAX
        # package, so the tensors of an extend take few distinct shapes
        M = cfg.densify_budget
        while M < n:
            M *= 2
        if M not in self._extend_shapes:   # a jit compile in the JAX engine
            self._extend_shapes.add(M)
            self.timers.compiles += 1
        self._grow_if_needed(n)
        pad = M - n
        f32 = dict(dtype=torch.float32, device=self.device)
        with trace.span("extend.upload"):
            pts_p = trace.upload(np.concatenate([pts, np.zeros((pad, 3), np.float32)]), **f32)
            cols_p = trace.upload(np.concatenate([cols, np.zeros((pad, 3), np.float32)]), **f32)
            dep_p = trace.upload(np.concatenate([depths, np.zeros((pad,), np.float32)]), **f32)
            valid = trace.upload(np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
                                 device=self.device)
        self.gm, added = extend_step(
            self.gm, self.kf_buffer, kf_idx, pts_p, cols_p, dep_p, valid,
            intr=self.intr, cfg=cfg,
        )
        added = trace.sync("extend_count", int, added)
        trace.count("extend.candidates", n)
        trace.count("extend.added", added)
        return added

    # ---------------------------------------------------------------- optimize

    def _get_bundle(self, k: int) -> Callable:
        """The k-step bundle at the current config, made once per k (a
        compile, as JAX's jit of it; the cache is dropped when the splat
        budget grows). On the card its CUDA graph is captured at its first
        call, against `self.graphs`' static set, and again when the map's
        or the keyframe buffer's shape changes. With a mesh: the sharded
        bundle on this rank's shard, its graphs in the same set."""
        fn = self._bundles.get(k)
        if fn is None:
            if self.mesh is not None:
                from gaussian_lic_tpu_torch.parallel import make_sharded_train_bundle

                fn = make_sharded_train_bundle(self.intr, self.cfg, self.mesh, k, self.graphs)
            else:
                fn = _make_train_bundle(self.intr, self.cfg, k, self.graphs)
            self._bundles[k] = fn
            self.timers.compiles += 1
        return fn

    def optimize(self, max_iters: Optional[int] = None) -> float:
        """<=100 steps over shuffled random past keyframes (optimize,
        gaussian.cpp:640-719), drawn from the same numpy RNG sequence as the
        JAX engine, and run as bundles of cfg.opt_bundle_sizes (100 -> 64 +
        16 + 16 + 4: on the card 4 graph replays, not 100 steps of ~1,500
        launches each). Returns the mean number of updated Gaussians."""
        cfg = self.cfg
        max_iters = max_iters or cfg.max_iters_per_keyframe
        n_kf = self.kf_count
        if n_kf == 0 or not self.initialized:
            return 0.0
        with trace.span("optimize", n_kf):
            with trace.span("optimize.draw"):
                if n_kf <= max_iters:
                    opt_list = np.arange(n_kf)
                else:
                    opt_list = self.rng.choice(n_kf, size=max_iters, replace=False)
                self.rng.shuffle(opt_list)
                if len(opt_list) == 0:
                    return 0.0
                idxs = trace.upload(opt_list.astype(np.int64), device=self.device)

            visible, budget_lost, truncated = [], [], []
            gm, opt_state = self.gm, self.opt_state
            if self.mesh is not None:
                from gaussian_lic_tpu_torch.parallel import shard_state

                gm, opt_state = shard_state(gm, opt_state, self.mesh)
            pos = 0
            for k in _decompose_bundles(len(opt_list), cfg.opt_bundle_sizes):
                with trace.span("bundle", k):
                    gm, opt_state, metrics = self._get_bundle(k)(
                        gm, opt_state, self.kf_buffer, idxs[pos:pos + k],
                        self.exposure_steps + 1)
                pos += k
                self.exposure_steps += k
                # metrics stay on the device until the fetches below
                visible.append(metrics["visible_sum"])
                budget_lost.append(metrics["budget_lost"])
                truncated.append(metrics["truncated"])
            if self.mesh is not None:
                from gaussian_lic_tpu_torch.parallel import gather_state

                gm, opt_state = gather_state(gm, opt_state, self.mesh)
            self.gm, self.opt_state = gm, opt_state
            stats = trace.sync("fetch", torch.Tensor.tolist, torch.stack([
                torch.stack(visible).sum(dtype=torch.int64),
                torch.stack(budget_lost).max().to(torch.int64),
                torch.stack(truncated).max().to(torch.int64),
                metrics["n_visible"].to(torch.int64),
            ]))
            loss = trace.sync("fetch", float, metrics["loss"])
            updated, max_budget_lost, max_truncated, n_visible = stats
            # the rows sparse Adam updated against the rows the map holds
            trace.count("adam.updated_rows", updated)
            trace.count("adam.rows", len(opt_list) * self.gm.capacity)
            self.last_metrics = {
                "loss": loss,
                "n_visible": float(n_visible),
                "budget_lost": float(max_budget_lost),
                "truncated": float(max_truncated),
                "overflow": float(max_budget_lost + max_truncated),
            }
            if max_budget_lost > 0 or max_truncated > 0:
                self._handle_overflow(max_budget_lost, max_truncated)
        return updated / max(len(opt_list), 1)

    def _handle_overflow(self, budget_lost: int, truncated: int) -> None:
        """Binning overflow -> grow the splat-list budget x1.5 (the reference
        resizes its splat buffers lazily, rasterize_points.cu:40-48). Only
        `budget_lost` is fixable this way; `truncated` slots need a larger
        `max_tiles_per_gaussian`, so warn once instead."""
        cfg = self.cfg
        if truncated > 0 and not self._overflow_warned:
            self._overflow_warned = True
            self._print(
                f"[gaussian-lic-tpu-torch] WARNING: {truncated} rect tiles truncated "
                "at the per-Gaussian slot cap — large-footprint Gaussians exceed "
                f"max_tiles_per_gaussian={cfg.max_tiles_per_gaussian}; raise it "
                "(16/32) to render them fully"
            )
        if budget_lost <= 0:
            return
        if cfg.splat_budget_factor < cfg.max_tiles_per_gaussian:
            # grow from the EFFECTIVE budget (the factor may sit below the
            # 4096-entry floor of _splat_budget_for at small capacities)
            cap = max(self.gm.capacity, 1)
            eff = _splat_budget_for(cap, cfg) / cap
            new_f = min(
                max(cfg.splat_budget_factor, eff) * 1.5,
                float(cfg.max_tiles_per_gaussian),
            )
            self.cfg = cfg.replace(splat_budget_factor=new_f)
            self.timers.compiles += 1
            self._bundles.clear()   # the budget is baked into the bundles
            self._print(
                f"[gaussian-lic-tpu-torch] binning overflow ({budget_lost} slots "
                "past the splat budget): splat budget grows "
                f"{cfg.splat_budget_factor:g} -> {new_f:g} entries/Gaussian"
            )
        elif not self._overflow_warned:
            self._overflow_warned = True
            self._print(
                f"[gaussian-lic-tpu-torch] WARNING: binning overflow ({budget_lost} "
                "slots) with the splat budget already at the per-Gaussian "
                "slot cap — raise max_tiles_per_gaussian to grow further"
            )

    # ---------------------------------------------------------------- finalize

    def finalize(self) -> Dict[str, Optional[float]]:
        """End of stream: eval and PLY export (mapping.cpp:186-199)."""
        results: Dict[str, Optional[float]] = {}
        if not self.initialized:
            return results
        results.update(evaluate_visual_quality(self, result_path=self.result_path,
                                               lpips_path=self.lpips_path))
        if self.result_path:
            os.makedirs(self.result_path, exist_ok=True)
            save_map_ply(os.path.join(self.result_path, "point_cloud.ply"), self.gm)
        results["num_gaussians"] = float(int(self.gm.count))
        return results

    def measure_phase_split(self, iters: int = 5) -> Dict[str, float]:
        """Forward/backward/optimizer time split of one train step on the
        final map and keyframe 0 (the reference prints these live,
        mapping.cpp:188-195). Times three nested prefixes of the step, the
        loss, loss + gradients and the whole step, `iters` times each after
        one warm-up (CUDA events on the card, the host clock on the CPU), and
        differences them: forward = t(loss), backward = t(grad) - t(loss),
        optimizer = t(step) - t(grad). One device only: the sharded step's
        phases overlap its collectives, so with a mesh it returns {}."""
        if not self.initialized or self.kf_count == 0:
            return {}
        if self.mesh is not None:
            print("[phase-split] sharded step: phases overlap with "
                  "collectives; reporting whole-step only")
            return {}
        cfg, intr = self.cfg, self.intr
        kw = dict(apply_exposure=cfg.apply_exposure, **_render_kw(cfg, self.gm.capacity))
        cam = self.kf_buffer.camera(intr, 0)
        gt = self.kf_buffer.images[0].float() / 255.0
        exp_step = max(self.exposure_steps, 1)

        def loss_only():
            with torch.no_grad():
                out = render_map(self.gm, cam, **kw)
                return losses.training_loss(out.image, gt, cfg.lambda_dssim)

        def loss_and_grad():
            trainable = {k: v.detach().requires_grad_(True)
                         for k, v in self.gm.trainable().items()}
            out = render_map(self.gm.with_trainable(trainable), cam, **kw)
            loss = losses.training_loss(out.image, gt, cfg.lambda_dssim)
            return torch.autograd.grad(loss, list(trainable.values()), allow_unused=True)

        def whole_step():
            return train_step(self.gm, self.opt_state, self.kf_buffer, 0, exp_step,
                              intr=intr, cfg=cfg)

        def timeit(fn) -> float:
            if self.device.type == "cuda":
                return cuda_ms(fn, iters)
            fn()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters * 1e3

        t_fwd, t_fb, t_step = timeit(loss_only), timeit(loss_and_grad), timeit(whole_step)
        split = {
            "forward_ms": round(t_fwd, 2),
            "backward_ms": round(max(t_fb - t_fwd, 0.0), 2),
            "optimizer_ms": round(max(t_step - t_fb, 0.0), 2),
            "whole_step_ms": round(t_step, 2),
        }
        print("===== per-phase step split (cf. mapping.cpp:188-195) =====")
        print(f"  forward   : {split['forward_ms']:.2f} ms")
        print(f"  backward  : {split['backward_ms']:.2f} ms")
        print(f"  optimizer : {split['optimizer_ms']:.2f} ms")
        print(f"  whole step: {split['whole_step_ms']:.2f} ms  "
              "(CPU2GPU: none — keyframes are device-resident)")
        return split

    def train_camera(self, idx: int) -> Camera:
        return self.kf_buffer.camera(self.intr, idx)

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg)


def _pad_like(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    extra = target.shape[0] - x.shape[0]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])], dim=0)
