"""Streaming mapping engine: initialize -> per-keyframe extend + optimize -> eval.

The counterpart of the JAX package's `engine/trainer.py` (reference mapping
thread, mapping.cpp:124-200, and gaussian.cpp:499-719):

  * `train_step` — render (tiled rasterizer, CUDA blend kernels on the card)
    -> 0.8*L1 + 0.2*(1-SSIM) (gaussian.cpp:691), plus the erank term when
    `lambda_erank > 0` -> autograd backward -> visibility-masked sparse Adam
    on all six groups (optim_utils.h).
  * `extend_step` — densification (extend, gaussian.cpp:499-638): alpha-only
    render of the newest keyframe, project the accumulated LiDAR points,
    per-pixel min-depth dedup on the device with two stable sorts, filter
    (in-image, obs-depth > 0, alpha < 0.99), masked append.
  * `MappingEngine` — the host-side driver with the reference's keyframe
    cadence (every k-th frame trains, the others become held-out test views,
    gaussian.cpp:75-108) and <=100 random-past-keyframe steps per keyframe
    (gaussian.cpp:640-719), run one step at a time; at the end of the run
    `finalize` (eval on train and held-out views, PLY export) and
    `measure_phase_split` (the forward/backward/optimizer split of a step).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from gaussian_lic_tpu_torch.camera import Camera, Intrinsics, matvec
from gaussian_lic_tpu_torch.config import Params
from gaussian_lic_tpu_torch.engine.dataset import (
    FrameInput,
    KeyframeBuffer,
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
from gaussian_lic_tpu_torch.ops import losses
from gaussian_lic_tpu_torch.ops.erank import erank_regularizer
from gaussian_lic_tpu_torch.ops.rasterize import _splat_budget_for, render_map
from gaussian_lic_tpu_torch.utils.cuda_timing import cuda_ms

PARAM_GROUPS = ("xyz", "dc", "sh_rest", "opacity", "log_scale", "quat")

Device = Union[str, torch.device]


@dataclass
class PhaseTimers:
    """Reference-style accumulated phase timers (mapping.cpp:188-195).
    `compiles` counts static-shape changes (capacity, keyframe buffer and
    splat-budget growth)."""

    total_mapping: float = 0.0
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
    idx: int,
    exp_step: int,
    *,
    intr: Intrinsics,
    cfg: Params,
    with_grads: bool = False,
):
    """One train step on keyframe `idx` -> (gm', opt', metrics). Metrics are
    device tensors (no host sync): loss, n_visible, overflow, budget_lost,
    truncated, and with `with_grads` the raw pre-Adam gradients."""
    lrs = LearningRates.from_params(cfg)
    cam = kf.camera(intr, idx)
    gt = kf.images[idx].float() / 255.0

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
    new_trainable = {}
    new_opt = {}
    with torch.no_grad():
        for name in PARAM_GROUPS:
            p, st = adam_ops.sparse_adam_update(
                trainable[name].detach(), grads[name], opt_state[name], visible,
                lr_map[name],
            )
            new_trainable[name] = p
            new_opt[name] = st
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
    Every tensor of the run lives on `device`."""

    def __init__(self, cfg: Params, result_path: Optional[str] = None,
                 lpips_path: Optional[str] = None, device: Device = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
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

    # ------------------------------------------------------------------ frames

    @property
    def initialized(self) -> bool:
        return self.gm is not None

    def add_frame(self, frame: FrameInput) -> bool:
        """Process one aligned frame; returns True if it became a keyframe
        (Dataset::addFrame + mapping loop steps [2]-[5])."""
        t0 = time.perf_counter()
        self.accum.add(frame)
        is_kf = (self.all_frame_num + 1) % self.cfg.select_every_k_frame == 0
        frame_id = self.all_frame_num
        self.all_frame_num += 1

        if not is_kf:
            self.test_cameras.append(
                TestCamera(
                    name=f"test_{frame_id:04d}",
                    R_wc=np.asarray(frame.R_wc, np.float32),
                    t_wc=np.asarray(frame.t_wc, np.float32),
                    image_u8=frame.image_u8(),
                )
            )
            return False

        # --- keyframe path ---
        cam = build_camera(self.intr, frame, device=self.device)
        if self.kf_count >= self.kf_buffer.images.shape[0]:
            self.kf_buffer = self.kf_buffer.grow(2 * self.kf_buffer.images.shape[0])
            self.timers.compiles += 1
        self.kf_buffer.set_frame(self.kf_count, cam, frame.image_u8())
        kf_idx = self.kf_count
        self.kf_count += 1
        self._kf_names.append(f"train_{frame_id:04d}")
        self.timers.adding += time.perf_counter() - t0

        if not self.initialized:
            self._initialize()
        else:
            t0 = time.perf_counter()
            self._extend(kf_idx)
            self.timers.extending += time.perf_counter() - t0
        t0 = time.perf_counter()
        self.optimize()
        self.timers.total_mapping += time.perf_counter() - t0
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
        needed = int(self.gm.count) + incoming
        cap = self.gm.capacity
        if needed <= cap:
            return
        new_cap = cap
        while new_cap < needed:
            new_cap *= 2
        self.gm = self.gm.grow(new_cap)
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
        self._grow_if_needed(n)
        pad = M - n
        f32 = dict(dtype=torch.float32, device=self.device)
        pts_p = torch.as_tensor(np.concatenate([pts, np.zeros((pad, 3), np.float32)]), **f32)
        cols_p = torch.as_tensor(np.concatenate([cols, np.zeros((pad, 3), np.float32)]), **f32)
        dep_p = torch.as_tensor(np.concatenate([depths, np.zeros((pad,), np.float32)]), **f32)
        valid = torch.as_tensor(np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
                                device=self.device)
        self.gm, added = extend_step(
            self.gm, self.kf_buffer, kf_idx, pts_p, cols_p, dep_p, valid,
            intr=self.intr, cfg=cfg,
        )
        return int(added)

    # ---------------------------------------------------------------- optimize

    def optimize(self, max_iters: Optional[int] = None) -> float:
        """<=100 steps over shuffled random past keyframes (optimize,
        gaussian.cpp:640-719), drawn from the same numpy RNG sequence as the
        JAX engine. Returns the mean number of updated Gaussians."""
        cfg = self.cfg
        max_iters = max_iters or cfg.max_iters_per_keyframe
        n_kf = self.kf_count
        if n_kf == 0 or not self.initialized:
            return 0.0
        if n_kf <= max_iters:
            opt_list = np.arange(n_kf)
        else:
            opt_list = self.rng.choice(n_kf, size=max_iters, replace=False)
        self.rng.shuffle(opt_list)
        if len(opt_list) == 0:
            return 0.0

        visible, budget_lost, truncated = [], [], []
        t0 = time.perf_counter()
        for idx in opt_list:
            self.exposure_steps += 1
            self.gm, self.opt_state, metrics = train_step(
                self.gm, self.opt_state, self.kf_buffer, int(idx),
                self.exposure_steps, intr=self.intr, cfg=cfg,
            )
            # metrics stay on the device until the one fetch below
            visible.append(metrics["n_visible"])
            budget_lost.append(metrics["budget_lost"])
            truncated.append(metrics["truncated"])
        stats = torch.stack([
            torch.stack(visible).sum(dtype=torch.int64),
            torch.stack(budget_lost).max().to(torch.int64),
            torch.stack(truncated).max().to(torch.int64),
            metrics["n_visible"].to(torch.int64),
        ]).tolist()
        loss = float(metrics["loss"])
        self.timers.optimize_steps += time.perf_counter() - t0
        updated, max_budget_lost, max_truncated, n_visible = stats
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
            print(
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
            print(
                f"[gaussian-lic-tpu-torch] binning overflow ({budget_lost} slots "
                "past the splat budget): splat budget grows "
                f"{cfg.splat_budget_factor:g} -> {new_f:g} entries/Gaussian"
            )
        elif not self._overflow_warned:
            self._overflow_warned = True
            print(
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
        optimizer = t(step) - t(grad)."""
        if not self.initialized or self.kf_count == 0:
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


def _pad_like(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    extra = target.shape[0] - x.shape[0]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])], dim=0)
