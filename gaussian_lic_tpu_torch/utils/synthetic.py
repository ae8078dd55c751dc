"""Synthetic LiDAR-camera sequences for tests and benchmarks.

The JAX package's `utils/synthetic.py` with the same numpy draws: a world of
colored surfel points, a smooth camera trajectory, GT images rendered from
the ground-truth Gaussian scene, and per-frame "LiDAR" returns (the world
points in front of the camera, colorized). GT images render through this
package's `render_tiled` at every size (the JAX version uses its dense oracle
for n <= 2048), so tests that compare the two packages build their frames
with the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from gaussian_lic_tpu_torch.camera import Camera, Intrinsics, look_at, make_camera
from gaussian_lic_tpu_torch.engine.dataset import FrameInput, KeyframeBuffer, build_camera

Device = Union[str, torch.device]


@dataclass
class SyntheticWorld:
    points: np.ndarray     # (N,3)
    colors: np.ndarray     # (N,3) in [0,1]
    scales: np.ndarray     # (N,3) GT gaussian scales
    opacity: np.ndarray    # (N,)
    intr: Intrinsics

    def gt_camera(self, t: float, device: Device = "cpu") -> Camera:
        eye = np.array([3.0 * np.cos(t), 3.0 * np.sin(t), -6.0])
        R_wc, t_wc = look_at(eye, np.array([0.0, 0.0, 2.0]), up=(0.0, -1.0, 0.0))
        return make_camera(self.intr, R_wc, t_wc, device=device)

    @torch.no_grad()
    def render_gt(self, cam: Camera) -> np.ndarray:
        """(3, H, W) GT image in [0, 1] from the ground-truth Gaussian scene,
        rendered on the camera's device."""
        from gaussian_lic_tpu_torch.ops import sh as sh_ops
        from gaussian_lic_tpu_torch.ops.rasterize import render_tiled

        n = len(self.points)
        f32 = dict(dtype=torch.float32, device=cam.device)
        quat = torch.zeros((n, 4), **f32)
        quat[:, 0] = 1.0
        budget = 1 << max(int(np.ceil(np.log2(max(n, 1) * 4))), 12)
        out = render_tiled(
            torch.as_tensor(self.points, **f32),
            torch.as_tensor(self.scales, **f32),
            quat,
            torch.as_tensor(self.opacity, **f32),
            cam,
            dc=sh_ops.rgb_to_sh(torch.as_tensor(self.colors, **f32)),
            sh_rest=torch.zeros((n, 15, 3), **f32),
            max_total_splats=budget,
        )
        return out.image.clamp(0.0, 1.0).cpu().numpy()


def make_world(
    rng: np.random.Generator,
    n_points: int = 400,
    intr: Optional[Intrinsics] = None,
) -> SyntheticWorld:
    if intr is None:
        intr = Intrinsics(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0)
    # a colored blob field in front of the trajectory
    pts = np.stack(
        [
            rng.uniform(-4, 4, n_points),
            rng.uniform(-2, 2, n_points),
            rng.uniform(0.0, 4.0, n_points),
        ],
        axis=1,
    ).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (n_points, 3)).astype(np.float32)
    scales = (np.abs(rng.normal(size=(n_points, 3))) * 0.1 + 0.08).astype(np.float32)
    opacity = rng.uniform(0.5, 0.95, n_points).astype(np.float32)
    return SyntheticWorld(pts, colors, scales, opacity, intr)


def make_sequence(
    world: SyntheticWorld,
    n_frames: int = 15,
    points_per_frame: int = 120,
    rng: Optional[np.random.Generator] = None,
    start_t: float = 0.0,
    dt: float = 0.02,
    device: Device = "cpu",
) -> List[FrameInput]:
    """Frames along the trajectory: GT image + per-frame LiDAR point subset."""
    rng = rng or np.random.default_rng(0)
    frames = []
    for i in range(n_frames):
        t = start_t + i * dt
        cam = world.gt_camera(t, device=device)
        img = world.render_gt(cam)
        img_u8 = np.clip(np.transpose(img, (1, 2, 0)) * 255.0, 0, 255).astype(np.uint8)
        # LiDAR: points in front of the camera, random subset, colorized from GT
        R_cw = cam.pose.R_cw.cpu().numpy()
        t_cw = cam.pose.t_cw.cpu().numpy()
        z = (world.points @ R_cw.T + t_cw)[:, 2]
        vis = np.where(z > 0.3)[0]
        sel = rng.choice(vis, size=min(points_per_frame, len(vis)), replace=False)
        frames.append(
            FrameInput(
                timestamp=t,
                R_wc=R_cw.T,
                t_wc=cam.cam_center.cpu().numpy(),
                image=img_u8,
                points=world.points[sel],
                colors=world.colors[sel],
            )
        )
    return frames


def make_bench_state(cfg, n_gauss: int, device: Device, n_kf: int = 4, seed: int = 0):
    """A map of `n_gauss` Gaussians filling the camera frustum, 4 keyframes of
    random images and zero Adam moments: the train-step benchmark state
    (the recipe of the JAX package's bench.py:28-62). Returns
    (intr, gm, kf_buffer, opt_state)."""
    from gaussian_lic_tpu_torch.models.gaussians import initialize_map
    from gaussian_lic_tpu_torch.ops.adam import AdamState

    intr = Intrinsics(cfg.width, cfg.height, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 30.0, n_gauss).astype(np.float32)
    x = rng.uniform(-0.7, 0.7, n_gauss).astype(np.float32) * z
    y = rng.uniform(-0.55, 0.55, n_gauss).astype(np.float32) * z
    cols = rng.uniform(0.05, 0.95, (n_gauss, 3)).astype(np.float32)
    gm = initialize_map(np.stack([x, y, z], 1), cols, z, focal=(cfg.fx + cfg.fy) / 2.0,
                        scaling_scale=cfg.scaling_scale, sh_degree=cfg.sh_degree,
                        capacity=max(cfg.initial_capacity, n_gauss), device=device)
    kf = KeyframeBuffer.empty(n_kf, intr, device=device)
    for i in range(n_kf):
        eye = np.array([0.3 * np.sin(i), 0.2 * np.cos(i), -1.0 - 0.1 * i])
        R_wc, t_wc = look_at(eye, np.array([0.0, 0.0, 10.0]), up=(0.0, -1.0, 0.0))
        img = rng.integers(0, 255, (intr.height, intr.width, 3), dtype=np.uint8)
        frame = FrameInput(float(i), R_wc, t_wc, img, np.zeros((0, 3), np.float32),
                           np.zeros((0, 3), np.float32))
        kf.set_frame(i, build_camera(intr, frame, device=device), img)
    opt = {k: AdamState.zeros_like(v) for k, v in gm.trainable().items()}
    return intr, gm, kf, opt
