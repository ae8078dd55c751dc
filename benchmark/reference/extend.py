"""The plain reference of Gaussian-LIC's map extension (densification), in
plain PyTorch. It imports nothing of the program.

Written from the original's `GaussianModel::extend` (gaussian.cpp:499-638),
not from the port's code: the LiDAR points gathered since the last keyframe,
each with the depth it had in the camera that observed it, are projected
into the newest keyframe's camera, floored to a pixel (gaussian.cpp:541-551:
x fx / z + cx), kept where the pixel lies in the image and the observed
depth is positive; of the points that land on one pixel the one nearest the
new camera is the pixel's only candidate (gaussian.cpp:553-581; equal depths
go to the point that came first), and it becomes a Gaussian where the
current map's render of that view is not yet opaque: its alpha, 1 - the
render's final transmittance, under 0.99 (gaussian.cpp:585-606). A new
Gaussian starts as the map's first ones did (gaussian.cpp:612-627): its
colour as the SH DC term (c - 0.5) / C0, an isotropic log scale
log(scaling_scale d / f) of its observed depth d and the mean focal length
f, the identity rotation, opacity 0.1 and zero higher SH. The new Gaussians
are written after the map's live rows, in the order of their pixels
(row-major).

The render is `splat.render`, the plain reference of the port's renderer.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from reference import splat

ALPHA_LIMIT = 0.99
# a depth this close to 0 is taken as 1e-8 before the division, as the
# program does: a point on the camera's plane projects far out of the image
MIN_ABS_Z = 1e-8
# pixel coordinates are clamped to +-2^30 before the integer conversion, as
# the program does: a far-out point stays out of the image
PIX_CLAMP = float(1 << 30)


def observed_depths(points: np.ndarray, R_wc: np.ndarray, t_wc: np.ndarray) -> np.ndarray:
    """Each point's depth in the camera that observed it (gaussian.cpp:66-70),
    in float64 and rounded to float32."""
    R_cw = np.asarray(R_wc, np.float64).T
    t_cw = -R_cw @ np.asarray(t_wc, np.float64)
    return (np.asarray(points, np.float64) @ R_cw.T + t_cw)[:, 2].astype(np.float32)


def gathered(frames) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points, colours, observed depths) of frames given as dicts with
    `points`, `colors`, `R_wc`, `t_wc`, in order; a point whose observed
    depth is not positive is left out, as the original asserts it away."""
    pts, cols, deps = [], [], []
    for f in frames:
        d = observed_depths(f["points"], f["R_wc"], f["t_wc"])
        keep = d > 0
        pts.append(np.asarray(f["points"], np.float32)[keep])
        cols.append(np.asarray(f["colors"], np.float32)[keep])
        deps.append(d[keep])
    return np.concatenate(pts), np.concatenate(cols), np.concatenate(deps)


def pixels(pts: torch.Tensor, cam: splat.Cam, cx: float, cy: float):
    """(x pixel, y pixel, depth in the camera) of world points, floored."""
    p = (cam.R_cw * pts.unsqueeze(-2)).sum(-1) + cam.t_cw
    z = p[:, 2]
    zs = torch.where(z.abs() > MIN_ABS_Z, z, torch.full_like(z, MIN_ABS_Z))

    def floor(v, f, c):
        return torch.clamp(torch.floor(v * f / zs + c), -PIX_CLAMP, PIX_CLAMP).to(torch.int64)

    return floor(p[:, 0], cam.fx, cx), floor(p[:, 1], cam.fy, cy), z


def nearest_per_pixel(pix: torch.Tensor, z: torch.Tensor, n_pix: int) -> torch.Tensor:
    """The candidate of each pixel: a mask of the points whose depth `z` is
    the least on their pixel `pix` (-1: no pixel), the first such point
    where several share it."""
    on = pix >= 0
    idx = torch.arange(pix.shape[0], device=pix.device)
    slot = torch.where(on, pix, n_pix)
    zmin = torch.full((n_pix + 1,), float("inf"), dtype=z.dtype, device=z.device)
    zmin.scatter_reduce_(0, slot, z, reduce="amin")
    tied = on & (z == zmin[slot])
    first = torch.full((n_pix + 1,), pix.shape[0], dtype=torch.int64, device=pix.device)
    first.scatter_reduce_(0, slot[tied], idx[tied], reduce="amin")
    return on & (first[slot] == idx)


def extend(params: Dict[str, torch.Tensor], count: int, cam: splat.Cam, pts: np.ndarray,
           cols: np.ndarray, depths: np.ndarray, p: dict, budget: int,
           winners: Callable = nearest_per_pixel, alpha_limit: float = ALPHA_LIMIT):
    """The map after one extension from keyframe camera `cam` -> (params,
    the new count, the number appended). `params` (rows in their first dim;
    keys xyz, dc, sh_rest, opacity, log_scale, quat) is left as it was;
    `budget` is the render's splat budget. `winners` and `alpha_limit` let a
    control put a fault in the pixel's choice or the opacity test."""
    dev = params["xyz"].device
    W, H = cam.width, cam.height
    _, _, _, _, final_t, _ = splat.render(params, count, cam, p["tile_h"],
                                          p["max_tiles_per_gaussian"], budget)
    alpha = 1.0 - final_t[:H, :W]
    f32 = dict(dtype=torch.float32, device=dev)
    pts_t, cols_t, dep_t = (torch.as_tensor(a, **f32) for a in (pts, cols, depths))
    x, y, z = pixels(pts_t, cam, p["cx"], p["cy"])
    inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    pix = torch.where(inside, y * W + x, torch.full_like(x, -1))
    see_through = torch.zeros_like(inside)
    see_through[inside] = alpha[y[inside], x[inside]] < alpha_limit
    keep = winners(pix, z, W * H) & (dep_t > 0) & see_through
    order = torch.argsort(torch.where(keep, pix, W * H))[:int(keep.sum())]
    n_new = min(order.shape[0], params["xyz"].shape[0] - count)
    order = order[:n_new]
    focal = (p["fx"] + p["fy"]) / 2.0
    d = dep_t[order]
    new = dict(xyz=pts_t[order], dc=(cols_t[order] - 0.5) / splat.SH_C0,
               sh_rest=torch.zeros((n_new,) + params["sh_rest"].shape[1:], **f32),
               opacity=torch.full((n_new,), float(np.log(0.1 / (1.0 - 0.1))), **f32),
               log_scale=torch.log(torch.clamp_min(p["scaling_scale"] * d / focal, 1e-10))
               [:, None].expand(n_new, 3),
               quat=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).expand(n_new, 4))
    out = {}
    for g, t in params.items():
        out[g] = t.clone()
        out[g][count:count + n_new] = new[g]
    return out, count + n_new, n_new
