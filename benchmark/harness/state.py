"""The benchmark's inputs, made from the seed on the run's device: the map's
stored parameters, the keyframes' poses and images, and held-out views.

Frozen copies of the port's bench recipes, so that a change to the program
never changes what it is measured on:

  map      gaussian_lic_tpu_torch/utils/synthetic.py (make_bench_state): Gaussians
           filling the camera frustum, z ~ U(1, 30), x ~ U(-0.7, 0.7) z,
           y ~ U(-0.55, 0.55) z, colours U(0.05, 0.95), initialised as
           models/gaussians.py (point_attributes) does: DC (c - 0.5) / C0,
           isotropic log scale log(scaling_scale z / focal), identity
           rotation, opacity 0.1;
  sky      models/gaussians.py (make_skybox): the skybox's points on the far
           hemisphere, DC (0.7, 0.8, 0.95), opacity 0.7, first in the map;
           the scale is the expected root mean square distance to the 3
           nearest neighbours of points spread evenly over that cap,
           sqrt(2 / (pi density)), where the program measures it (a k-NN
           search the plain reference would have to repeat);
  dead     GaussianMap.grow's padding rows: zeros, identity rotation,
           opacity 0.1;
  poses    make_bench_state's keyframe poses, eye (0.3 sin i, 0.2 cos i,
           -1 - 0.1 (i mod 16)) looking at (0, 0, 10), y down;
  images   uniform random uint8 images.

Everything is drawn with one `torch.Generator` on the device, in a few large
calls, so that the same seed gives the same inputs.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


def map_params(gen: torch.Generator, p: dict, rows: int, live: int,
               device) -> Dict[str, torch.Tensor]:
    """The stored parameters of a map of `rows` rows whose first `live` are
    Gaussians: the config's `skybox_points_num` sky Gaussians first, then
    the frustum box. Keys: xyz, dc, sh_rest, opacity (the logit), log_scale, quat."""
    f32 = dict(dtype=torch.float32, device=device)
    n_sky = int(p["skybox_points_num"])
    n_box = live - n_sky
    if n_box < 0 or live > rows:
        raise ValueError(f"{live} live Gaussians ({n_sky} of sky) do not fit {rows} rows")
    focal = (p["fx"] + p["fy"]) / 2.0
    u = torch.rand((6, n_box), generator=gen, **f32)
    z = 1.0 + 29.0 * u[0]
    box_xyz = torch.stack([(-0.7 + 1.4 * u[1]) * z, (-0.55 + 1.1 * u[2]) * z, z], 1)
    box_dc = ((0.05 + 0.9 * u[3:6].T) - 0.5) / SH_C0
    box_ls = torch.log(torch.clamp_min(p["scaling_scale"] * z / focal, 1e-10))
    us = torch.rand((2, n_sky), generator=gen, **f32)
    theta = 2.0 * math.pi * us[0]
    phi = torch.acos(1.0 - 1.4 * us[1])
    r = p["skybox_radius"] * 10.0
    sky_xyz = torch.stack([r * torch.cos(theta) * torch.sin(phi),
                           r * torch.sin(theta) * torch.sin(phi), r * torch.cos(phi)], 1)
    density = max(n_sky, 1) / (2.0 * math.pi * r * r * 1.4)
    sky_scale = math.sqrt(2.0 / (math.pi * density))
    sky_dc = (torch.tensor([0.7, 0.8, 0.95], **f32) - 0.5) / SH_C0

    out = dict(xyz=torch.zeros((rows, 3), **f32), dc=torch.zeros((rows, 3), **f32),
               sh_rest=torch.zeros((rows, 15, 3), **f32),
               opacity=torch.full((rows,), _logit(0.1), **f32),
               log_scale=torch.zeros((rows, 3), **f32), quat=torch.zeros((rows, 4), **f32))
    out["quat"][:, 0] = 1.0
    out["xyz"][:n_sky] = sky_xyz
    out["xyz"][n_sky:live] = box_xyz
    out["dc"][:n_sky] = sky_dc
    out["dc"][n_sky:live] = box_dc
    out["log_scale"][:n_sky] = math.log(sky_scale)
    out["log_scale"][n_sky:live] = box_ls[:, None]
    out["opacity"][:n_sky] = _logit(0.7)
    return out


def look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """World-from-camera (R_wc, t_wc), +z towards `target`."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32), eye.astype(np.float32)


def poses(s: np.ndarray):
    """(R_wc (n, 3, 3), t_wc (n, 3)) at trajectory positions `s` (keyframe
    i sits at s = i)."""
    Rs, ts = [], []
    for v in s:
        R, t = look_at((0.3 * np.sin(v), 0.2 * np.cos(v), -1.0 - 0.1 * (v % 16.0)),
                       (0.0, 0.0, 10.0))
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def images(gen: torch.Generator, n: int, p: dict, device) -> torch.Tensor:
    """(n, 3, H, W) uniform uint8 images in [0, 254]."""
    return torch.randint(0, 255, (n, 3, p["height"], p["width"]), generator=gen,
                         dtype=torch.uint8, device=device)
