"""The stream's frames, made from the seed: a frozen recipe of the benchmark's
own, beside harness/state.py's map, so that a change to the program never
changes what it is measured on.

Frame j of a stream that starts at trajectory position s0 sits at
s = s0 + j / every (state.poses' trajectory, `every` frames a keyframe
apart, so a keyframe cycle moves one keyframe along it) and carries

  image    a uniform random uint8 image (state.images), height x width x 3;
  points   `n_points` LiDAR points in that frame's camera frustum, drawn as
           state.py draws the map's box: depth z ~ U(1, 30) in the camera,
           x and y such that the point projects to a uniform position in the
           image, (u W - cx) z / fx and (v H - cy) z / fy, then put in the
           world by the frame's pose;
  colours  U(0.05, 0.95) each.

Drawn on the run's device with the generator of harness/state.py, in a few
calls for all the frames, then taken to the host, where a stream's frames
arrive.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from harness import state


def frames(gen: torch.Generator, p: dict, s0: float, n: int, n_points: int,
           device) -> List[dict]:
    """`n` frames as dicts of host arrays: `R_wc` (3, 3), `t_wc` (3,),
    `image` (H, W, 3) uint8, `points` (n_points, 3), `colors` (n_points, 3),
    and `stamp`, 0.1 s apart (a 10 Hz rig)."""
    every = p["select_every_k_frame"]
    R_wc, t_wc = state.poses(s0 + np.arange(n, dtype=np.float64) / every)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((n, 6, n_points), generator=gen, **f32)
    z = 1.0 + 29.0 * u[:, 0]
    cam = torch.stack([(u[:, 1] * p["width"] - p["cx"]) * z / p["fx"],
                       (u[:, 2] * p["height"] - p["cy"]) * z / p["fy"], z], -1)
    R = torch.as_tensor(R_wc, **f32)
    world = (R[:, None] * cam[:, :, None, :]).sum(-1) + torch.as_tensor(t_wc, **f32)[:, None]
    colors = 0.05 + 0.9 * u[:, 3:6].transpose(1, 2)
    imgs = state.images(gen, n, p, device).permute(0, 2, 3, 1).contiguous()
    world, colors, imgs = (t.cpu().numpy() for t in (world, colors, imgs))
    return [dict(stamp=0.1 * j, R_wc=R_wc[j], t_wc=t_wc[j], image=imgs[j], points=world[j],
                 colors=np.ascontiguousarray(colors[j])) for j in range(n)]
