"""Dense reference renderer: an O(P * pixels) plain-PyTorch 3DGS forward.

The counterpart of the JAX package's `ops/rasterize_ref.py`, the correctness
oracle: differentiable by torch autograd, runnable on any device, with no
binning and no kernel. It reproduces renderCUDA's per-pixel blending
(forward.cu:321-481) over *all* Gaussians in global front-to-back depth order:

  alpha = min(0.99, opacity * exp(-q(d)))                 forward.cu:436
  skip  if alpha < 1/255 (or the power is positive)        forward.cu:431,437
  stop  before applying a Gaussian if T (1 - alpha) < 1e-4 forward.cu:438-443
  C += color alpha T;  T *= (1 - alpha)                    forward.cu:446-453
  out = C (no background, as renderCUDA writes C only)

The early termination is emulated with two cumulative products: a Gaussian
whose application would take T below 1e-4 is dropped with everything behind
it. n_contrib is the 1-based index of the last applied Gaussian in depth
order.

Differences from the tiled path (tolerance-tested): the tiled rasterizer
restricts each Gaussian to the tiles of its 3-sigma rect that pass exact
culling (forward.cu:151-230); the oracle evaluates it everywhere.
`box_cull=True` applies the per-Gaussian radius box to approximate that
footprint.

Memory: the JAX oracle holds several (P, H, W) tensors at once. This one
walks the pixels in chunks of at most CHUNK_ELEMS // P pixels, so no
(P, pixels) intermediate exceeds CHUNK_ELEMS = 2^26 elements (256 MiB).
Each pixel's walk over the Gaussians is independent of every other pixel's,
so chunking changes no pixel's arithmetic, only the shapes of the reductions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_lic_tpu_torch.camera import Camera
from gaussian_lic_tpu_torch.ops import sh as sh_ops
from gaussian_lic_tpu_torch.ops.blend import ALPHA_CAP, T_EPS
from gaussian_lic_tpu_torch.ops.projection import (
    OPACITY_THRESHOLD,
    ProjectionResult,
    project_gaussians,
)

__all__ = ["ALPHA_CAP", "T_EPS", "CHUNK_ELEMS", "RenderOutput", "render_dense"]

CHUNK_ELEMS = 1 << 26     # elements of one (P, pixels) intermediate, at most


class RenderOutput(NamedTuple):
    image: torch.Tensor      # (3, H, W), CHW like the reference (forward.cu:467)
    final_T: torch.Tensor    # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32, index of the last applied Gaussian (1-based)
    visible: torch.Tensor    # (P,) bool, radii > 0 (renderer.cpp:84-86)
    radii: torch.Tensor      # (P,) float


def _exclusive_cumprod(t_f: torch.Tensor) -> torch.Tensor:
    """T before each Gaussian (along the last axis): the product of the
    factors in front of it."""
    return torch.cat([torch.ones_like(t_f[:, :1]), torch.cumprod(t_f, 1)[:, :-1]], 1)


def _blend_chunk(xy, conic, opa, rad, rgb, px, py, box_cull: bool, no_color: bool):
    """(image (3, n), final_T (n,), n_contrib (n,)) of the n pixels (px, py),
    over the depth-sorted Gaussians (rows of xy, conic, opa, rad, rgb). The
    intermediates are (n, P): pixel-major, so the cumulative products and
    sums over the Gaussians run along contiguous memory."""
    dx = xy[None, :, 0] - px[:, None]
    dy = xy[None, :, 1] - py[:, None]
    A, B, C = conic[None, :, 0], conic[None, :, 1], conic[None, :, 2]
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    alpha = torch.clamp_max(opa[None, :] * torch.exp(power), ALPHA_CAP)
    alpha = torch.where(power > 0.0, 0.0, alpha)                 # forward.cu:431
    alpha = torch.where(alpha < OPACITY_THRESHOLD, 0.0, alpha)   # forward.cu:437
    if box_cull:
        inside = (dx.abs() <= rad[None, :]) & (dy.abs() <= rad[None, :])
        alpha = torch.where(inside, alpha, 0.0)
    del dx, dy, power

    # early termination (forward.cu:438-443): a contributing Gaussian whose
    # application would push T below 1e-4 is dropped with all behind it
    t_f = 1.0 - alpha
    trigger = (alpha > 0.0) & (_exclusive_cumprod(t_f) * t_f < T_EPS)
    dead = torch.cumsum(trigger.to(torch.int32), 1) > 0
    alpha = torch.where(dead, 0.0, alpha)
    del t_f, trigger, dead

    t_f = 1.0 - alpha
    final_t = torch.prod(t_f, 1)
    n = px.shape[0]
    if no_color:
        return (torch.zeros((3, n), dtype=torch.float32, device=px.device), final_t,
                torch.zeros((n,), dtype=torch.int32, device=px.device))
    weights = alpha * _exclusive_cumprod(t_f)
    # the contraction over P written out per channel: true float32 on any device
    image = torch.stack([(weights * rgb[None, :, c]).sum(1) for c in range(3)])
    idx = torch.arange(1, alpha.shape[1] + 1, dtype=torch.int32, device=px.device)
    n_contrib = torch.where(alpha > 0.0, idx[None, :], 0).amax(1)
    return image, final_t, n_contrib


def render_dense(
    xyz: torch.Tensor,        # (P,3)
    scale: torch.Tensor,      # (P,3) activated
    quat: torch.Tensor,       # (P,4)
    opacity: torch.Tensor,    # (P,) activated (sigmoid'd)
    camera: Camera,
    dc: Optional[torch.Tensor] = None,        # (P,3) SH DC
    sh_rest: Optional[torch.Tensor] = None,   # (P,M-1,3)
    sh_degree: int = 3,
    colors: Optional[torch.Tensor] = None,    # (P,3) precomputed RGB (overrides SH)
    no_color: bool = False,   # alpha-only pass of densification (gaussian.cpp:505-507)
    box_cull: bool = False,
    proj: Optional[ProjectionResult] = None,
) -> RenderOutput:
    """Render with the dense oracle. All Gaussians take part (no tiling)."""
    if proj is None:
        proj = project_gaussians(xyz, scale, quat, camera)
    H, W = camera.intr.height, camera.intr.width
    P = xyz.shape[0]
    dev = xyz.device

    active = proj.in_front & proj.det_valid & (opacity >= OPACITY_THRESHOLD)
    radius = torch.where(active, proj.radius, 0.0)
    visible = radius > 0.0

    # global front-to-back order (the tiled path orders per tile by the same depth)
    order = torch.argsort(proj.depth, stable=True)
    xy_s = proj.xy[order]
    conic_s = proj.conic[order]
    opa_s = torch.where(visible, opacity, 0.0)[order]
    rad_s = radius[order]
    if no_color:
        rgb_s = None
    elif colors is not None:
        rgb_s = colors[order]
    else:
        dirs = xyz - camera.cam_center
        rgb_s = sh_ops.eval_sh_color(sh_degree, dc, sh_rest, dirs)[order]

    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    step = max(1, CHUNK_ELEMS // max(P, 1))
    parts = [_blend_chunk(xy_s, conic_s, opa_s, rad_s, rgb_s, px[s:s + step], py[s:s + step],
                          box_cull, no_color) for s in range(0, H * W, step)]
    image, final_t, n_contrib = (torch.cat(p, -1) for p in zip(*parts))
    return RenderOutput(
        image=image.reshape(3, H, W),
        final_T=final_t.reshape(H, W),
        n_contrib=n_contrib.reshape(H, W),
        visible=visible,
        radii=radius,
    )
