"""Differentiable tiled rasterizer: `render_tiled` / `render_map`.

The counterpart of the JAX package's `ops/rasterize.py` (reference render stack,
renderer.cpp:21-88 -> rasterizer.cpp:21-183 -> CudaRasterizer):

  projection / EWA / SH (torch autograd)
  -> tile binning on detached values (ops.tiles)
  -> `_Blend`, a torch.autograd.Function: gather the sorted splat rows, K1
     forward; its backward runs K2 and sums the per-entry gradients per
     Gaussian with one `index_add_` (the reference's atomicAdd,
     backward.cu:585-595).

`apply_exposure=True` maps the image through exposure[:, :3] @ rgb +
exposure[:, 3:] (the reference accepts the flag and never applies it). `bg`
is accepted and ignored: renderCUDA never composites a background.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_lic_tpu_torch.camera import Camera
from gaussian_lic_tpu_torch.ops import blend as blend_ops
from gaussian_lic_tpu_torch.ops import sh as sh_ops
from gaussian_lic_tpu_torch.ops import tiles as tiles_ops
from gaussian_lic_tpu_torch.ops.blend import N_ATTR, SPLAT_ROWS
from gaussian_lic_tpu_torch.ops.projection import OPACITY_THRESHOLD, project_gaussians

# Alignment of the sorted list's length; keeps M_pad equal to the JAX package's.
CHUNK = 256


def _splat_budget_for(capacity: int, cfg) -> int:
    """Sorted-splat-list budget: `splat_budget_factor` entries per Gaussian,
    CHUNK-aligned, capped by the per-Gaussian slot limit. Overflow past it is
    counted per step and the engine grows the factor."""
    b = max(int(capacity * cfg.splat_budget_factor), 1 << 12)
    b = (b + CHUNK - 1) // CHUNK * CHUNK
    return min(b, capacity * cfg.max_tiles_per_gaussian)


class TiledRenderOutput(NamedTuple):
    image: torch.Tensor       # (3, H, W)
    final_T: torch.Tensor     # (H, W)
    n_contrib: torch.Tensor   # (H, W) int32
    visible: torch.Tensor     # (P,) bool — radii > 0
    radii: torch.Tensor       # (P,)
    overflow: torch.Tensor    # () int32 — total binning slots lost
    budget_lost: torch.Tensor # () int32 — lost to max_total_splats (growable)
    truncated: torch.Tensor   # () int32 — lost to the K-slot rect limit


def _pack_rows(xy, conic, opacity, rgb) -> torch.Tensor:
    """(P, 16) rows: x, y, A, B, C, opa, r, g, b, then 7 zero columns."""
    P = xy.shape[0]
    pad = torch.zeros((P, SPLAT_ROWS - N_ATTR), dtype=torch.float32, device=xy.device)
    return torch.cat([xy, conic, opacity[:, None], rgb, pad], dim=1)


def _gather_splats(rows: torch.Tensor, sorted_gauss: torch.Tensor) -> torch.Tensor:
    """(M_pad, 16) sorted splat rows; the dead id P gives a zero row."""
    table = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return table[sorted_gauss.long()]


class _Blend(torch.autograd.Function):
    """Differentiable in `rows` (P, 16); returns (color, final_T, n_contrib)
    in padded image space."""

    @staticmethod
    def forward(ctx, rows, sorted_gauss, tile_starts, tile_lens, grid):
        splats = _gather_splats(rows, sorted_gauss)
        color, final_t, n_contrib = blend_ops.blend_forward(
            splats, tile_starts, tile_lens, n_tx=grid.n_tx, n_ty=grid.n_ty,
            tile_h=grid.tile_h, tile_w=grid.tile_w,
        )
        ctx.grid = grid
        ctx.n_rows = rows.shape[0]
        ctx.save_for_backward(splats, sorted_gauss, tile_starts, tile_lens,
                              final_t, n_contrib)
        ctx.mark_non_differentiable(final_t, n_contrib)
        return color, final_t, n_contrib

    @staticmethod
    def backward(ctx, d_color, _d_final_t, _d_ncontrib):
        # only the image gradient enters, as in the reference
        # (PerGaussianRenderCUDA reads dL_dpixels only, backward.cu:529-536)
        splats, sorted_gauss, tile_starts, tile_lens, final_t, n_contrib = ctx.saved_tensors
        grid = ctx.grid
        P = ctx.n_rows
        if d_color is None:
            return None, None, None, None, None
        entry_grads = blend_ops.blend_backward(
            splats, tile_starts, tile_lens, d_color.contiguous(), final_t, n_contrib,
            n_tx=grid.n_tx, n_ty=grid.n_ty, tile_h=grid.tile_h, tile_w=grid.tile_w,
        )
        g = entry_grads.new_zeros((P + 1, N_ATTR))
        g.index_add_(0, sorted_gauss.long(), entry_grads)   # dead id P -> row P
        d_rows = torch.nn.functional.pad(g[:P], (0, SPLAT_ROWS - N_ATTR))
        return d_rows, None, None, None, None


class SplatInputs(NamedTuple):
    grid: tiles_ops.TileGrid
    rows: torch.Tensor        # (P, 16) packed splat rows, differentiable
    binning: tiles_ops.Binning
    radius: torch.Tensor      # (P,) zero for inactive Gaussians


def splat_inputs(xyz, scale, quat, opacity, camera, dc=None, sh_rest=None, sh_degree=3,
                 colors=None, active=None, no_color=False, tile_h=32, tile_w=32,
                 max_tiles_per_gaussian=16, max_total_splats=1 << 21) -> SplatInputs:
    """Projection, colour and binning: what the blend kernels are handed
    (after `_gather_splats(rows, binning.sorted_gauss)`)."""
    intr = camera.intr
    grid = tiles_ops.TileGrid(
        width=intr.width, height=intr.height, tile_w=tile_w, tile_h=tile_h
    )

    proj = project_gaussians(xyz, scale, quat, camera)
    base_active = proj.in_front & proj.det_valid & (opacity >= OPACITY_THRESHOLD)
    if active is not None:
        base_active = base_active & active
    radius = torch.where(base_active, proj.radius, torch.zeros_like(proj.radius))

    if no_color:
        rgb = torch.zeros((xyz.shape[0], 3), dtype=torch.float32, device=xyz.device)
    elif colors is not None:
        rgb = colors
    else:
        dirs = xyz - camera.cam_center
        rgb = sh_ops.eval_sh_color(sh_degree, dc, sh_rest, dirs)

    binning = tiles_ops.bin_gaussians(
        proj.xy.detach(), proj.depth.detach(), proj.conic.detach(),
        opacity.detach(), radius.detach(), base_active, grid,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        max_total_splats=max_total_splats,
        align=CHUNK,
    )
    rows = _pack_rows(proj.xy, proj.conic, opacity, rgb)
    return SplatInputs(grid, rows, binning, radius)


def render_tiled(
    xyz: torch.Tensor,         # (P,3)
    scale: torch.Tensor,       # (P,3) activated
    quat: torch.Tensor,        # (P,4)
    opacity: torch.Tensor,     # (P,) activated
    camera: Camera,
    dc: Optional[torch.Tensor] = None,
    sh_rest: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    colors: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,    # (P,) bool, e.g. index < count
    exposure: Optional[torch.Tensor] = None,  # (3,4); applied when apply_exposure
    apply_exposure: bool = False,
    no_color: bool = False,
    bg: Optional[torch.Tensor] = None,        # accepted, ignored (parity)
    tile_h: int = 32,
    tile_w: int = 32,
    max_tiles_per_gaussian: int = 16,
    max_total_splats: int = 1 << 21,
) -> TiledRenderOutput:
    """Full differentiable render (reference `render` outputs,
    renderer.cpp:81-87): image, final_T, n_contrib, visible, radii and the
    binning overflow counters."""
    del bg
    intr = camera.intr
    grid, rows, binning, radius = splat_inputs(
        xyz, scale, quat, opacity, camera, dc=dc, sh_rest=sh_rest, sh_degree=sh_degree,
        colors=colors, active=active, no_color=no_color, tile_h=tile_h, tile_w=tile_w,
        max_tiles_per_gaussian=max_tiles_per_gaussian, max_total_splats=max_total_splats,
    )
    visible = radius > 0.0

    if no_color:
        # alpha-only pass (extend(), gaussian.cpp:505-507): no gradients
        with torch.no_grad():
            color_p, final_t_p, ncontrib_p = blend_ops.blend_forward(
                _gather_splats(rows.detach(), binning.sorted_gauss),
                binning.tile_starts, binning.tile_lens,
                n_tx=grid.n_tx, n_ty=grid.n_ty, tile_h=tile_h, tile_w=tile_w,
                no_color=True,
            )
    else:
        color_p, final_t_p, ncontrib_p = _Blend.apply(
            rows, binning.sorted_gauss, binning.tile_starts, binning.tile_lens, grid
        )

    H, W = intr.height, intr.width
    image = color_p[:, :H, :W]
    final_t = final_t_p[:H, :W]
    n_contrib = ncontrib_p[:H, :W]

    if apply_exposure and exposure is not None:
        flat = image.reshape(3, -1)
        # exposure[:, :3] @ flat in true f32, written out
        image = (
            (exposure[:, :3, None] * flat[None, :, :]).sum(1) + exposure[:, 3:]
        ).reshape(3, H, W)

    return TiledRenderOutput(
        image=image,
        final_T=final_t,
        n_contrib=n_contrib,
        visible=visible,
        radii=radius,
        overflow=binning.overflow,
        budget_lost=binning.budget_lost,
        truncated=binning.truncated,
    )


def render_map(
    gm,
    camera: Camera,
    *,
    apply_exposure: bool = False,
    no_color: bool = False,
    **kw,
) -> TiledRenderOutput:
    """Render a GaussianMap (activations + active-count mask applied)."""
    return render_tiled(
        gm.xyz,
        gm.scaling,
        gm.rotation,
        gm.opacity,
        camera,
        dc=gm.dc,
        sh_rest=gm.sh_rest,
        sh_degree=gm.sh_degree,
        active=gm.active_mask(),
        exposure=gm.exposure,
        apply_exposure=apply_exposure,
        no_color=no_color,
        **kw,
    )
