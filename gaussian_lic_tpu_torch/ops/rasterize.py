"""Differentiable tiled rasterizer: `render_tiled` / `render_map`.

The counterpart of the JAX package's `ops/rasterize.py` (reference render stack,
renderer.cpp:21-88 -> rasterizer.cpp:21-183 -> CudaRasterizer):

  preprocess: the activations of a map's stored parameters (`raw`), then
     projection / EWA / SH into packed splat rows (ops.preprocess: K5
     forward, K6 backward on the card; the plain chain with autograd on the
     CPU)
  -> tile binning on detached values (ops.tiles: K8 slot keys, a stable
     sort, K9 ranges on the card)
  -> `_Blend`, a torch.autograd.Function: gather the sorted splat rows (K10),
     K1 forward; its backward runs K2, which returns per-Gaussian gradients (on
     the card K2 sums them with atomics, the reference's atomicAdd,
     backward.cu:585-595; on the CPU its plain version ends in `index_add_`),
     handed to K6 as they are.

`apply_exposure=True` maps the image through exposure[:, :3] @ rgb +
exposure[:, 3:] (the reference accepts the flag and never applies it). `bg`
is accepted and ignored: renderCUDA never composites a background.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_lic_tpu_torch.camera import Camera
from gaussian_lic_tpu_torch.ops import blend as blend_ops
from gaussian_lic_tpu_torch.ops import tiles as tiles_ops
from gaussian_lic_tpu_torch.ops.blend import N_ATTR
from gaussian_lic_tpu_torch.ops.preprocess import preprocess, row_table

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


def _gather_splats(table: torch.Tensor, sorted_gauss: torch.Tensor) -> torch.Tensor:
    """(M_pad, 16) sorted splat rows of the (P+1, 16) table; the dead id P
    reads its zero row (K10 on the card, ops/tiles.py)."""
    return tiles_ops.gather_splats(table, sorted_gauss)


class _Blend(torch.autograd.Function):
    """Differentiable in `rows`: the preprocess's (P, 9) `Splats.attrs`,
    whose gradient is K2's per-Gaussian output as it is, or packed (P, 16)
    rows, whose gradient is that padded with zero columns. The splats are
    gathered from `table` (P+1, 16), the rows' values and a zero row
    (default: `row_table(rows)`, for packed rows).
    Returns (color, final_t, n_contrib) in padded image space."""

    @staticmethod
    def forward(ctx, rows, sorted_gauss, tile_starts, tile_lens, grid, table=None):
        splats = _gather_splats(row_table(rows) if table is None else table, sorted_gauss)
        color, final_t, n_contrib = blend_ops.blend_forward(
            splats, tile_starts, tile_lens, n_tx=grid.n_tx, n_ty=grid.n_ty,
            tile_h=grid.tile_h, tile_w=grid.tile_w,
        )
        ctx.grid = grid
        ctx.n_rows, ctx.width = rows.shape
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
        if d_color is None:
            return None, None, None, None, None, None
        g = blend_ops.blend_backward(
            splats, tile_starts, tile_lens, d_color.contiguous(), final_t, n_contrib,
            sorted_gauss, n_gauss=ctx.n_rows, n_tx=grid.n_tx, n_ty=grid.n_ty,
            tile_h=grid.tile_h, tile_w=grid.tile_w,
        )
        if ctx.width != N_ATTR:
            g = torch.nn.functional.pad(g, (0, ctx.width - N_ATTR))
        return g, None, None, None, None, None


class SplatInputs(NamedTuple):
    grid: tiles_ops.TileGrid
    rows: torch.Tensor        # `_Blend`'s differentiable input (Splats.attrs)
    table: torch.Tensor       # (P+1, 16) packed splat rows, last row zero
    binning: tiles_ops.Binning
    radius: torch.Tensor      # (P,) zero for inactive Gaussians


def splat_inputs(xyz, scale, quat, opacity, camera, dc=None, sh_rest=None, sh_degree=3,
                 colors=None, active=None, no_color=False, tile_h=32, tile_w=32,
                 max_tiles_per_gaussian=16, max_total_splats=1 << 21,
                 raw=False) -> SplatInputs:
    """Preprocess (K5, ops/preprocess.py) and binning: what the blend
    kernels are handed (after `_gather_splats(table, binning.sorted_gauss)`).
    With `raw`, scale, quat and opacity are the stored log_scale, quat and
    opa_logit (ops.preprocess.preprocess)."""
    intr = camera.intr
    grid = tiles_ops.TileGrid(
        width=intr.width, height=intr.height, tile_w=tile_w, tile_h=tile_h
    )
    s = preprocess(xyz, scale, quat, opacity, camera, dc=dc, sh_rest=sh_rest,
                   sh_degree=sh_degree, active=active, no_color=no_color, colors=colors,
                   raw=raw)
    binning = tiles_ops.bin_gaussians(
        s.xy, s.depth, s.conic, s.opacity, s.radius, s.base_active, grid,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        max_total_splats=max_total_splats,
        align=CHUNK,
    )
    return SplatInputs(grid, s.attrs, s.table, binning, s.radius)


def expose(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """exposure[:, :3] @ rgb + exposure[:, 3:] per pixel of a (3, h, w)
    image, the matrix product written out in true f32."""
    flat = image.reshape(3, -1)
    return ((exposure[:, :3, None] * flat[None, :, :]).sum(1)
            + exposure[:, 3:]).reshape(image.shape)


def render_tiled(
    xyz: torch.Tensor,         # (P,3)
    scale: torch.Tensor,       # (P,3) activated (raw: log_scale)
    quat: torch.Tensor,        # (P,4)
    opacity: torch.Tensor,     # (P,) activated (raw: opa_logit)
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
    raw: bool = False,
) -> TiledRenderOutput:
    """Full differentiable render (reference `render` outputs,
    renderer.cpp:81-87): image, final_T, n_contrib, visible, radii and the
    binning overflow counters. With `raw`, scale, quat and opacity are a
    map's stored log_scale, quat and opa_logit, activated inside K5 (and
    their gradients K6's); else the values already activated."""
    del bg
    intr = camera.intr
    grid, rows, table, binning, radius = splat_inputs(
        xyz, scale, quat, opacity, camera, dc=dc, sh_rest=sh_rest, sh_degree=sh_degree,
        colors=colors, active=active, no_color=no_color, tile_h=tile_h, tile_w=tile_w,
        max_tiles_per_gaussian=max_tiles_per_gaussian, max_total_splats=max_total_splats,
        raw=raw,
    )
    visible = radius > 0.0

    if no_color:
        # alpha-only pass (extend(), gaussian.cpp:505-507): no gradients
        with torch.no_grad():
            color_p, final_t_p, ncontrib_p = blend_ops.blend_forward(
                _gather_splats(table, binning.sorted_gauss),
                binning.tile_starts, binning.tile_lens,
                n_tx=grid.n_tx, n_ty=grid.n_ty, tile_h=tile_h, tile_w=tile_w,
                no_color=True,
            )
    else:
        color_p, final_t_p, ncontrib_p = _Blend.apply(
            rows, binning.sorted_gauss, binning.tile_starts, binning.tile_lens, grid, table
        )

    H, W = intr.height, intr.width
    image = color_p[:, :H, :W]
    final_t = final_t_p[:H, :W]
    n_contrib = ncontrib_p[:H, :W]

    if apply_exposure and exposure is not None:
        image = expose(image, exposure)

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
    """Render a GaussianMap from its stored parameters (K5 applies the
    activations, K6 chains their backward) with the active-count mask."""
    return render_tiled(
        gm.xyz,
        gm.log_scale,
        gm.quat,
        gm.opa_logit,
        camera,
        dc=gm.dc,
        sh_rest=gm.sh_rest,
        sh_degree=gm.sh_degree,
        active=gm.active_mask(),
        exposure=gm.exposure,
        apply_exposure=apply_exposure,
        no_color=no_color,
        raw=True,
        **kw,
    )
