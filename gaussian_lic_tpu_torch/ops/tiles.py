"""Tile binning: the sorted splat list of the tiled rasterizer.

The counterpart of the JAX package's `ops/tiles.py` and of the reference's
duplicateWithKeys -> radix sort -> identifyTileRanges
(rasterizer_impl.cu:59-218, 395-429):

  * Every Gaussian owns K static tile-slots (`max_tiles_per_gaussian`). Slot k
    maps to the k-th tile of the Gaussian's bounding rect in row-major order;
    slots beyond the rect, or failing StopThePop exact per-tile culling
    (forward.cu:151-230), are dead. Rects of more than K tiles are truncated.
  * Keys are (tile_id << depth_bits) | truncated-f32-depth, held as
    non-negative int64 below 2^32; dead slots get INVALID_KEY = 0xFFFFFFFF
    and sort last. Slots are enumerated k-major (slot id = k*P + p) and the
    sort is stable, so ties in the truncated depth keep k-major slot order:
    the sorted list equals the JAX package's entry for entry.
  * The list is cut at a static budget `max_total_splats`; per-tile
    [start, len) ranges come from `searchsorted` over the sorted tile ids.

Everything here is bookkeeping without gradients; callers pass detached tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_lic_tpu_torch.ops.projection import (
    OPACITY_THRESHOLD,
    max_contrib_power_rect_components,
)

INVALID_KEY = 0xFFFFFFFF


def rank_bits_for(num_tiles: int) -> int:
    """Bits available for the depth field next to `num_tiles`+sentinel ids."""
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    return 32 - tile_bits


def depth_key(depth: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """Truncated monotone depth field: the top `depth_bits` of the f32 bit
    pattern read as uint32 (depths are positive after culling, z > 0.2)."""
    bits = depth.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits >> (31 - depth_bits)


class TileGrid(NamedTuple):
    """Static description of the image's tile decomposition."""

    width: int
    height: int
    tile_w: int
    tile_h: int

    @property
    def n_tx(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def n_ty(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.n_tx * self.n_ty

    @property
    def padded_width(self) -> int:
        return self.n_tx * self.tile_w

    @property
    def padded_height(self) -> int:
        return self.n_ty * self.tile_h


class Binning(NamedTuple):
    sorted_gauss: torch.Tensor   # (M_pad,) int32 — Gaussian id per entry (P = dead)
    tile_starts: torch.Tensor    # (T,) int32 — entry offset of each tile's range
    tile_lens: torch.Tensor      # (T,) int32 — live entries per tile
    cnt: torch.Tensor            # (P,) int32 — entries per Gaussian that survived
                                 #   the budget cut
    num_valid: torch.Tensor      # () int32 — live entries (before the budget cut)
    overflow: torch.Tensor       # () int32 — total slots lost (truncated+budget)
    budget_lost: torch.Tensor    # () int32 — live slots cut by max_total_splats;
                                 #   fixable by growing the splat budget
    truncated: torch.Tensor      # () int32 — rect tiles beyond the K-slot limit
    tiles_touched: torch.Tensor  # (P,) int32 — live tiles per Gaussian


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    # float -> int32 truncates toward zero; the clamp keeps out-of-range
    # values defined (they are clipped to the grid right after)
    return torch.clamp(v, -(2.0 ** 30), 2.0 ** 30).to(torch.int32)


def gaussian_rects(
    xy: torch.Tensor,       # (P,2) pixel means
    radius: torch.Tensor,   # (P,) pixel radius (0 = culled)
    grid: TileGrid,
):
    """Tile-space bounding rects (getRect, auxiliary.h:46-56): min inclusive,
    max exclusive, both clamped to the grid."""
    r = radius
    x, y = xy[:, 0], xy[:, 1]
    rect_min_x = torch.clamp(_to_int32((x - r) / grid.tile_w), 0, grid.n_tx)
    rect_min_y = torch.clamp(_to_int32((y - r) / grid.tile_h), 0, grid.n_ty)
    rect_max_x = torch.clamp(
        _to_int32((x + r + grid.tile_w - 1) / grid.tile_w), 0, grid.n_tx
    )
    rect_max_y = torch.clamp(
        _to_int32((y + r + grid.tile_h - 1) / grid.tile_h), 0, grid.n_ty
    )
    return rect_min_x, rect_min_y, rect_max_x, rect_max_y


def compute_slot_tiles(
    xy: torch.Tensor,       # (P,2)
    conic: torch.Tensor,    # (P,3)
    opacity: torch.Tensor,  # (P,)
    radius: torch.Tensor,   # (P,)
    live: torch.Tensor,     # (P,) bool
    grid: TileGrid,
    K: int,
):
    """Per-slot tile assignment with StopThePop exact culling, p-major: slot
    k of a Gaussian is the k-th tile of its bounding rect in row-major order
    (duplicateWithKeys' enumeration, rasterizer_impl.cu:59-193), kept only if
    the Gaussian's largest contribution inside the tile can reach the opacity
    threshold (forward.cu:169-170). Returns (tx, ty, slot_valid, in_rect,
    (rminy, rmaxy, rect_w)): all (P, K) except the rect's (P,) rows. The
    binning itself enumerates the same slots k-major
    (`compute_slot_keys_kmajor`)."""
    rminx, rminy, rmaxx, rmaxy = gaussian_rects(xy, radius, grid)
    rect_w = rmaxx - rminx
    rect_count = rect_w * (rmaxy - rminy)

    k = torch.arange(K, dtype=torch.int32, device=xy.device)[None, :]   # (1, K)
    safe_w = torch.clamp_min(rect_w, 1)[:, None]                        # (P, 1)
    tx = rminx[:, None] + k % safe_w                                    # (P, K)
    ty = rminy[:, None] + torch.div(k, safe_w, rounding_mode="floor")
    in_rect = k < rect_count[:, None]

    power = max_contrib_power_rect_components(
        conic[:, None, 0], conic[:, None, 1], conic[:, None, 2],
        xy[:, None, 0], xy[:, None, 1],
        (tx * grid.tile_w).float(), (ty * grid.tile_h).float(),
        ((tx + 1) * grid.tile_w - 1).float(), ((ty + 1) * grid.tile_h - 1).float(),
    )
    opacity_power_threshold = torch.log(
        torch.clamp_min(opacity, OPACITY_THRESHOLD) / OPACITY_THRESHOLD
    )
    contributes = power <= opacity_power_threshold[:, None]
    slot_valid = live[:, None] & in_rect & contributes
    return tx, ty, slot_valid, in_rect, (rminy, rmaxy, rect_w)


def compute_slot_keys_kmajor(
    xy: torch.Tensor,       # (P,2)
    dkey: torch.Tensor,     # (P,) int64 truncated depth key (depth_key())
    conic: torch.Tensor,    # (P,3)
    opacity: torch.Tensor,  # (P,)
    radius: torch.Tensor,   # (P,)
    live: torch.Tensor,     # (P,) bool
    grid: TileGrid,
    K: int,
    depth_bits: int,
    band_ty0: int = 0,      # first tile row of the band
    band_n_ty: int = None,  # tile rows of the band; None: no band, GLOBAL tile ids
):
    """Slot enumeration + StopThePop exact culling + key packing, k-major:
    every per-slot tensor is (K, P). With `band_n_ty`, keys carry BAND-LOCAL
    tile ids and the slots outside the band are dead (bin_gaussians of a
    band); without, GLOBAL tile ids (the sharded binning,
    parallel/sharded.py). Returns (keys (K*P,) int64 with slot id k*P + p,
    tiles_touched (P,) int32, truncated () int32: the rect tiles lost to the
    K-slot cap, counted in the band when there is one)."""
    rminx, rminy, rmaxx, rmaxy = gaussian_rects(xy, radius, grid)
    rect_w = rmaxx - rminx
    rect_count = rect_w * (rmaxy - rminy)

    k = torch.arange(K, dtype=torch.int32, device=xy.device)[:, None]   # (K, 1)
    safe_w = torch.clamp_min(rect_w, 1)[None, :]                        # (1, P)
    tx = rminx[None, :] + k % safe_w                                    # (K, P)
    ty = rminy[None, :] + torch.div(k, safe_w, rounding_mode="floor")
    in_rect = k < rect_count[None, :]

    txf = tx.float()
    tyf = ty.float()
    power = max_contrib_power_rect_components(
        conic[None, :, 0], conic[None, :, 1], conic[None, :, 2],
        xy[None, :, 0], xy[None, :, 1],
        txf * grid.tile_w, tyf * grid.tile_h,
        (txf + 1.0) * grid.tile_w - 1.0, (tyf + 1.0) * grid.tile_h - 1.0,
    )
    opacity_power_threshold = torch.log(
        torch.clamp_min(opacity, OPACITY_THRESHOLD) / OPACITY_THRESHOLD
    )
    contributes = power <= opacity_power_threshold[None, :]
    slot_valid = live[None, :] & in_rect & contributes                  # (K, P)

    if band_n_ty is not None:
        ty_local = ty - band_ty0
        in_band = (ty_local >= 0) & (ty_local < band_n_ty)
        slot_valid = slot_valid & in_band
        tile_id = torch.where(slot_valid, ty_local * grid.n_tx + tx, 0).to(torch.int64)
        rows_in_band = torch.clamp_min(
            torch.clamp_max(rmaxy, band_ty0 + band_n_ty) - torch.clamp_min(rminy, band_ty0), 0
        )
        in_scope_total = rows_in_band * rect_w
        enumerated = (in_rect & in_band).sum(0, dtype=torch.int32)
    else:
        tile_id = torch.where(slot_valid, ty * grid.n_tx + tx, 0).to(torch.int64)
        in_scope_total = rect_count
        enumerated = in_rect.sum(0, dtype=torch.int32)
    truncated = torch.where(
        live, torch.clamp_min(in_scope_total - enumerated, 0), 0
    ).sum(dtype=torch.int32)
    tiles_touched = slot_valid.sum(0, dtype=torch.int32)

    keys = torch.where(
        slot_valid,
        (tile_id << depth_bits) | dkey[None, :],
        torch.full_like(tile_id, INVALID_KEY),
    )
    return keys.reshape(-1), tiles_touched, truncated


def bin_gaussians(
    xy: torch.Tensor,        # (P,2)
    depth: torch.Tensor,     # (P,)
    conic: torch.Tensor,     # (P,3)
    opacity: torch.Tensor,   # (P,)
    radius: torch.Tensor,    # (P,) 0 where culled
    active: torch.Tensor,    # (P,) bool (in_front & det_valid & opacity & in_count)
    grid: TileGrid,
    max_tiles_per_gaussian: int = 16,
    max_total_splats: int = 1 << 22,
    band_ty0: int = 0,      # first tile row of the band
    band_n_ty: int = None,  # tile rows of the band (None: the full grid)
    align: int = 256,
    depth_bits: int = None,  # None: as many as the band's tile ids leave
) -> Binning:
    """Bin into the full grid or, for the multi-GPU renderer
    (parallel/sharded.py), into the band of `band_n_ty` tile rows from row
    `band_ty0`: tile ids and ranges are then the band's, and so, by default
    and as in the JAX package, are the depth bits. A band binned with the
    whole grid's `depth_bits` orders its entries as the whole image's list
    does (the same truncated keys, so the same ties).
    The sorted list is cut at `max_total_splats` entries and padded with dead
    entries (id P) to a multiple of `align`; the padding keeps the list
    length M_pad equal to the JAX package's."""
    P = xy.shape[0]
    K = max_tiles_per_gaussian
    M = max_total_splats
    dev = xy.device
    n_ty_local = grid.n_ty if band_n_ty is None else band_n_ty
    num_tiles_local = n_ty_local * grid.n_tx
    if depth_bits is None:
        depth_bits = rank_bits_for(num_tiles_local)

    live = active & (radius > 0.0)
    dkey = depth_key(depth, depth_bits)
    keys, tiles_touched, truncated = compute_slot_keys_kmajor(
        xy, dkey, conic, opacity, radius, live, grid, K, depth_bits,
        band_ty0=band_ty0, band_n_ty=n_ty_local,
    )
    # stable sort: ties keep slot-id (k-major) order
    sorted_keys, sorted_slots = torch.sort(keys, stable=True)

    num_valid = tiles_touched.sum(dtype=torch.int32)
    budget_lost = torch.clamp_min(num_valid - M, 0)
    overflow = truncated + budget_lost

    m_eff = min(M, P * K)  # the sorted list can't exceed the slot count
    M_pad = ((m_eff + align - 1) // align) * align

    # Per-Gaussian surviving-entry counts. With budget loss, a slot survives
    # iff (key, slot) sorts before the m_eff-th smallest (key, slot).
    if m_eff < P * K:
        bk_key = sorted_keys[m_eff]
        bk_slot = sorted_slots[m_eff]
        k2 = keys.reshape(K, P)
        s2 = torch.arange(P * K, device=dev).reshape(K, P)
        survive = (k2 != INVALID_KEY) & (
            (k2 < bk_key) | ((k2 == bk_key) & (s2 < bk_slot))
        )
        cnt = torch.where(budget_lost > 0, survive.sum(0, dtype=torch.int32),
                          tiles_touched)
    else:
        cnt = tiles_touched

    sorted_keys = sorted_keys[:m_eff]
    sorted_slots = sorted_slots[:m_eff]
    sorted_tiles = sorted_keys >> depth_bits
    boundaries = torch.arange(num_tiles_local + 1, dtype=torch.int64, device=dev)
    edges = torch.searchsorted(sorted_tiles, boundaries, side="left").to(torch.int32)
    tile_starts = edges[:-1]
    tile_lens = edges[1:] - edges[:-1]

    # dead entries (INVALID keys past num_valid, plus the M_pad round-up tail)
    # carry sentinel id P -> zero splat rows. Slot ids are k-major.
    gauss_raw = torch.where(sorted_keys != INVALID_KEY, sorted_slots % P, P)
    sorted_gauss = torch.cat(
        [gauss_raw.to(torch.int32),
         torch.full((M_pad - m_eff,), P, dtype=torch.int32, device=dev)]
    )

    return Binning(
        sorted_gauss=sorted_gauss,
        tile_starts=tile_starts,
        tile_lens=tile_lens,
        cnt=cnt,
        num_valid=num_valid,
        overflow=overflow,
        budget_lost=budget_lost,
        truncated=truncated,
        tiles_touched=tiles_touched,
    )
