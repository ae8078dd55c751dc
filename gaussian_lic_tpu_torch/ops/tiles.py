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
):
    """Slot enumeration + StopThePop exact culling + key packing, k-major:
    every per-slot tensor is (K, P). Returns (keys (K*P,) int64 with slot id
    k*P + p, tiles_touched (P,) int32, truncated () int32)."""
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

    tile_id = torch.where(slot_valid, ty * grid.n_tx + tx, 0).to(torch.int64)
    enumerated = in_rect.sum(0, dtype=torch.int32)
    truncated = torch.where(
        live, torch.clamp_min(rect_count - enumerated, 0), 0
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
    align: int = 256,
) -> Binning:
    """Bin into the full grid. The sorted list is cut at `max_total_splats`
    entries and padded with dead entries (id P) to a multiple of `align`;
    the padding keeps the list length M_pad equal to the JAX package's."""
    P = xy.shape[0]
    K = max_tiles_per_gaussian
    M = max_total_splats
    dev = xy.device
    depth_bits = rank_bits_for(grid.num_tiles)

    live = active & (radius > 0.0)
    dkey = depth_key(depth, depth_bits)
    keys, tiles_touched, truncated = compute_slot_keys_kmajor(
        xy, dkey, conic, opacity, radius, live, grid, K, depth_bits,
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
    boundaries = torch.arange(grid.num_tiles + 1, dtype=torch.int64, device=dev)
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
