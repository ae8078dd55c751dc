"""Tile binning and the splat gather: kernels K8 (`bin_keys`), K13
(`sort_live_slots`, the stable sort), K9 (`bin_ranges`) and K10
(`gather_splats`).

The counterpart of the JAX package's `ops/tiles.py` (one `jax.jit` program
that XLA fuses around a single `lax.sort`) and of its rasterizer's
`jnp.take(rows, sorted_gauss, mode="fill")`; the reference's
duplicateWithKeys -> radix sort -> identifyTileRanges
(rasterizer_impl.cu:59-218, 395-429):

  * Every Gaussian owns K static tile-slots (`max_tiles_per_gaussian`). Slot k
    maps to the k-th tile of the Gaussian's bounding rect in row-major order;
    slots beyond the rect, or failing StopThePop exact per-tile culling
    (forward.cu:151-230), are dead. Rects of more than K tiles are truncated.
  * Keys are (tile_id << depth_bits) | truncated-f32-depth, below 2^32; dead
    slots get INVALID_KEY = 0xFFFFFFFF and sort last. K8 writes them as
    int32 with the top bit flipped (`keys_to_int32`), so an int32 sort orders
    them as uint32 on 32 bits. Slots are enumerated k-major (slot id = k*P +
    p) and the sort is stable, so ties in the truncated depth keep k-major
    slot order: the sorted list equals the JAX package's entry for entry.
    K13 sorts only the live slots, taken in slot order, with int32 slot ids
    (a radix sort whose length, K8's live count, stays on the device): the
    stable sort of all P*K keys holds exactly those first, then the dead
    ones, so its list is that sort's first `num_valid` entries.
  * K9 cuts the list at a static budget `max_total_splats` (entries past
    the live count read as dead), maps each entry to its Gaussian (the dead
    id P past the live entries), writes each tile's [start, len) range where
    the tile id steps (the searchsorted of every tile) and each Gaussian's
    surviving entries (K8's count where the budget cuts nothing).
  * K10 gathers the (M_pad, 16) splat rows the blend kernels stream.

Dispatch by the tensors' device, as `ops/blend.py`: CUDA tensors launch the
kernels (csrc/bin_keys.cu, csrc/sort_live.cu, csrc/bin_ranges.cu,
csrc/gather_splats.cu) or raise; CPU tensors take the plain versions
(`*_plain`: the PyTorch chains the port ran before the kernels, the
compaction and `torch.sort`, and `table[ids.long()]`). `LAUNCHES` counts
kernel launches (K13's six kernels count once, as "sort_live").
`bin_keys_probe` launches K8's timing variants (`K8_VARIANTS`, off the main
path; `PROBE_LAUNCHES` counts them), `bin_ranges_probe` K9's
(`K9_VARIANTS`; `K9_PROBE_LAUNCHES`). Nothing here reads back to the host,
so a train step that bins stays capturable in a CUDA graph.

Everything here is bookkeeping without gradients; callers pass detached tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gaussian_lic_tpu_torch.ops.blend import SPLAT_ROWS, _check, _launch, _ptr, _stream
from gaussian_lic_tpu_torch.ops.projection import (
    OPACITY_THRESHOLD,
    max_contrib_power_rect_components,
)

INVALID_KEY = 0xFFFFFFFF
KEY_FLIP = 1 << 31         # int32 key = uint32 key - 2^31: the top bit flipped
DEAD_KEY = INVALID_KEY - KEY_FLIP   # INVALID_KEY in the int32 form: 2^31 - 1

# Launch counts of K8, K13, K9 and K10 (plain-version calls are not counted).
LAUNCHES = {"bin_keys": 0, "sort_live": 0, "bin_ranges": 0, "gather_splats": 0}
# K13's geometry (csrc/sort_live.cu): slots a compaction tile, pairs a tile
# of a radix pass, and the int32 words of its zeroed scratch before the
# compaction's 64-bit look-back words (kCompactTile, kSortTile,
# kCompactStatusWord).
SORT_LIVE_TILES = (8192, 4096)
SORT_LIVE_ZERO_WORDS = 1032
SORT_LIVE_BINS = 256
# K8's timing variants (csrc/bin_keys.cuh K8Variant), off the main path, by
# their numbers there: base is K8; rcp takes 1 / t as __frcp_rn, vecload
# reads the table's columns 0-3 as one 16-byte load, fold keeps the sums on
# the device between blocks (no zeroed `sums`, so no fill before it), listed
# evaluates the cull over a dense list of (Gaussian, slot) pairs (all bit for
# bit); nopower (the cull always passes), onestore (one key store a
# Gaussian), notable (no table stream), memonly (the loads and stores alone)
# and listed_nopower are timing only.
K8_VARIANT_IDS = {"base": 0, "nopower": 1, "onestore": 2, "rcp": 3, "vecload": 4, "notable": 5,
                  "memonly": 6, "fold": 7, "listed": 8, "listed_nopower": 9}
K8_VARIANTS = tuple(K8_VARIANT_IDS)
K8_TIMING_ONLY = ("nopower", "onestore", "notable", "memonly", "listed_nopower")
PROBE_LAUNCHES = {v: 0 for v in K8_VARIANTS}
# K9's timing variants (csrc/bin_ranges.cuh K9Variant), off the main path, by
# their numbers there: base is K9 (4 entries a thread from 16-byte loads, the
# neighbours' tiles by warp shuffles, the magic remainder, cnt from K8's
# touched or JAX's survivor compare), hist it with the atomic histogram
# always; first is the first design (one thread an entry, 64-bit remainder,
# histogram), mod32 and fastdiv it with the 32-bit and the magic remainder
# (all bit for bit); memonly (the first design's loads and id stores alone)
# and noatomic (no histogram) are timing only. K9_HISTOGRAM: the variants
# that build the histogram whatever the caller gives (cnt must hold zeros).
K9_VARIANT_IDS = {"base": 0, "hist": 1, "first": 2, "memonly": 3, "noatomic": 4, "mod32": 5,
                  "fastdiv": 6}
K9_VARIANTS = tuple(K9_VARIANT_IDS)
K9_TIMING_ONLY = ("memonly", "noatomic")
K9_HISTOGRAM = ("hist", "first", "memonly", "noatomic", "mod32", "fastdiv")
K9_PROBE_LAUNCHES = {v: 0 for v in K9_VARIANTS}


def reset_launches() -> None:
    for counter in (LAUNCHES, PROBE_LAUNCHES, K9_PROBE_LAUNCHES):
        for k in counter:
            counter[k] = 0


def k9_fastdiv(P: int) -> tuple:
    """(magic, shift) with n // P == (n * magic) >> shift for 0 <= n < 2^31:
    shift = 31 + ceil(log2 P) and magic = ceil(2^shift / P), below 2^32 (K9's
    remainder: n % P = n - P (n * magic >> shift), one wide multiply)."""
    if not 1 <= P < 1 << 31:
        raise ValueError(f"K9's remainder takes 1 <= P < 2^31, got {P}")
    shift = 31 + (P - 1).bit_length()
    return -(-(1 << shift) // P), shift


def keys_to_int32(keys: torch.Tensor) -> torch.Tensor:
    """uint32 keys held in int64 -> int32 with the top bit flipped: the int32
    order is the uint32 order, INVALID_KEY becomes 2^31 - 1 (last)."""
    return (keys - KEY_FLIP).to(torch.int32)


def keys_from_int32(keys: torch.Tensor) -> torch.Tensor:
    """The inverse of keys_to_int32: the uint32 values as int64."""
    return keys.to(torch.int64) + KEY_FLIP


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


def _slot_keys_chain(
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
    """K8's plain chain: slot enumeration + StopThePop exact culling + key
    packing, k-major, every per-slot tensor (K, P); keys as uint32 values in
    int64. See `compute_slot_keys_kmajor`."""
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


def _rows_view(name: str, t: torch.Tensor, P: int, cols: int, device) -> torch.Tensor:
    """`t` (P, cols) float32 on `device` with unit column stride (the splat
    table's strided views pass as they are), else a contiguous copy."""
    if tuple(t.shape) != (P, cols) or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be ({P}, {cols}) float32 on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t if t.stride(1) == 1 else t.contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bin_keys_plain(xy, depth, conic, opacity, radius, active, grid: TileGrid, K: int,
                   depth_bits: int, band_ty0: int = 0, band_n_ty: int = None, *, dkey=None):
    """K8's plain version (`bin_keys`): the PyTorch chain the port ran before
    the kernel, its keys mapped to int32."""
    if dkey is None:
        live = active & (radius > 0.0)
        dkey = depth_key(depth, depth_bits)
    else:
        live = active
    keys, touched, truncated = _slot_keys_chain(xy, dkey, conic, opacity, radius, live, grid,
                                                K, depth_bits, band_ty0, band_n_ty)
    return keys_to_int32(keys), touched, torch.stack([truncated,
                                                      touched.sum(dtype=torch.int32)])


def bin_ranges_plain(sorted_keys, sorted_slots, m_eff: int, m_pad: int, P: int,
                     num_tiles: int, depth_bits: int, tile0: int = 0):
    """K9's plain version (`bin_ranges`): searchsorted over the sorted tile
    ids, the Gaussian of every entry and a histogram of the live ones. A
    list shorter than m_eff (the live slots alone) reads as dead past its
    end."""
    dev = sorted_keys.device
    keys = keys_from_int32(sorted_keys[:m_eff])
    short = m_eff - keys.shape[0]
    if short > 0:
        keys = torch.cat([keys, torch.full((short,), INVALID_KEY, dtype=keys.dtype, device=dev)])
        sorted_slots = torch.cat([sorted_slots[:m_eff], sorted_slots.new_zeros(short)])
    boundaries = tile0 + torch.arange(num_tiles + 1, dtype=torch.int64, device=dev)
    edges = torch.searchsorted(keys >> depth_bits, boundaries, side="left").to(torch.int32)
    # dead entries (INVALID keys past num_valid, plus the M_pad round-up tail)
    # carry sentinel id P -> zero splat rows. Slot ids are k-major.
    gauss = torch.where(keys != INVALID_KEY, sorted_slots[:m_eff] % P, P).to(torch.int32)
    sorted_gauss = torch.cat(
        [gauss, torch.full((m_pad - m_eff,), P, dtype=torch.int32, device=dev)])
    cnt = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add_(
        0, gauss, torch.ones_like(gauss))[:P]
    return sorted_gauss, edges[:-1], edges[1:] - edges[:-1], cnt


def sort_live_slots_plain(keys: torch.Tensor):
    """K13's plain version (`sort_live_slots`): the live slots of K8's int32
    keys (key != DEAD_KEY) in slot order, then the stable sort of their
    keys. Returns (keys (n,) int32, slot ids (n,) int32, n () int32): the
    first n entries of the stable sort of all the keys."""
    slots = torch.nonzero(keys != DEAD_KEY).reshape(-1)
    sorted_keys, order = torch.sort(keys[slots], stable=True)
    return sorted_keys, slots[order].to(torch.int32), torch.tensor(
        slots.shape[0], dtype=torch.int32, device=keys.device)


def gather_splats_plain(table: torch.Tensor, sorted_gauss: torch.Tensor) -> torch.Tensor:
    """K10's plain version: (M_pad, 16) rows of the (P+1, 16) table."""
    return table[sorted_gauss.long()]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _k8(xy, depth, conic, opacity, radius, active, grid: TileGrid, K: int, depth_bits: int,
        band_ty0: int, band_n_ty, dkey, variant=None):
    """K8 on CUDA tensors; with `variant`, that variant of K8_VARIANTS
    through the probe entry."""
    dev = xy.device
    P = xy.shape[0]
    xy = _rows_view("xy", xy, P, 2, dev)
    conic = _rows_view("conic", conic, P, 3, dev)
    if dkey is None:
        _check("depth", depth, (P,), torch.float32, dev)
    else:
        _check("dkey", dkey, (P,), torch.int64, dev)
    _check("opacity", opacity, (P,), torch.float32, dev)
    _check("radius", radius, (P,), torch.float32, dev)
    _check("active", active, (P,), torch.bool, dev)
    keys = torch.empty(K * P, dtype=torch.int32, device=dev)
    touched = torch.empty(P, dtype=torch.int32, device=dev)
    # K8 adds its blocks' sums into zeros; `fold` writes them itself
    sums = (torch.empty if variant == "fold" and P else torch.zeros)(2, dtype=torch.int32,
                                                                      device=dev)
    if P == 0:
        return keys, touched, sums
    from gaussian_lic_tpu_torch import _build

    null = ctypes.c_void_p(None)
    args = (_ptr(xy), xy.stride(0), _ptr(conic), conic.stride(0),
            null if dkey is not None else _ptr(depth), null if dkey is None else _ptr(dkey),
            _ptr(opacity), _ptr(radius), _ptr(active), P, K, depth_bits, grid.n_tx, grid.n_ty,
            grid.tile_w, grid.tile_h, band_ty0, -1 if band_n_ty is None else band_n_ty,
            ctypes.c_float(OPACITY_THRESHOLD), _ptr(keys), _ptr(touched), _ptr(sums),
            _stream(dev))
    lib = _build.load().cdll
    if variant is None:
        _launch(lib.glic_bin_keys, *args)
        LAUNCHES["bin_keys"] += 1
    else:
        _launch(lib.glic_bin_keys_probe, K8_VARIANT_IDS[variant], *args)
        PROBE_LAUNCHES[variant] += 1
    return keys, touched, sums


def bin_keys(xy, depth, conic, opacity, radius, active, grid: TileGrid, K: int,
             depth_bits: int, band_ty0: int = 0, band_n_ty: int = None, *, dkey=None):
    """K8: the K slot keys of every Gaussian. live = active & (radius > 0)
    and the depth key of `depth` (`depth_key`); or, with `dkey` (P,) int64,
    those depth keys and `active` as the live mask as it is (`depth` unused).
    With `band_n_ty`, band-local tile ids and the slots outside the band
    dead; without, global tile ids. Returns (keys (K*P,) int32, slot k*P + p,
    in `keys_to_int32`'s form; tiles_touched (P,) int32; sums (2,) int32:
    the rect tiles lost to the K-slot cap, counted in the band when there is
    one, and the live slots)."""
    if xy.device.type == "cpu":
        return bin_keys_plain(xy, depth, conic, opacity, radius, active, grid, K, depth_bits,
                              band_ty0, band_n_ty, dkey=dkey)
    if xy.device.type != "cuda":
        raise ValueError(f"bin_keys takes CPU or CUDA tensors, got {xy.device}")
    return _k8(xy, depth, conic, opacity, radius, active, grid, K, depth_bits, band_ty0,
               band_n_ty, dkey)


def bin_keys_probe(variant, xy, depth, conic, opacity, radius, active, grid: TileGrid, K: int,
                   depth_bits: int, band_ty0: int = 0, band_n_ty: int = None, *, dkey=None):
    """K8's timing variant `variant` (K8_VARIANTS), with bin_keys' arguments
    and outputs. CPU tensors: `bin_keys_plain` for the variants that compute
    K8's outputs; the timing-only ones have no plain version and raise."""
    if variant not in K8_VARIANTS:
        raise ValueError(f"unknown K8 variant {variant!r}; one of {K8_VARIANTS}")
    if xy.device.type == "cpu":
        if variant in K8_TIMING_ONLY:
            raise ValueError(f"K8 {variant} is a timing probe of the card: it has no plain "
                             "version")
        return bin_keys_plain(xy, depth, conic, opacity, radius, active, grid, K, depth_bits,
                              band_ty0, band_n_ty, dkey=dkey)
    if xy.device.type != "cuda":
        raise ValueError(f"bin_keys takes CPU or CUDA tensors, got {xy.device}")
    return _k8(xy, depth, conic, opacity, radius, active, grid, K, depth_bits, band_ty0,
               band_n_ty, dkey, variant)


def _k9(sorted_keys, sorted_slots, m_eff: int, m_pad: int, P: int, num_tiles: int,
        depth_bits: int, tile0: int, slot_keys, touched, sums, variant=None):
    """K9 on CUDA tensors; with `variant`, that variant of K9_VARIANTS through
    the probe entry."""
    dev = sorted_keys.device
    n = sorted_keys.shape[0]
    if not m_eff <= min(n, sorted_slots.shape[0]) or m_pad < m_eff:
        raise ValueError(f"bin_ranges: m_eff {m_eff} and m_pad {m_pad} against {n} keys")
    _check("sorted_keys", sorted_keys, (n,), torch.int32, dev)
    _check("sorted_slots", sorted_slots, (sorted_slots.shape[0],), torch.int32, dev)
    given = [v is not None for v in (slot_keys, touched, sums)]
    if any(given) and not all(given):
        raise ValueError("bin_ranges takes K8's slot_keys, touched and sums together or none")
    counted = all(given) and variant not in K9_HISTOGRAM
    if all(given):
        _check("touched", touched, (P,), torch.int32, dev)
        _check("sums", sums, (2,), torch.int32, dev)
        _check("slot_keys", slot_keys, (slot_keys.shape[0],), torch.int32, dev)
        if slot_keys.shape[0] % P:
            raise ValueError(f"slot_keys holds {slot_keys.shape[0]} keys, not K of {P} each")
    sorted_gauss = torch.empty(m_pad, dtype=torch.int32, device=dev)
    tile_starts = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    if counted:   # K9 writes cnt whole: only the lengths' atomics need zeros
        tile_lens = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
        cnt = torch.empty(P, dtype=torch.int32, device=dev)
    else:
        counts = torch.zeros(num_tiles + P, dtype=torch.int32, device=dev)
        tile_lens, cnt = counts[:num_tiles], counts[num_tiles:]
    from gaussian_lic_tpu_torch import _build

    null = ctypes.c_void_p(None)
    args = (_ptr(sorted_keys), _ptr(sorted_slots), m_eff, m_pad, P, num_tiles, depth_bits, tile0,
            *k9_fastdiv(P), *((_ptr(touched), _ptr(sums), _ptr(slot_keys)) if all(given)
                              else (null, null, null)),
            slot_keys.shape[0] if all(given) else 0, _ptr(sorted_gauss), _ptr(tile_starts),
            _ptr(tile_lens), _ptr(cnt), _stream(dev))
    lib = _build.load().cdll
    if variant is None:
        _launch(lib.glic_bin_ranges, *args)
        LAUNCHES["bin_ranges"] += 1
    else:
        _launch(lib.glic_bin_ranges_probe, K9_VARIANT_IDS[variant], *args)
        K9_PROBE_LAUNCHES[variant] += 1
    return sorted_gauss, tile_starts, tile_lens, cnt


def bin_ranges(sorted_keys, sorted_slots, m_eff: int, m_pad: int, P: int, num_tiles: int,
               depth_bits: int, tile0: int = 0, *, slot_keys=None, touched=None, sums=None):
    """K9 over the first `m_eff` entries of K8's keys as the stable sort left
    them (`sorted_keys` int32, `sorted_slots` int32 slot ids k*P + p; tile
    ids are key >> depth_bits - tile0). With K8's `sums`, the kernel reads
    only the first sums[1] entries (K13's list) and takes the rest up to
    m_eff as dead; the plain version takes a list shorter than m_eff as dead
    past its end. Returns (sorted_gauss (m_pad,) int32, P for dead entries
    and the tail; tile_starts (num_tiles,) int32, the searchsorted of each
    tile; tile_lens (num_tiles,) int32; cnt (P,) int32, the live entries of
    each Gaussian). With K8's outputs for these keys, `slot_keys` (K*P,)
    int32, `touched` (P,) and `sums` (2,), K9 takes cnt as the JAX package
    does (touched where the live slots fit the list, else the survivor
    compare over slot_keys): no atomics and no zeroed cnt; without them (a
    list merged from other ranks) it counts the entries."""
    dev = sorted_keys.device
    if dev.type == "cpu":
        return bin_ranges_plain(sorted_keys, sorted_slots, m_eff, m_pad, P, num_tiles,
                                depth_bits, tile0)
    if dev.type != "cuda":
        raise ValueError(f"bin_ranges takes CPU or CUDA tensors, got {dev}")
    return _k9(sorted_keys, sorted_slots, m_eff, m_pad, P, num_tiles, depth_bits, tile0,
               slot_keys, touched, sums)


def bin_ranges_probe(variant, sorted_keys, sorted_slots, m_eff: int, m_pad: int, P: int,
                     num_tiles: int, depth_bits: int, tile0: int = 0, *, slot_keys=None,
                     touched=None, sums=None):
    """K9's timing variant `variant` (K9_VARIANTS), with bin_ranges' arguments
    and outputs. CPU tensors: `bin_ranges_plain` for the variants that
    compute K9's outputs; the timing-only ones have no plain version and
    raise."""
    if variant not in K9_VARIANTS:
        raise ValueError(f"unknown K9 variant {variant!r}; one of {K9_VARIANTS}")
    dev = sorted_keys.device
    if dev.type == "cpu":
        if variant in K9_TIMING_ONLY:
            raise ValueError(f"K9 {variant} is a timing probe of the card: it has no plain "
                             "version")
        return bin_ranges_plain(sorted_keys, sorted_slots, m_eff, m_pad, P, num_tiles,
                                depth_bits, tile0)
    if dev.type != "cuda":
        raise ValueError(f"bin_ranges takes CPU or CUDA tensors, got {dev}")
    return _k9(sorted_keys, sorted_slots, m_eff, m_pad, P, num_tiles, depth_bits, tile0,
               slot_keys, touched, sums, variant)


def _k13(keys: torch.Tensor):
    """K13 on a CUDA tensor: a fill and six kernels, none sized by the live
    count, and nothing read back."""
    dev = keys.device
    n = keys.shape[0]
    _check("keys", keys, (n,), torch.int32, dev)
    if n >= 1 << 31:
        raise ValueError(f"sort_live_slots takes fewer than 2^31 slots (int32 slot ids), got {n}")
    compact_tile, sort_tile = SORT_LIVE_TILES
    out = torch.empty((2, n), dtype=torch.int32, device=dev)      # keys, slot ids
    second = torch.empty((2, n), dtype=torch.int32, device=dev)   # the passes' other buffers
    scratch = torch.zeros(SORT_LIVE_ZERO_WORDS + 2 * -(-n // compact_tile), dtype=torch.int32,
                          device=dev)
    words = torch.empty(-(-n // sort_tile) * SORT_LIVE_BINS, dtype=torch.int64, device=dev)
    from gaussian_lic_tpu_torch import _build

    _launch(_build.load().cdll.glic_sort_live, _ptr(keys), n, _ptr(out[0]), _ptr(out[1]),
            _ptr(second[0]), _ptr(second[1]), _ptr(scratch), _ptr(words), _stream(dev))
    LAUNCHES["sort_live"] += 1
    return out[0], out[1], scratch[0]


def sort_live_slots(keys: torch.Tensor):
    """K13: the stable sort of the live slots of K8's (K*P,) int32 keys,
    taken in slot order: (keys int32, slot ids int32, n () int32), whose
    first n entries are the first n of the stable sort of all the keys.
    CUDA tensors: the kernels, the two lists K*P long (entries from n on
    hold whatever was there) and n on the device. CPU tensors: the plain
    version, lists n long."""
    if keys.device.type == "cpu":
        return sort_live_slots_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_live_slots takes CPU or CUDA tensors, got {keys.device}")
    return _k13(keys)


def gather_splats(table: torch.Tensor, sorted_gauss: torch.Tensor) -> torch.Tensor:
    """K10: (M_pad, 16) sorted splat rows of the (P+1, 16) table; the dead
    id P reads its zero row."""
    dev = table.device
    if dev.type == "cpu":
        return gather_splats_plain(table, sorted_gauss)
    if dev.type != "cuda":
        raise ValueError(f"gather_splats takes CPU or CUDA tensors, got {dev}")
    m = sorted_gauss.shape[0]
    if table.dim() != 2:
        raise ValueError(f"table must be (n, {SPLAT_ROWS}), got {tuple(table.shape)}")
    _check("table", table, (table.shape[0], SPLAT_ROWS), torch.float32, dev)
    if table.data_ptr() % 16:
        raise ValueError("K10 moves 16-byte vectors: table must be 16-byte aligned")
    _check("sorted_gauss", sorted_gauss, (m,), torch.int32, dev)
    out = torch.empty((m, SPLAT_ROWS), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    from gaussian_lic_tpu_torch import _build

    _launch(_build.load().cdll.glic_gather_splats, _ptr(table), table.shape[0],
            _ptr(sorted_gauss), m, _ptr(out), _stream(dev))
    LAUNCHES["gather_splats"] += 1
    return out


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
    """Slot enumeration + StopThePop exact culling + key packing, k-major
    (K8 on the card). With `band_n_ty`, keys carry BAND-LOCAL tile ids and
    the slots outside the band are dead (bin_gaussians of a band); without,
    GLOBAL tile ids (the sharded binning, parallel/sharded.py). Returns
    (keys (K*P,) int64, the uint32 values, slot id k*P + p; tiles_touched
    (P,) int32; truncated () int32: the rect tiles lost to the K-slot cap,
    counted in the band when there is one)."""
    keys, touched, sums = bin_keys(xy, None, conic, opacity, radius, live, grid, K,
                                   depth_bits, band_ty0, band_n_ty, dkey=dkey)
    return keys_from_int32(keys), touched, sums[0]


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
    length M_pad equal to the JAX package's. K8, the stable sort of its
    32-bit keys (K13, which sorts only the live slots), and K9."""
    P = xy.shape[0]
    K = max_tiles_per_gaussian
    M = max_total_splats
    n_ty_local = grid.n_ty if band_n_ty is None else band_n_ty
    num_tiles_local = n_ty_local * grid.n_tx
    if depth_bits is None:
        depth_bits = rank_bits_for(num_tiles_local)

    keys, tiles_touched, sums = bin_keys(
        xy, depth, conic, opacity, radius, active, grid, K, depth_bits,
        band_ty0=band_ty0, band_n_ty=n_ty_local,
    )
    # the stable sort of the live slots (ties keep slot-id, k-major, order):
    # the first num_valid entries of the stable sort of all the slots
    sorted_keys, sorted_slots, _ = sort_live_slots(keys)

    truncated, num_valid = sums[0], sums[1]
    budget_lost = torch.clamp_min(num_valid - M, 0)
    overflow = truncated + budget_lost

    m_eff = min(M, P * K)  # the sorted list can't exceed the slot count
    M_pad = ((m_eff + align - 1) // align) * align
    # with budget loss, a slot survives iff (key, slot) sorts before the
    # m_eff-th smallest (key, slot): K9 compares K8's keys with that entry's
    # (JAX's survivor compare); else every live slot survives: cnt = touched
    sorted_gauss, tile_starts, tile_lens, cnt = bin_ranges(
        sorted_keys, sorted_slots, m_eff, M_pad, P, num_tiles_local, depth_bits,
        slot_keys=keys, touched=tiles_touched, sums=sums)

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
