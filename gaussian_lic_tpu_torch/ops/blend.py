"""Tile blending: kernels K1 (`blend_forward`) and K2 (`blend_backward`).

The counterparts of the JAX package's Pallas kernels in
`gaussian_lic_tpu/ops/blend_pallas.py` (`_forward_kernel`/`blend_forward`,
`_backward_kernel`/`blend_backward`), i.e. of the reference's renderCUDA
(forward.cu:321-481) and PerGaussianRenderCUDA (backward.cu:379-597).

Inputs are the gathered splat rows (M_pad, 16) float32 — x, y, conic A/B/C,
opacity, r, g, b in columns 0..8, the rest unused — and each tile's entry range
[start, start+len) of that list. Outputs are in image space, (padded H,
padded W). Per pixel, entries are walked front to back:

  power = -1/2 (A dx^2 + C dy^2) - B dx dy,  dx = x - px (pixel centres, no +0.5)
  alpha = min(0.99, opa * exp(power));  skipped if alpha < 1/255 or power > 0
  if T (1 - alpha) < 1e-4 the pixel stops WITHOUT applying the entry,
  else C += alpha T rgb, T *= (1 - alpha)

n_contrib is the 1-based in-range index of the last applied entry. The
backward rebuilds T by division from final_T, back to front, computes
per-entry gradients for (x, y, A, B, C, opa, r, g, b) and sums them per
Gaussian (the entry -> Gaussian map `sorted_gauss`): it returns (P, 9). It
uses the exact conic convention (-dx^2/2, -dx dy, -dy^2/2) and does not mask
the alpha cap (reference parity, backward.cu:553).

Dispatch: a CPU tensor goes to the plain PyTorch version (`*_plain`; for the
backward, the per-entry `blend_backward_plain` then `sum_per_gaussian`); a
CUDA tensor launches the hand-written CUDA kernel (csrc/blend_forward.cu,
csrc/blend_backward.cu, which sums per Gaussian with atomics) or raises.
Each launch adds one to `LAUNCHES` (a CUDA graph adds its recorded launches
at each replay, `launches_apart`). Both kernels bulk-copy whole rows, so
on the card `splats` must be 16-byte aligned.

K1 skips an entry in a warp's pixel block (`k1_block`: 8x16 in tiles of 16
rows and 8 columns or more, else 128 pixels as wide or as narrow as the tile
asks) when the entry's footprint box misses the block (`cull_boxes`):
the box holds every pixel at which the per-pixel arithmetic above could
apply the entry, so a skipped pair is one the test would reject, and K1's
outputs are those of the plain version, which tests every pair. K2 culls
its walk by the same rule at the same warp blocks (two to each of its 4
bands), so its gradients are the plain version's summed in another order.
`warp_cull_keep` is the plain emulation of that rule, for the tests and
chip_smoke.py; the main path never calls it.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Tuple

import torch

from gaussian_lic_tpu_torch.ops.projection import OPACITY_THRESHOLD

ALPHA_CAP = 0.99          # forward.cu:436
T_EPS = 1e-4              # forward.cu:439
SPLAT_ROWS = 16           # floats per gathered splat row
N_ATTR = 9                # of which used: x, y, A, B, C, opa, r, g, b
ROW_X, ROW_Y, ROW_A, ROW_B, ROW_C, ROW_OPA, ROW_R, ROW_G, ROW_B2 = range(N_ATTR)
TILE_PIX = 1024           # pixels per tile; the kernels spread them over 256 threads
GAUSS_TABLE_STRIDE = 12   # floats per row of K2's per-Gaussian table (three float4s)
WARP_PIX = 128            # pixels of one warp's block in K1 (32 threads x 4)

# K1's cull box (csrc/blend_common.cuh, cull_box): the bounding box of
# q(d) <= (ln(255 opa) + CULL_POWER_ABS) / (1 - CULL_POWER_REL kappa), kappa =
# (A + C)^2 / det, widened by CULL_BOX_REL of its half-widths + CULL_BOX_ABS px.
# K3 noexp's box (`linear`) takes (0.9 - (1/255) / opa) / 0.1 + CULL_LINEAR_ABS
# in place of ln(255 opa) + CULL_POWER_ABS.
CULL_POWER_REL = 1e-6     # above the 6 roundings' 3.6e-7 of the float power, per kappa q
CULL_POWER_ABS = 2e-6     # above expf's 2 ulp + the product's half ulp (3e-7)
CULL_LINEAR_ABS = 1e-5    # above the linear G's 3 roundings, 2e-6 in power
CULL_BOX_REL = 1e-3
CULL_BOX_ABS = 0.01

# Launch counts of the CUDA kernels (plain-version calls are not counted).
LAUNCHES = {"forward": 0, "forward_no_color": 0, "backward": 0}

# Bound on the (tiles x entries x pixels) elements one plain-version chunk holds.
_PLAIN_CHUNK_ELEMS = 1 << 25


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def launches_apart(*counters):
    """Takes the launches counted inside the block out of `counters` (launch
    dicts with distinct keys; default LAUNCHES) and puts them in the dict it
    yields, when the block ends. A CUDA graph's capture runs the wrappers
    but executes nothing: its graph adds what it recorded at each replay
    (engine/trainer.py, BundleGraphs)."""
    counters = counters or (LAUNCHES,)
    before = [dict(c) for c in counters]
    apart: dict = {}
    try:
        yield apart
    finally:
        for c, b in zip(counters, before):
            for k in c:
                apart[k] = c[k] - b[k]
                c[k] = b[k]


# ---------------------------------------------------------------------------
# argument checks shared by both dispatch targets
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(splats, tile_starts, tile_lens, n_tx, n_ty, tile_h, tile_w):
    if tile_h * tile_w != TILE_PIX:
        raise ValueError(f"tile_h*tile_w must be {TILE_PIX}, got {tile_h}x{tile_w}")
    if splats.dim() != 2:
        raise ValueError(f"splats must be (M_pad, {SPLAT_ROWS}), got {tuple(splats.shape)}")
    _check("splats", splats, (splats.shape[0], SPLAT_ROWS), torch.float32, splats.device)
    n_tiles = n_tx * n_ty
    _check("tile_starts", tile_starts, (n_tiles,), torch.int32, splats.device)
    _check("tile_lens", tile_lens, (n_tiles,), torch.int32, splats.device)


def _check_aligned(splats, kernel):
    if splats.data_ptr() % 16:
        raise ValueError(f"{kernel} bulk-copies whole rows: splats must be 16-byte aligned")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blend kernels take CPU or CUDA tensors, got {t.device}")
    return t.device.type


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        from gaussian_lic_tpu_torch import _build

        raise RuntimeError(f"CUDA launch failed: {_build.error_string(rc)} ({rc})")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def blend_forward(
    splats: torch.Tensor,       # (M_pad, 16) float32 gathered splat rows
    tile_starts: torch.Tensor,  # (T,) int32
    tile_lens: torch.Tensor,    # (T,) int32
    *,
    n_tx: int,
    n_ty: int,
    tile_h: int = 32,
    tile_w: int = 32,
    no_color: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1. Returns (color (3, Hp, Wp), final_T (Hp, Wp), n_contrib (Hp, Wp)
    int32). With `no_color`, only final_T is computed; color and n_contrib
    are zeros."""
    _check_common(splats, tile_starts, tile_lens, n_tx, n_ty, tile_h, tile_w)
    if _device_kind(splats) == "cpu":
        return blend_forward_plain(splats, tile_starts, tile_lens, n_tx=n_tx,
                                   n_ty=n_ty, tile_h=tile_h, tile_w=tile_w,
                                   no_color=no_color)
    _check_aligned(splats, "K1")
    from gaussian_lic_tpu_torch import _build

    lib = _build.load()
    dev = splats.device
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    color = torch.empty((3, Hp, Wp), dtype=torch.float32, device=dev)
    final_t = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    _launch(lib.cdll.glic_blend_forward, _ptr(splats), ctypes.c_longlong(splats.shape[0]),
            _ptr(tile_starts), _ptr(tile_lens), _ptr(color), _ptr(final_t),
            _ptr(n_contrib), n_tx, n_ty, tile_w, tile_h, int(no_color), _stream(dev))
    LAUNCHES["forward_no_color" if no_color else "forward"] += 1
    return color, final_t, n_contrib


def longest_first(tile_lens: torch.Tensor) -> torch.Tensor:
    """(T,) int32 tile order in which K2 launches the tiles: every tile once,
    longest range first (ties in tile order), computed on the tiles' device."""
    return torch.argsort(tile_lens, descending=True, stable=True).to(torch.int32)


def blend_backward(
    splats: torch.Tensor,       # (M_pad, 16) float32
    tile_starts: torch.Tensor,  # (T,) int32
    tile_lens: torch.Tensor,    # (T,) int32
    dl_dcolor: torch.Tensor,    # (3, Hp, Wp) float32
    final_t: torch.Tensor,      # (Hp, Wp) float32
    n_contrib: torch.Tensor,    # (Hp, Wp) int32
    sorted_gauss: torch.Tensor, # (M_pad,) int32 Gaussian id of each entry, in [0, P]
    *,
    n_gauss: int,               # P; id P is the dead id
    n_tx: int,
    n_ty: int,
    tile_h: int = 32,
    tile_w: int = 32,
) -> torch.Tensor:
    """K2. Returns per-Gaussian gradients (P, 9) float32 for
    (x, y, A, B, C, opa, r, g, b): each entry's gradient summed into row
    sorted_gauss[entry]; entries of the dead id P are dropped. Every id
    must lie in [0, P], as the binning makes them."""
    _check_common(splats, tile_starts, tile_lens, n_tx, n_ty, tile_h, tile_w)
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    dev = splats.device
    _check("dl_dcolor", dl_dcolor, (3, Hp, Wp), torch.float32, dev)
    _check("final_t", final_t, (Hp, Wp), torch.float32, dev)
    _check("n_contrib", n_contrib, (Hp, Wp), torch.int32, dev)
    _check("sorted_gauss", sorted_gauss, (splats.shape[0],), torch.int32, dev)
    if n_gauss < 0:
        raise ValueError(f"need n_gauss >= 0, got {n_gauss}")
    if _device_kind(splats) == "cpu":
        per_entry = blend_backward_plain(splats, tile_starts, tile_lens, dl_dcolor,
                                         final_t, n_contrib, n_tx=n_tx, n_ty=n_ty,
                                         tile_h=tile_h, tile_w=tile_w)
        return sum_per_gaussian(per_entry, sorted_gauss, n_gauss)
    _check_aligned(splats, "K2")
    from gaussian_lic_tpu_torch import _build

    lib = _build.load()
    order = longest_first(tile_lens)
    table = torch.zeros((n_gauss + 1, GAUSS_TABLE_STRIDE), dtype=torch.float32, device=dev)
    _launch(lib.cdll.glic_blend_backward, _ptr(splats), ctypes.c_longlong(splats.shape[0]),
            _ptr(tile_starts), _ptr(tile_lens), _ptr(order),
            _ptr(dl_dcolor), _ptr(final_t), _ptr(n_contrib), _ptr(sorted_gauss),
            _ptr(table), n_tx, n_ty, tile_w, tile_h, _stream(dev))
    LAUNCHES["backward"] += 1
    return table[:n_gauss, :N_ATTR]


def sum_per_gaussian(per_entry: torch.Tensor, sorted_gauss: torch.Tensor,
                     n_gauss: int) -> torch.Tensor:
    """(P, 9): per-entry gradients (M_pad, 9) summed per Gaussian id; the
    dead id P's row is dropped."""
    out = per_entry.new_zeros((n_gauss + 1, per_entry.shape[1]))
    return out.index_add_(0, sorted_gauss.long(), per_entry)[:n_gauss]


# ---------------------------------------------------------------------------
# plain PyTorch versions: vectorised over (tiles, entries, pixels)
# ---------------------------------------------------------------------------

def _tile_chunks(tile_lens: torch.Tensor):
    """Yield (tile index tensor, padded entry count L) groups whose
    (tiles x L x 1024) working set stays under _PLAIN_CHUNK_ELEMS."""
    lens = tile_lens.tolist()
    n = len(lens)
    i = 0
    while i < n:
        j, L = i, 0
        while j < n:
            L2 = max(L, lens[j], 1)
            if j > i and (j - i + 1) * L2 * TILE_PIX > _PLAIN_CHUNK_ELEMS:
                break
            L = L2
            j += 1
        yield torch.arange(i, j, device=tile_lens.device), L
        i = j


def _pixel_coords(tiles, n_tx, tile_h, tile_w):
    """(G, 1024) pixel x, y of the given tiles, row-major within the tile."""
    flat = torch.arange(TILE_PIX, device=tiles.device)
    tx = (tiles % n_tx)[:, None]
    ty = torch.div(tiles, n_tx, rounding_mode="floor")[:, None]
    px = (tx * tile_w + flat[None] % tile_w).float()
    py = (ty * tile_h + torch.div(flat[None], tile_w, rounding_mode="floor")).float()
    return px, py


def _gather_entries(splats, tile_starts, tile_lens, tiles, L):
    """(G, L, 9) attributes of each tile's range, zeros past its length; also
    returns the (G, L) global entry index and validity mask."""
    ar = torch.arange(L, device=splats.device)
    valid = ar[None, :] < tile_lens[tiles].long()[:, None]
    idx = tile_starts[tiles].long()[:, None] + ar[None, :]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    e = splats[idx][..., :N_ATTR] * valid[..., None]
    return e, idx, valid


def _alpha(e, px, py, exp=torch.exp):
    """Per (tile, entry, pixel): dx, dy, power, exp(power), alpha, contributes;
    the same operations, in the same order, as the kernels. `exp` is the
    probes' hook (ops/blend_probe.py)."""
    x, y, A, B, C, opa = (e[..., i:i + 1] for i in range(6))
    dx = x - px[:, None, :]
    dy = y - py[:, None, :]
    nA = -0.5 * A
    nC = -0.5 * C
    power = (nA * dx - B * dy) * dx + (nC * dy) * dy
    G = exp(power)
    alpha = torch.clamp_max(opa * G, ALPHA_CAP)
    contrib = (alpha >= OPACITY_THRESHOLD) & (power <= 0.0)
    return dx, dy, power, G, alpha, contrib


def _walked(trigger, lens, batch):
    """Entries walked per tile by a kernel that stages `batch` entries per
    round and leaves at the first round that starts with every pixel of the
    tile stopped; `trigger` (G, L, 1024) marks where a pixel stops."""
    stops = trigger.any(1)                                          # (G, 1024)
    last = torch.where(stops, trigger.to(torch.int32).argmax(1), 0).amax(1)
    rounds = torch.div(last, batch, rounding_mode="floor") + 1
    walk = torch.minimum(rounds * batch, lens)
    return torch.where(stops.all(1), walk, lens).to(torch.int32)


def _to_image(per_tile: torch.Tensor, n_tx, n_ty, tile_h, tile_w) -> torch.Tensor:
    """(T, ..., 1024) tile-major -> (..., Hp, Wp), contiguous (a one-row or
    one-column tile would otherwise leave a strided view, which K2 rejects)."""
    lead = per_tile.shape[1:-1]
    x = per_tile.reshape((n_ty, n_tx) + lead + (tile_h, tile_w))
    nl = len(lead)
    perm = tuple(range(2, 2 + nl)) + (0, 2 + nl, 1, 3 + nl)
    return x.permute(perm).reshape(lead + (n_ty * tile_h, n_tx * tile_w)).contiguous()


def _to_tiles(img: torch.Tensor, n_tx, n_ty, tile_h, tile_w) -> torch.Tensor:
    """(..., Hp, Wp) -> (T, ..., 1024) tile-major."""
    lead = img.shape[:-2]
    nl = len(lead)
    x = img.reshape(lead + (n_ty, tile_h, n_tx, tile_w))
    perm = (nl, nl + 2) + tuple(range(nl)) + (nl + 1, nl + 3)
    return x.permute(perm).reshape((n_ty * n_tx,) + lead + (TILE_PIX,))


def blend_forward_plain(
    splats, tile_starts, tile_lens, *, n_tx, n_ty, tile_h=32, tile_w=32,
    no_color=False, t_eps=T_EPS, exp=torch.exp, walked=None, walk_batch=128,
):
    """Plain version of K1 (same signature and outputs). Front-to-back
    termination is emulated with cumulative products and a 'dead after the
    first trigger' mask; the cumulative product runs along a non-innermost
    dimension, which PyTorch scans sequentially, so T matches the kernel's
    running product. Every entry is tested at every pixel of its tile.
    `t_eps` exists for the tie check of the kernel test.

    The probes' hooks (ops/blend_probe.py): `exp` replaces torch.exp, and a
    (T,) int32 `walked` receives the entries each tile's walk visits in a
    kernel that stages `walk_batch` entries per round and leaves at the first
    round that starts with every pixel stopped."""
    dev = splats.device
    n_tiles = n_tx * n_ty
    color_t = torch.zeros((n_tiles, 3, TILE_PIX), dtype=torch.float32, device=dev)
    final_t_t = torch.ones((n_tiles, TILE_PIX), dtype=torch.float32, device=dev)
    ncontrib_t = torch.zeros((n_tiles, TILE_PIX), dtype=torch.int32, device=dev)
    for tiles, L in _tile_chunks(tile_lens):
        e, _, _ = _gather_entries(splats, tile_starts, tile_lens, tiles, L)
        px, py = _pixel_coords(tiles, n_tx, tile_h, tile_w)
        _, _, _, _, alpha, contrib = _alpha(e, px, py, exp)
        a = torch.where(contrib, alpha, torch.zeros_like(alpha))
        t_f = 1.0 - a
        T_excl = torch.cumprod(torch.cat([torch.ones_like(t_f[:, :1]), t_f[:, :-1]], 1), 1)
        trigger = contrib & (T_excl * t_f < t_eps)
        if walked is not None:
            walked[tiles] = _walked(trigger, tile_lens[tiles], walk_batch)
        applied = contrib & ~(torch.cumsum(trigger.to(torch.int32), 1) > 0)
        a = torch.where(applied, alpha, torch.zeros_like(alpha))
        t_f = 1.0 - a
        T_incl = torch.cumprod(t_f, 1)
        final_t_t[tiles] = T_incl[:, -1]
        if no_color:
            continue
        T_excl = torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]], 1)
        w = a * T_excl
        color_t[tiles] = torch.einsum("glp,glc->gcp", w, e[..., ROW_R:ROW_B2 + 1])
        pos = torch.arange(1, L + 1, dtype=torch.int32, device=dev)[None, :, None]
        ncontrib_t[tiles] = torch.where(applied, pos, 0).amax(1)
    return (
        _to_image(color_t, n_tx, n_ty, tile_h, tile_w),
        _to_image(final_t_t, n_tx, n_ty, tile_h, tile_w),
        _to_image(ncontrib_t, n_tx, n_ty, tile_h, tile_w),
    )


def _round_out(v: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 -> the nearest float32 at or below (`down`) or above `v`."""
    f = v.float()
    past = f.double() > v if down else f.double() < v
    step = torch.full_like(f, -math.inf if down else math.inf)
    return torch.where(past, torch.nextafter(f, step), f)


def cull_boxes(splats: torch.Tensor, linear: bool = False) -> torch.Tensor:
    """(M, 4) float32 (x_lo, x_hi, y_lo, y_hi) per gathered row: K1's
    cull_box. Outside the box no pixel centre can apply the entry: the box of
    the alpha >= 1/255 ellipse q(d) <= ln(255 opa), widened by the float
    error of the per-pixel test (CULL_* above). Every pixel when a used
    attribute is not finite, the conic is not positive definite or kappa is
    too large for the bound; no pixel when 255 opa < 1 (with a margin).
    `linear`: the box of K3 noexp's test, opa (0.1 power + 0.9) >= 1/255
    (no pixel when 0.9 opa < 1/255)."""
    x, y, A, B, C, opa = (splats[:, i].double() for i in range(6))
    inf = math.inf
    finite = torch.isfinite(splats[:, :6]).all(1)
    det = A * C - B * B
    shrink = 1.0 - CULL_POWER_REL * (A + C) * (A + C) / det
    if linear:   # the test's float32 constants, in double
        c09, c01, thr = torch.tensor([0.9, 0.1, OPACITY_THRESHOLD], dtype=torch.float32).tolist()
        none = opa * c09 * (1.0 + 1e-5) < thr
        q = (c09 - thr / opa) / c01 + CULL_LINEAR_ABS
    else:
        none = opa * 255.0 * (1.0 + 1e-6) < 1.0
        q = torch.log(255.0 * opa) + CULL_POWER_ABS
    t = torch.clamp_min(q, 0.0) / shrink
    s = 2.0 * t / det
    wx = torch.sqrt(s * C) * (1.0 + CULL_BOX_REL) + CULL_BOX_ABS
    wy = torch.sqrt(s * A) * (1.0 + CULL_BOX_REL) + CULL_BOX_ABS
    box = torch.stack([_round_out(x - wx, True), _round_out(x + wx, False),
                       _round_out(y - wy, True), _round_out(y + wy, False)], 1)
    every = splats.new_tensor([-inf, inf, -inf, inf])
    empty = splats.new_tensor([inf, -inf, inf, -inf])
    bounded = (det > 0) & (A > 0) & (shrink >= 0.5)
    box = torch.where(bounded[:, None], box, every)
    box = torch.where(none[:, None], empty, box)
    return torch.where(finite[:, None], box, every)


def k1_block(tile_h: int, tile_w: int) -> Tuple[int, int]:
    """(width, height) of K1's warp pixel blocks in a tile_h x tile_w tile,
    as csrc/blend_common.cuh (k1_block_w) picks them from the tile's shape:
    8x16 in tiles of 16 rows or more and 8 columns or more; in a tile of
    fewer rows one block row spans 128 / tile_h columns (16x8, 32x4, 64x2,
    128x1); in a tile of fewer columns the block is as wide as the tile (4x32,
    2x64, 1x128). Raises for a tile that does not hold TILE_PIX pixels."""
    if tile_h <= 0 or tile_w <= 0 or tile_h * tile_w != TILE_PIX:
        raise ValueError(f"K1 takes tiles of {TILE_PIX} pixels, got {tile_h}x{tile_w}")
    block_w = WARP_PIX // tile_h if tile_h < 16 else min(8, tile_w)
    return block_w, WARP_PIX // block_w


def _pixel_blocks(tile_h, tile_w, device) -> torch.Tensor:
    """(1024,) K1's warp block (numbered row-major in the tile) of each flat
    pixel."""
    block_w, block_h = k1_block(tile_h, tile_w)
    flat = torch.arange(TILE_PIX, device=device)
    row = torch.div(flat, tile_w, rounding_mode="floor")
    return (torch.div(row, block_h, rounding_mode="floor") * (tile_w // block_w)
            + torch.div(flat % tile_w, block_w, rounding_mode="floor"))


def warp_block_pixels(tile_h: int, tile_w: int) -> torch.Tensor:
    """(8, 32, 4) flat pixel (row-major in the tile) of pixel k of lane l in
    K1's warp block b, as csrc/blend_common.cuh (block_pixel) lays them out:
    lanes along a block row (up to 32 of them), a thread's pixels 32 /
    block_w rows apart in blocks up to 32 wide, 32 columns apart in wider
    ones."""
    block_w, block_h = k1_block(tile_h, tile_w)
    per_row = tile_w // block_w
    blocks = torch.arange(TILE_PIX // WARP_PIX)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    k = torch.arange(WARP_PIX // 32)[None, None, :]
    lanes_w = min(block_w, 32)
    per_lane = block_w // lanes_w
    row = (torch.div(blocks, per_row, rounding_mode="floor") * block_h
           + torch.div(lane, lanes_w, rounding_mode="floor")
           + torch.div(k, per_lane, rounding_mode="floor") * (32 // lanes_w))
    col = (blocks % per_row) * block_w + lane % lanes_w + (k % per_lane) * 32
    return row * tile_w + col


def warp_cull_keep(
    splats, tile_starts, tile_lens, *, n_tx, n_ty, tile_h=32, tile_w=32, linear=False,
) -> torch.Tensor:
    """Plain emulation of K1's and K2's cull: (T, L, 1024 / WARP_PIX) bool,
    L the longest range, True where the warp owning that block of the tile
    walks the tile's l-th entry (its cull box meets the block); False where
    the kernels skip the pair, and past the tile's range. `linear`: K3
    noexp's boxes."""
    block_w, block_h = k1_block(tile_h, tile_w)
    dev = splats.device
    n_tiles = n_tx * n_ty
    L = max(int(tile_lens.max()) if n_tiles else 0, 1)
    ar = torch.arange(L, device=dev)
    valid = ar[None, :] < tile_lens.long()[:, None]
    idx = torch.where(valid, tile_starts.long()[:, None] + ar[None, :], 0)
    box = cull_boxes(splats, linear)[idx]                            # (T, L, 4)
    tiles = torch.arange(n_tiles, device=dev)
    blocks = torch.arange(TILE_PIX // WARP_PIX, device=dev)
    per_row = tile_w // block_w
    x0 = ((tiles % n_tx) * tile_w)[:, None] + (blocks % per_row)[None, :] * block_w
    y0 = (torch.div(tiles, n_tx, rounding_mode="floor") * tile_h)[:, None] \
        + torch.div(blocks, per_row, rounding_mode="floor")[None, :] * block_h
    x0, y0 = x0.float()[:, None, :], y0.float()[:, None, :]          # (T, 1, blocks)
    x1, y1 = x0 + (block_w - 1), y0 + (block_h - 1)
    meets = ((box[..., 1:2] >= x0) & (box[..., 0:1] <= x1)
             & (box[..., 3:4] >= y0) & (box[..., 2:3] <= y1))
    return meets & valid[..., None]


def blend_backward_plain(
    splats, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib, *,
    n_tx, n_ty, tile_h=32, tile_w=32, pixels=None, keep=None,
):
    """Plain version of K2 (same signature and outputs): T before each entry
    is final_T times the reverse cumulative product of 1/(1-alpha) over the
    applied entries; Sdl is the reverse exclusive cumulative sum of
    w * (rgb . dL/dpix). `pixels`, the probes' hook (ops/blend_probe.py),
    restricts the sums to those flat pixel indices of each tile. `keep`, the
    cull's (`warp_cull_keep`'s (T, L, 8) mask), applies an entry only in the
    warp blocks it keeps, as K2 walks it."""
    dev = splats.device
    blocks = _pixel_blocks(tile_h, tile_w, dev) if keep is not None else None
    grads = torch.zeros((splats.shape[0], N_ATTR), dtype=torch.float32, device=dev)
    dl_t = _to_tiles(dl_dcolor, n_tx, n_ty, tile_h, tile_w)      # (T, 3, 1024)
    ft_t = _to_tiles(final_t, n_tx, n_ty, tile_h, tile_w)        # (T, 1024)
    nc_t = _to_tiles(n_contrib, n_tx, n_ty, tile_h, tile_w)      # (T, 1024)
    for tiles, L in _tile_chunks(tile_lens):
        e, idx, valid = _gather_entries(splats, tile_starts, tile_lens, tiles, L)
        px, py = _pixel_coords(tiles, n_tx, tile_h, tile_w)
        dl, ft, nc = dl_t[tiles], ft_t[tiles], nc_t[tiles]
        bl = blocks
        if pixels is not None:
            px, py, dl, ft, nc = px[:, pixels], py[:, pixels], dl[..., pixels], \
                ft[:, pixels], nc[:, pixels]
            bl = None if blocks is None else blocks[pixels]
        dx, dy, _, G, alpha, contrib = _alpha(e, px, py)
        pos = torch.arange(1, L + 1, device=dev)[None, :, None]
        applied = contrib & (pos <= nc[:, None, :])
        if keep is not None:
            applied = applied & keep[tiles, :L][:, :, bl]
        inv_om = 1.0 / (1.0 - alpha)
        f = torch.where(applied, inv_om, torch.ones_like(inv_om))
        T = ft[:, None, :] * torch.cumprod(f.flip(1), 1).flip(1)
        A, B, C, opa = (e[..., i:i + 1] for i in (ROW_A, ROW_B, ROW_C, ROW_OPA))
        dlr, dlg, dlb = dl[:, 0:1], dl[:, 1:2], dl[:, 2:3]
        s1 = e[..., ROW_R:ROW_R + 1] * dlr + e[..., ROW_G:ROW_G + 1] * dlg \
            + e[..., ROW_B2:ROW_B2 + 1] * dlb
        wsel = torch.where(applied, alpha * T, torch.zeros_like(T))
        ws1 = torch.cumsum((wsel * s1).flip(1), 1).flip(1)
        Sdl = torch.cat([ws1[:, 1:], torch.zeros_like(ws1[:, :1])], 1)
        dalpha = torch.where(applied, T * s1 - Sdl * inv_om, torch.zeros_like(T))
        E = G * dalpha
        gd = opa * E
        t1 = gd * dx
        t2 = gd * dy
        m1 = t1.sum(-1)
        m2 = t2.sum(-1)
        q = torch.stack([
            -(A[..., 0] * m1 + B[..., 0] * m2),
            -(C[..., 0] * m2 + B[..., 0] * m1),
            -0.5 * (t1 * dx).sum(-1),
            -(t1 * dy).sum(-1),
            -0.5 * (t2 * dy).sum(-1),
            E.sum(-1),
            (wsel * dlr).sum(-1),
            (wsel * dlg).sum(-1),
            (wsel * dlb).sum(-1),
        ], -1)                                                     # (G, L, 9)
        grads[idx[valid]] = q[valid]
    return grads
