"""Substitution probes of the blend kernels: K3 (forward) and K4 (backward).

The counterparts of the JAX package's Pallas probes, `make_fwd(...).run` in
tools/probe_kernel.py and `make_bwd(...).run` in tools/probe_bwd.py. As
there, a probe is the production kernel with one cost centre swapped out,
and the time it removes from `base` is what that centre costs: each variant
is an instantiation of K1's or K2's own kernel template
(csrc/blend_forward.cuh, csrc/blend_backward.cuh), and `base` is the
instantiation the main path launches. Some variants compute something else
on purpose, and every variant has a plain PyTorch version of exactly what it
computes.

Forward variants (K1's design: 128-pixel warp blocks, 2 bands a tile,
batches of 128 rows by bulk copy into a double buffer, the per-warp
footprint cull), outputs as K1's:
  base      K1, bit for bit
  nocull    no box test and no ballot: every warp walks every entry of its
            band (K1's outputs, bit for bit)
  noexp     G = 0.1 power + 0.9 in place of exp(power)
  noattr    no staging and no attribute loads: every in-range entry is
            NOATTR_SPLAT
  noblend   no tests and no blend: color += (power, power/2, power/4) over
            every in-range entry, with no termination and no early exit
            (final_T 1, n_contrib 0)
  batch256  256 rows a batch in place of 128 (K1's outputs)
  direct    no bulk-copy staging: the lanes read the rows from device memory
            (K1's outputs)
K1's cull box holds the pixels where opa exp(power) can reach 1/255, and the
substitutions apply entries outside it, so each has the cull its own
function allows: noexp a box from its linear test's own threshold
(`blend.cull_boxes(linear=True)`), noattr the box of NOATTR_SPLAT, noblend
none (every warp walks every entry).

Backward variants (K2's design: 4 bands of two of K1's warp blocks, 64
threads a band, the bulk-copy double buffer, each warp's footprint cull
(the boxes of a batch, 32 to a ballot), the 12-shuffle reduce-scatter,
per-Gaussian vector atomics, the tiles launched longest first), each taking
one cost centre out of that culled walk; per-Gaussian grads (P, 9) as K2's
unless named:
  base        K2
  sbuf        one buffer, refilled synchronously after each batch
  nored       no reduce-scatter and no warp-partials pass: each band's record
              of an entry comes from its first thread's four pixels alone
              (`nored_pixels`: lane 0 of the band's first warp block), so the
              result sums the tile's 16 such pixels (every pixel's math and
              T/Sdl updates still run)
  smematomic  the reduce-scatter replaced by shared-memory atomics: every
              lane adds its sums into one buffer of the band
  noatomic    no per-Gaussian atomics: each band stores its partial record of
              every walked entry into a (BWD_BANDS, M_pad, 9) buffer with
              plain stores; its plain version is the per-entry grads of each
              band's pixels (`band_pixels`)
  nocull      no box pass, no box test and no ballot: K2's walk before the
              cull, whose band is 256 consecutive pixels of the tile (thread
              t's at band * 256 + t + 64 k, a warp spanning 7 rows of 32
              interleaved with the other warp's) and whose warps walk every
              entry. Sums in another order than K2's
Every backward variant launches the tiles in `tile_order` (default: K2's
`blend.longest_first`, computed on every call as K2 computes it).

Dispatch as in ops/blend.py: a CPU tensor takes the plain version
(`probe_forward_plain`, `probe_backward_plain`); a CUDA tensor launches the
kernel or raises. Each launch adds one to `LAUNCHES[f"{direction}_{variant}"]`.
Both directions can write the entries each tile's walk visited into a (T,)
int32 `walked`: the larger count of the tile's bands.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gaussian_lic_tpu_torch.ops import blend

# The order is the kernels' variant numbering (ForwardVariant, BackwardVariant).
FORWARD_VARIANTS = ("base", "nocull", "noexp", "noattr", "noblend", "batch256", "direct")
BACKWARD_VARIANTS = ("base", "sbuf", "nored", "smematomic", "noatomic", "nocull")
FWD_BATCH = {"batch256": 256}   # rows a batch where not K1's 128
BWD_BANDS = 4                   # K2's pixel bands a tile: two warp blocks, 256 pixels each
BWD_BAND_THREADS = 64

# noattr's splat: x, y, A, B, C, opacity, r, g, b (tools/probe_kernel.py:153-154)
NOATTR_SPLAT = (1.0, 2.0, 0.01, 0.001, 0.01, 0.5, 0.2, 0.3, 0.4)


def nored_pixels(tile_h: int = 32, tile_w: int = 32) -> Tuple[int, ...]:
    """nored's pixels: the four flat pixels of each band's first thread, lane
    0 of warp block 2 * band (`blend.warp_block_pixels`)."""
    wp = blend.warp_block_pixels(tile_h, tile_w)
    return tuple(int(p) for b in range(BWD_BANDS) for p in wp[2 * b, 0])


NORED_PIXELS = nored_pixels()   # at 32x32 tiles

LAUNCHES = {f"{d}_{v}": 0 for d, vs in (("forward", FORWARD_VARIANTS),
                                        ("backward", BACKWARD_VARIANTS)) for v in vs}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _variant_index(variant: str, variants: Tuple[str, ...]) -> int:
    if variant not in variants:
        raise ValueError(f"unknown probe variant {variant!r}; one of {variants}")
    return variants.index(variant)


def _check_walked(walked, n_tiles, device):
    if walked is not None:
        blend._check("walked", walked, (n_tiles,), torch.int32, device)


def _opt_ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def probe_forward(
    variant: str,
    splats: torch.Tensor,       # (M_pad, 16) float32 gathered splat rows
    tile_starts: torch.Tensor,  # (T,) int32
    tile_lens: torch.Tensor,    # (T,) int32
    *,
    n_tx: int,
    n_ty: int,
    tile_h: int = 32,
    tile_w: int = 32,
    walked: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3. Returns K1's (color (3, Hp, Wp), final_T (Hp, Wp), n_contrib
    (Hp, Wp) int32) as the variant computes them."""
    index = _variant_index(variant, FORWARD_VARIANTS)
    blend._check_common(splats, tile_starts, tile_lens, n_tx, n_ty, tile_h, tile_w)
    _check_walked(walked, n_tx * n_ty, splats.device)
    kw = dict(n_tx=n_tx, n_ty=n_ty, tile_h=tile_h, tile_w=tile_w)
    if blend._device_kind(splats) == "cpu":
        return probe_forward_plain(variant, splats, tile_starts, tile_lens, walked=walked, **kw)
    blend._check_aligned(splats, "K3")
    from gaussian_lic_tpu_torch import _build

    lib = _build.load()
    dev = splats.device
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    color = torch.empty((3, Hp, Wp), dtype=torch.float32, device=dev)
    final_t = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    if walked is not None:
        walked.zero_()   # the bands take the larger count with atomicMax
    konst = (ctypes.c_float * len(NOATTR_SPLAT))(*NOATTR_SPLAT)
    blend._launch(lib.cdll.glic_blend_probe_forward, index, blend._ptr(splats),
                  ctypes.c_longlong(splats.shape[0]), blend._ptr(tile_starts),
                  blend._ptr(tile_lens), blend._ptr(color), blend._ptr(final_t),
                  blend._ptr(n_contrib), _opt_ptr(walked), n_tx, n_ty, tile_w, tile_h,
                  ctypes.cast(konst, ctypes.c_void_p), blend._stream(dev))
    LAUNCHES[f"forward_{variant}"] += 1
    return color, final_t, n_contrib


def probe_backward(
    variant: str,
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
    walked: Optional[torch.Tensor] = None,
    tile_order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4. Returns K2's per-Gaussian grads (P, 9) for (x, y, A, B, C, opa,
    r, g, b) as the variant computes them; `noatomic`: (BWD_BANDS, M_pad, 9),
    each band's per-entry grads. `tile_order` (T,) int32: the launch order
    of the tiles (the card only; default K2's, longest first)."""
    index = _variant_index(variant, BACKWARD_VARIANTS)
    blend._check_common(splats, tile_starts, tile_lens, n_tx, n_ty, tile_h, tile_w)
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    dev = splats.device
    blend._check("dl_dcolor", dl_dcolor, (3, Hp, Wp), torch.float32, dev)
    blend._check("final_t", final_t, (Hp, Wp), torch.float32, dev)
    blend._check("n_contrib", n_contrib, (Hp, Wp), torch.int32, dev)
    blend._check("sorted_gauss", sorted_gauss, (splats.shape[0],), torch.int32, dev)
    if n_gauss < 0:
        raise ValueError(f"need n_gauss >= 0, got {n_gauss}")
    _check_walked(walked, n_tx * n_ty, dev)
    if tile_order is not None:
        blend._check("tile_order", tile_order, (n_tx * n_ty,), torch.int32, dev)
    kw = dict(n_tx=n_tx, n_ty=n_ty, tile_h=tile_h, tile_w=tile_w)
    if blend._device_kind(splats) == "cpu":
        return probe_backward_plain(variant, splats, tile_starts, tile_lens, dl_dcolor,
                                    final_t, n_contrib, sorted_gauss, n_gauss=n_gauss,
                                    walked=walked, **kw)
    blend._check_aligned(splats, "K4")
    from gaussian_lic_tpu_torch import _build

    lib = _build.load()
    order = blend.longest_first(tile_lens) if tile_order is None else tile_order
    if variant == "noatomic":
        out = torch.zeros((BWD_BANDS, splats.shape[0], blend.N_ATTR), dtype=torch.float32,
                          device=dev)
    else:
        out = torch.zeros((n_gauss + 1, blend.GAUSS_TABLE_STRIDE), dtype=torch.float32,
                          device=dev)
    if walked is not None:
        walked.zero_()   # the bands take the larger count with atomicMax
    blend._launch(lib.cdll.glic_blend_probe_backward, index, blend._ptr(splats),
                  ctypes.c_longlong(splats.shape[0]), blend._ptr(tile_starts),
                  blend._ptr(tile_lens), blend._ptr(order), blend._ptr(dl_dcolor),
                  blend._ptr(final_t), blend._ptr(n_contrib), blend._ptr(sorted_gauss),
                  blend._ptr(out), _opt_ptr(walked), n_tx, n_ty, tile_w, tile_h,
                  blend._stream(dev))
    LAUNCHES[f"backward_{variant}"] += 1
    return out if variant == "noatomic" else out[:n_gauss, :blend.N_ATTR]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _noexp(power: torch.Tensor) -> torch.Tensor:
    return power * 0.1 + 0.9


def noattr_list(splats: torch.Tensor) -> torch.Tensor:
    """`splats` with every row's attributes replaced by NOATTR_SPLAT: what
    the noattr variant walks."""
    const = splats.new_zeros(splats.shape)
    const[:, :blend.N_ATTR] = splats.new_tensor(NOATTR_SPLAT)
    return const


def probe_forward_plain(
    variant, splats, tile_starts, tile_lens, *, n_tx, n_ty, tile_h=32, tile_w=32,
    t_eps=blend.T_EPS, walked=None,
):
    """Plain version of K3 (same outputs); `t_eps` as in
    `blend.blend_forward_plain`, for the tie check. The culls change no
    output: the plain versions test every pair."""
    _variant_index(variant, FORWARD_VARIANTS)
    grid = dict(n_tx=n_tx, n_ty=n_ty, tile_h=tile_h, tile_w=tile_w)
    if variant == "noblend":
        return _noblend_plain(splats, tile_starts, tile_lens, walked=walked, **grid)
    kw = dict(grid, t_eps=t_eps, walked=walked, walk_batch=FWD_BATCH.get(variant, 128))
    if variant == "noattr":
        return blend.blend_forward_plain(noattr_list(splats), tile_starts, tile_lens, **kw)
    if variant == "noexp":
        return blend.blend_forward_plain(splats, tile_starts, tile_lens, exp=_noexp, **kw)
    return blend.blend_forward_plain(splats, tile_starts, tile_lens, **kw)


def _noblend_plain(splats, tile_starts, tile_lens, *, n_tx, n_ty, tile_h, tile_w, walked):
    """color = (S, S/2, S/4), S the sum of power over the tile's entries."""
    n_tiles = n_tx * n_ty
    dev = splats.device
    color_t = torch.zeros((n_tiles, 3, blend.TILE_PIX), dtype=torch.float32, device=dev)
    for tiles, L in blend._tile_chunks(tile_lens):
        e, _, valid = blend._gather_entries(splats, tile_starts, tile_lens, tiles, L)
        px, py = blend._pixel_coords(tiles, n_tx, tile_h, tile_w)
        _, _, power, _, _, _ = blend._alpha(e, px, py)
        S = torch.where(valid[..., None], power, torch.zeros_like(power)).sum(1)
        color_t[tiles] = torch.stack([S, S * 0.5, S * 0.25], 1)
    if walked is not None:
        walked.copy_(tile_lens)
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    return (blend._to_image(color_t, n_tx, n_ty, tile_h, tile_w),
            torch.ones((Hp, Wp), dtype=torch.float32, device=dev),
            torch.zeros((Hp, Wp), dtype=torch.int32, device=dev))


def band_pixels(band: int, tile_h: int = 32, tile_w: int = 32, device=None) -> torch.Tensor:
    """The flat pixels of K2's band `band` of a tile, in increasing order:
    those of K1's warp blocks 2 * band and 2 * band + 1."""
    blocks = blend._pixel_blocks(tile_h, tile_w, device)
    return torch.nonzero(torch.div(blocks, 2, rounding_mode="floor") == band).flatten()


def probe_backward_plain(
    variant, splats, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib, sorted_gauss, *,
    n_gauss, n_tx, n_ty, tile_h=32, tile_w=32, walked=None,
):
    """Plain version of K4 (same outputs). The culls change no output: the
    plain versions test every pair. `walked`: each band walks from the
    largest n_contrib of its own pixels, so the tile's larger count is
    min(the tile's max n_contrib, len) for every variant."""
    _variant_index(variant, BACKWARD_VARIANTS)
    kw = dict(n_tx=n_tx, n_ty=n_ty, tile_h=tile_h, tile_w=tile_w)
    args = (splats, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib)
    if walked is not None:
        nmax = blend._to_tiles(n_contrib, **kw).amax(1)
        walked.copy_(torch.clamp_min(torch.minimum(nmax, tile_lens), 0))
    if variant == "noatomic":
        return torch.stack([blend.blend_backward_plain(
            *args, pixels=band_pixels(b, tile_h, tile_w, splats.device), **kw)
            for b in range(BWD_BANDS)])
    pixels = (torch.tensor(nored_pixels(tile_h, tile_w), device=splats.device)
              if variant == "nored" else None)
    grads = blend.blend_backward_plain(*args, pixels=pixels, **kw)
    return blend.sum_per_gaussian(grads, sorted_gauss, n_gauss)
