"""Substitution probes of the blend kernels: K3 (forward) and K4 (backward).

The counterparts of the JAX package's Pallas probes, `make_fwd(...).run` in
tools/probe_kernel.py and `make_bwd(...).run` in tools/probe_bwd.py. Each
variant is K1 (`blend.blend_forward`) or K2 in its first design (per-entry
grads, the per-Gaussian sum left to an index_add_; `blend.blend_backward` was
redesigned since) with one cost centre swapped out; the time it removes from `base` is what that centre
costs. Some variants compute something else on purpose, and every variant
has a plain PyTorch version of exactly what it computes.

Forward variants (csrc/blend_probe_forward.cu), outputs as K1's:
  base      K1's walk, bit for bit
  noexp     G = 0.1 power + 0.9 in place of exp(power)
  noattr    no attribute staging or loads: every in-range entry is NOATTR_SPLAT
  noblend   color += (power, power/2, power/4) over every in-range entry, with
            no tests, no termination and no early exit (final_T 1, n_contrib 0)
  batch512  512 entries staged per round, 2 per thread, in place of 256
  direct    every thread reads the attributes from device memory; no staging

Backward variants (csrc/blend_probe_backward.cu), per-entry grads as the first K2:
  base        the first K2, bit for bit
  dbuf2       the next batch is copied with cp.async into a second shared
              buffer while the current one is walked
  nored       no reduction: each entry's record comes from thread 0's four
              pixels alone, the flat pixels NORED_PIXELS of the tile
  smematomic  warp shuffles, then shared-memory atomicAdd into one buffer
  fused       records atomicAdded into per-Gaussian grads (P+1, 9) at
              `sorted_gauss`; no per-entry write and no index_add_

Dispatch as in ops/blend.py: a CPU tensor takes the plain version
(`probe_forward_plain`, `probe_backward_plain`); a CUDA tensor launches the
kernel or raises. Each launch adds one to `LAUNCHES[f"{direction}_{variant}"]`.
Both directions can write the entries each tile's walk visited into a (T,)
int32 `walked`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gaussian_lic_tpu_torch.ops import blend

# The order is the kernels' variant numbering.
FORWARD_VARIANTS = ("base", "noexp", "noattr", "noblend", "batch512", "direct")
BACKWARD_VARIANTS = ("base", "dbuf2", "nored", "smematomic", "fused")

# noattr's splat: x, y, A, B, C, opacity, r, g, b (tools/probe_kernel.py:153-154)
NOATTR_SPLAT = (1.0, 2.0, 0.01, 0.001, 0.01, 0.5, 0.2, 0.3, 0.4)
# nored's pixels: thread 0's four, flat = threadIdx.x + k * 256
NORED_PIXELS = (0, 256, 512, 768)

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
    from gaussian_lic_tpu_torch import _build

    lib = _build.load()
    dev = splats.device
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    color = torch.empty((3, Hp, Wp), dtype=torch.float32, device=dev)
    final_t = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
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
    *,
    sorted_gauss: Optional[torch.Tensor] = None,  # (M_pad,) int32, for fused
    n_gauss: Optional[int] = None,                # P, for fused
    n_tx: int,
    n_ty: int,
    tile_h: int = 32,
    tile_w: int = 32,
    walked: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4. Returns per-entry grads (M_pad, 9) for (x, y, A, B, C, opa, r, g,
    b), or for `fused` per-Gaussian grads (P+1, 9): entry e added to row
    sorted_gauss[e], the dead id P to row P. sorted_gauss must lie in [0, P]."""
    index = _variant_index(variant, BACKWARD_VARIANTS)
    blend._check_common(splats, tile_starts, tile_lens, n_tx, n_ty, tile_h, tile_w)
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    dev = splats.device
    blend._check("dl_dcolor", dl_dcolor, (3, Hp, Wp), torch.float32, dev)
    blend._check("final_t", final_t, (Hp, Wp), torch.float32, dev)
    blend._check("n_contrib", n_contrib, (Hp, Wp), torch.int32, dev)
    _check_walked(walked, n_tx * n_ty, dev)
    if variant == "fused":
        if sorted_gauss is None or n_gauss is None or n_gauss < 0:
            raise ValueError("the fused variant needs sorted_gauss and n_gauss >= 0")
        blend._check("sorted_gauss", sorted_gauss, (splats.shape[0],), torch.int32, dev)
    kw = dict(n_tx=n_tx, n_ty=n_ty, tile_h=tile_h, tile_w=tile_w)
    if blend._device_kind(splats) == "cpu":
        return probe_backward_plain(variant, splats, tile_starts, tile_lens, dl_dcolor,
                                    final_t, n_contrib, sorted_gauss=sorted_gauss,
                                    n_gauss=n_gauss, walked=walked, **kw)
    if variant == "dbuf2" and splats.data_ptr() % 16:
        raise ValueError("dbuf2 copies 16-byte pieces of each row: splats must be "
                         "16-byte aligned")
    from gaussian_lic_tpu_torch import _build

    lib = _build.load()
    rows = n_gauss + 1 if variant == "fused" else splats.shape[0]
    grads = torch.zeros((rows, blend.N_ATTR), dtype=torch.float32, device=dev)
    blend._launch(lib.cdll.glic_blend_probe_backward, index, blend._ptr(splats),
                  ctypes.c_longlong(splats.shape[0]), blend._ptr(tile_starts),
                  blend._ptr(tile_lens), blend._ptr(dl_dcolor), blend._ptr(final_t),
                  blend._ptr(n_contrib), blend._ptr(grads),
                  _opt_ptr(sorted_gauss if variant == "fused" else None), _opt_ptr(walked),
                  n_tx, n_ty, tile_w, tile_h, blend._stream(dev))
    LAUNCHES[f"backward_{variant}"] += 1
    return grads


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _noexp(power: torch.Tensor) -> torch.Tensor:
    return power * 0.1 + 0.9


def probe_forward_plain(
    variant, splats, tile_starts, tile_lens, *, n_tx, n_ty, tile_h=32, tile_w=32,
    t_eps=blend.T_EPS, walked=None,
):
    """Plain version of K3 (same outputs); `t_eps` as in
    `blend.blend_forward_plain`, for the tie check."""
    _variant_index(variant, FORWARD_VARIANTS)
    grid = dict(n_tx=n_tx, n_ty=n_ty, tile_h=tile_h, tile_w=tile_w)
    if variant == "noblend":
        return _noblend_plain(splats, tile_starts, tile_lens, walked=walked, **grid)
    kw = dict(grid, t_eps=t_eps, walked=walked)
    if variant == "noattr":
        const = splats.new_zeros(splats.shape)
        const[:, :blend.N_ATTR] = splats.new_tensor(NOATTR_SPLAT)
        return blend.blend_forward_plain(const, tile_starts, tile_lens, **kw)
    if variant == "noexp":
        return blend.blend_forward_plain(splats, tile_starts, tile_lens, exp=_noexp, **kw)
    batch = 512 if variant == "batch512" else 256
    return blend.blend_forward_plain(splats, tile_starts, tile_lens, walk_batch=batch, **kw)


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


def probe_backward_plain(
    variant, splats, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib, *,
    sorted_gauss=None, n_gauss=None, n_tx, n_ty, tile_h=32, tile_w=32, walked=None,
):
    """Plain version of K4 (same outputs)."""
    _variant_index(variant, BACKWARD_VARIANTS)
    kw = dict(n_tx=n_tx, n_ty=n_ty, tile_h=tile_h, tile_w=tile_w)
    pixels = None
    if variant == "nored":
        pixels = torch.tensor(NORED_PIXELS, device=splats.device)
    grads = blend.blend_backward_plain(splats, tile_starts, tile_lens, dl_dcolor, final_t,
                                       n_contrib, pixels=pixels, **kw)
    if walked is not None:
        nmax = blend._to_tiles(n_contrib, n_tx, n_ty, tile_h, tile_w).amax(1)
        walked.copy_(torch.minimum(nmax, tile_lens))
    if variant != "fused":
        return grads
    out = grads.new_zeros((n_gauss + 1, blend.N_ATTR))
    return out.index_add_(0, sorted_gauss.long(), grads)
