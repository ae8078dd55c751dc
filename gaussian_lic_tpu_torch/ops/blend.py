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
backward rebuilds T by division from final_T, back to front, and writes
per-entry gradients (M_pad, 9) for (x, y, A, B, C, opa, r, g, b). It uses the
exact conic convention (-dx^2/2, -dx dy, -dy^2/2) and does not mask the alpha
cap (reference parity, backward.cu:553).

Dispatch: a CPU tensor goes to the plain PyTorch version (`*_plain`); a CUDA
tensor launches the hand-written CUDA kernel (csrc/blend_forward.cu,
csrc/blend_backward.cu) or raises. Each launch adds one to `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaussian_lic_tpu_torch.ops.projection import OPACITY_THRESHOLD

ALPHA_CAP = 0.99          # forward.cu:436
T_EPS = 1e-4              # forward.cu:439
SPLAT_ROWS = 16           # floats per gathered splat row
N_ATTR = 9                # of which used: x, y, A, B, C, opa, r, g, b
ROW_X, ROW_Y, ROW_A, ROW_B, ROW_C, ROW_OPA, ROW_R, ROW_G, ROW_B2 = range(N_ATTR)
TILE_PIX = 1024           # pixels per tile; the kernels spread them over 256 threads

# Launch counts of the CUDA kernels (plain-version calls are not counted).
LAUNCHES = {"forward": 0, "forward_no_color": 0, "backward": 0}

# Bound on the (tiles x entries x pixels) elements one plain-version chunk holds.
_PLAIN_CHUNK_ELEMS = 1 << 25


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# argument checks shared by both dispatch targets
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, splats on {device}")
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


def blend_backward(
    splats: torch.Tensor,       # (M_pad, 16) float32
    tile_starts: torch.Tensor,  # (T,) int32
    tile_lens: torch.Tensor,    # (T,) int32
    dl_dcolor: torch.Tensor,    # (3, Hp, Wp) float32
    final_t: torch.Tensor,      # (Hp, Wp) float32
    n_contrib: torch.Tensor,    # (Hp, Wp) int32
    *,
    n_tx: int,
    n_ty: int,
    tile_h: int = 32,
    tile_w: int = 32,
) -> torch.Tensor:
    """K2. Returns per-entry gradients (M_pad, 9) float32 for
    (x, y, A, B, C, opa, r, g, b); entries no pixel applied get zeros."""
    _check_common(splats, tile_starts, tile_lens, n_tx, n_ty, tile_h, tile_w)
    Hp, Wp = n_ty * tile_h, n_tx * tile_w
    dev = splats.device
    _check("dl_dcolor", dl_dcolor, (3, Hp, Wp), torch.float32, dev)
    _check("final_t", final_t, (Hp, Wp), torch.float32, dev)
    _check("n_contrib", n_contrib, (Hp, Wp), torch.int32, dev)
    if _device_kind(splats) == "cpu":
        return blend_backward_plain(splats, tile_starts, tile_lens, dl_dcolor,
                                    final_t, n_contrib, n_tx=n_tx, n_ty=n_ty,
                                    tile_h=tile_h, tile_w=tile_w)
    from gaussian_lic_tpu_torch import _build

    lib = _build.load()
    grads = torch.zeros((splats.shape[0], N_ATTR), dtype=torch.float32, device=dev)
    _launch(lib.cdll.glic_blend_backward, _ptr(splats), ctypes.c_longlong(splats.shape[0]),
            _ptr(tile_starts), _ptr(tile_lens), _ptr(dl_dcolor), _ptr(final_t),
            _ptr(n_contrib), _ptr(grads), n_tx, n_ty, tile_w, tile_h, _stream(dev))
    LAUNCHES["backward"] += 1
    return grads


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


def _alpha(e, px, py):
    """Per (tile, entry, pixel): dx, dy, power, exp(power), alpha, contributes;
    the same operations, in the same order, as the kernels."""
    x, y, A, B, C, opa = (e[..., i:i + 1] for i in range(6))
    dx = x - px[:, None, :]
    dy = y - py[:, None, :]
    nA = -0.5 * A
    nC = -0.5 * C
    power = (nA * dx - B * dy) * dx + (nC * dy) * dy
    G = torch.exp(power)
    alpha = torch.clamp_max(opa * G, ALPHA_CAP)
    contrib = (alpha >= OPACITY_THRESHOLD) & (power <= 0.0)
    return dx, dy, power, G, alpha, contrib


def _to_image(per_tile: torch.Tensor, n_tx, n_ty, tile_h, tile_w) -> torch.Tensor:
    """(T, ..., 1024) tile-major -> (..., Hp, Wp)."""
    lead = per_tile.shape[1:-1]
    x = per_tile.reshape((n_ty, n_tx) + lead + (tile_h, tile_w))
    nl = len(lead)
    perm = tuple(range(2, 2 + nl)) + (0, 2 + nl, 1, 3 + nl)
    return x.permute(perm).reshape(lead + (n_ty * tile_h, n_tx * tile_w))


def _to_tiles(img: torch.Tensor, n_tx, n_ty, tile_h, tile_w) -> torch.Tensor:
    """(..., Hp, Wp) -> (T, ..., 1024) tile-major."""
    lead = img.shape[:-2]
    nl = len(lead)
    x = img.reshape(lead + (n_ty, tile_h, n_tx, tile_w))
    perm = (nl, nl + 2) + tuple(range(nl)) + (nl + 1, nl + 3)
    return x.permute(perm).reshape((n_ty * n_tx,) + lead + (TILE_PIX,))


def blend_forward_plain(
    splats, tile_starts, tile_lens, *, n_tx, n_ty, tile_h=32, tile_w=32,
    no_color=False, t_eps=T_EPS,
):
    """Plain version of K1 (same signature and outputs). Front-to-back
    termination is emulated with cumulative products and a 'dead after the
    first trigger' mask; the cumulative product runs along a non-innermost
    dimension, which PyTorch scans sequentially, so T matches the kernel's
    running product. `t_eps` exists for the tie check of the kernel test."""
    dev = splats.device
    n_tiles = n_tx * n_ty
    color_t = torch.zeros((n_tiles, 3, TILE_PIX), dtype=torch.float32, device=dev)
    final_t_t = torch.ones((n_tiles, TILE_PIX), dtype=torch.float32, device=dev)
    ncontrib_t = torch.zeros((n_tiles, TILE_PIX), dtype=torch.int32, device=dev)
    for tiles, L in _tile_chunks(tile_lens):
        e, _, _ = _gather_entries(splats, tile_starts, tile_lens, tiles, L)
        px, py = _pixel_coords(tiles, n_tx, tile_h, tile_w)
        _, _, _, _, alpha, contrib = _alpha(e, px, py)
        a = torch.where(contrib, alpha, torch.zeros_like(alpha))
        t_f = 1.0 - a
        T_excl = torch.cumprod(torch.cat([torch.ones_like(t_f[:, :1]), t_f[:, :-1]], 1), 1)
        trigger = contrib & (T_excl * t_f < t_eps)
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


def blend_backward_plain(
    splats, tile_starts, tile_lens, dl_dcolor, final_t, n_contrib, *,
    n_tx, n_ty, tile_h=32, tile_w=32,
):
    """Plain version of K2 (same signature and outputs): T before each entry
    is final_T times the reverse cumulative product of 1/(1-alpha) over the
    applied entries; Sdl is the reverse exclusive cumulative sum of
    w * (rgb . dL/dpix)."""
    dev = splats.device
    grads = torch.zeros((splats.shape[0], N_ATTR), dtype=torch.float32, device=dev)
    dl_t = _to_tiles(dl_dcolor, n_tx, n_ty, tile_h, tile_w)      # (T, 3, 1024)
    ft_t = _to_tiles(final_t, n_tx, n_ty, tile_h, tile_w)        # (T, 1024)
    nc_t = _to_tiles(n_contrib, n_tx, n_ty, tile_h, tile_w)      # (T, 1024)
    for tiles, L in _tile_chunks(tile_lens):
        e, idx, valid = _gather_entries(splats, tile_starts, tile_lens, tiles, L)
        px, py = _pixel_coords(tiles, n_tx, tile_h, tile_w)
        dx, dy, _, G, alpha, contrib = _alpha(e, px, py)
        pos = torch.arange(1, L + 1, device=dev)[None, :, None]
        applied = contrib & (pos <= nc_t[tiles][:, None, :])
        inv_om = 1.0 / (1.0 - alpha)
        f = torch.where(applied, inv_om, torch.ones_like(inv_om))
        T = ft_t[tiles][:, None, :] * torch.cumprod(f.flip(1), 1).flip(1)
        A, B, C, opa = (e[..., i:i + 1] for i in (ROW_A, ROW_B, ROW_C, ROW_OPA))
        dl = dl_t[tiles]
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
