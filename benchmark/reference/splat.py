"""The plain reference of one Gaussian-LIC render and train step, in plain PyTorch.

It imports nothing of the program. Its chains are frozen copies of the plain
PyTorch versions that the port keeps beside its kernels, so that a later
change to the program never moves its yardstick:

  camera        gaussian_lic_tpu_torch/camera.py (make_camera, projection_matrix)
  activations   gaussian_lic_tpu_torch/ops/preprocess.py (activate)
  projection    gaussian_lic_tpu_torch/ops/projection.py (projection_terms)
  SH colour     gaussian_lic_tpu_torch/ops/sh.py (eval_sh_color)
  binning       gaussian_lic_tpu_torch/ops/tiles.py (_slot_keys_chain, bin_gaussians,
                bin_ranges_plain) and ops/rasterize.py (_splat_budget_for)
  blend         gaussian_lic_tpu_torch/ops/blend.py (blend_forward_plain,
                blend_backward_plain)
  sparse Adam   gaussian_lic_tpu_torch/ops/adam.py (sparse_adam_update)

The loss is written afresh as the original 3DGS writes it: L1 and an SSIM
whose 11x11 Gaussian window is one depthwise `conv2d`, so that a matmul or
convolution run in TF32 (the control) shows. The gradient of the image comes
from autograd through that loss, the blend's from the closed form of the
plain blend backward, and the parameters' from autograd through the
projection and SH chain.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

OPACITY_THRESHOLD = 1.0 / 255.0
FRUSTUM_NEAR = 0.2
COV2D_DILATION = 0.3
ALPHA_CAP = 0.99
T_EPS = 1e-4
TILE_PIX = 1024
INVALID_KEY = 0xFFFFFFFF
CHUNK = 256
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
C1, C2 = 0.01 ** 2, 0.03 ** 2
GROUPS = ("xyz", "dc", "sh_rest", "opacity", "log_scale", "quat")
# elements of one (tiles, entries, pixels) block of the blend
BLOCK_ELEMS = 1 << 26

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


# --------------------------------------------------------------------------- camera

class Cam(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    lims: tuple              # limx_neg, limx_pos, limy_neg, limy_pos
    R_cw: torch.Tensor       # (3, 3)
    t_cw: torch.Tensor       # (3,)
    full_proj: torch.Tensor  # (4, 4)
    center: torch.Tensor     # (3,)


def _matvec(M, v):
    return (M * v.unsqueeze(-2)).sum(-1)


def camera(p: dict, R_wc: torch.Tensor, t_wc: torch.Tensor) -> Cam:
    """The camera of a world-from-camera pose for the intrinsics in `p`
    (width, height, fx, fy, cx, cy, znear, zfar)."""
    W, H, fx, fy, cx, cy = (p[k] for k in ("width", "height", "fx", "fy", "cx", "cy"))
    znear, zfar = p.get("znear", 0.01), p.get("zfar", 100.0)
    dev = R_wc.device
    R_wc = R_wc.float()
    R_cw = R_wc.transpose(-1, -2).contiguous()
    t_cw = -_matvec(R_cw, t_wc.float())
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 1.0 / (W / (2.0 * fx))
    P[1, 1] = 1.0 / (H / (2.0 * fy))
    P[0, 2] = (2.0 * cx - W) / W
    P[1, 2] = (2.0 * cy - H) / H
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    V = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    V[:3, :3] = R_cw
    V[:3, 3] = t_cw
    V[3, 3] = 1.0
    Pt = torch.as_tensor(P, device=dev)
    full = (Pt.unsqueeze(-1) * V.unsqueeze(-3)).sum(-2)
    lims = (-0.15 * W / fx - cx / fx, 1.15 * W / fx - cx / fx,
            -0.15 * H / fy - cy / fy, 1.15 * H / fy - cy / fy)
    center = -_matvec(R_cw.transpose(-1, -2), t_cw)
    return Cam(W, H, fx, fy, lims, R_cw, t_cw, full, center)


# ------------------------------------------------------------------- preprocess

def activate(log_scale, quat, opa_logit):
    rotation = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-12)
    return torch.exp(log_scale), rotation, torch.sigmoid(opa_logit)


def _affine3(x, y, z, M, row, t):
    return x * M[row, 0] + y * M[row, 1] + z * M[row, 2] + t


def project(xyz, scale, quat, cam: Cam) -> dict:
    """Depth, pixel mean, EWA conic and radius of every Gaussian."""
    R, t, fp = cam.R_cw, cam.t_cw, cam.full_proj
    X, Y, Z = xyz.unbind(-1)
    pvx = _affine3(X, Y, Z, R, 0, t[0])
    pvy = _affine3(X, Y, Z, R, 1, t[1])
    depth = _affine3(X, Y, Z, R, 2, t[2])
    in_front = depth > FRUSTUM_NEAR
    phx = _affine3(X, Y, Z, fp, 0, fp[0, 3])
    phy = _affine3(X, Y, Z, fp, 1, fp[1, 3])
    pw = _affine3(X, Y, Z, fp, 3, fp[3, 3])
    inv_w = 1.0 / (pw + 1e-7)
    W, H = float(cam.width), float(cam.height)
    xy = torch.stack([((phx * inv_w + 1.0) * W - 1.0) * 0.5,
                      ((phy * inv_w + 1.0) * H - 1.0) * 0.5], dim=-1)
    tz = torch.where(depth.abs() > 1e-8, depth, torch.full_like(depth, 1e-8))
    lxn, lxp, lyn, lyp = cam.lims
    tx = torch.clamp(pvx / tz, lxn, lxp) * tz
    ty = torch.clamp(pvy / tz, lyn, lyp) * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    J00 = float(cam.fx) * inv_tz
    J11 = float(cam.fy) * inv_tz
    J02 = -float(cam.fx) * tx * inv_tz2
    J12 = -float(cam.fy) * ty * inv_tz2
    m00 = J00 * R[0, 0] + J02 * R[2, 0]
    m01 = J00 * R[0, 1] + J02 * R[2, 1]
    m02 = J00 * R[0, 2] + J02 * R[2, 2]
    m10 = J11 * R[1, 0] + J12 * R[2, 0]
    m11 = J11 * R[1, 1] + J12 * R[2, 1]
    m12 = J11 * R[1, 2] + J12 * R[2, 2]
    qn = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-12)
    qr, qx, qy, qz = qn.unbind(-1)
    R00 = 1.0 - 2.0 * (qy * qy + qz * qz)
    R01 = 2.0 * (qx * qy - qr * qz)
    R02 = 2.0 * (qx * qz + qr * qy)
    R10 = 2.0 * (qx * qy + qr * qz)
    R11 = 1.0 - 2.0 * (qx * qx + qz * qz)
    R12 = 2.0 * (qy * qz - qr * qx)
    R20 = 2.0 * (qx * qz - qr * qy)
    R21 = 2.0 * (qy * qz + qr * qx)
    R22 = 1.0 - 2.0 * (qx * qx + qy * qy)
    s0 = scale[..., 0] * scale[..., 0]
    s1 = scale[..., 1] * scale[..., 1]
    s2 = scale[..., 2] * scale[..., 2]
    S00 = s0 * R00 * R00 + s1 * R01 * R01 + s2 * R02 * R02
    S01 = s0 * R00 * R10 + s1 * R01 * R11 + s2 * R02 * R12
    S02 = s0 * R00 * R20 + s1 * R01 * R21 + s2 * R02 * R22
    S11 = s0 * R10 * R10 + s1 * R11 * R11 + s2 * R12 * R12
    S12 = s0 * R10 * R20 + s1 * R11 * R21 + s2 * R12 * R22
    S22 = s0 * R20 * R20 + s1 * R21 * R21 + s2 * R22 * R22
    t0 = S00 * m00 + S01 * m01 + S02 * m02
    t1 = S01 * m00 + S11 * m01 + S12 * m02
    t2 = S02 * m00 + S12 * m01 + S22 * m02
    a = m00 * t0 + m01 * t1 + m02 * t2 + COV2D_DILATION
    b = m10 * t0 + m11 * t1 + m12 * t2
    u0 = S00 * m10 + S01 * m11 + S02 * m12
    u1 = S01 * m10 + S11 * m11 + S12 * m12
    u2 = S02 * m10 + S12 * m11 + S22 * m12
    c = m10 * u0 + m11 * u1 + m12 * u2 + COV2D_DILATION
    det = a * c - b * b
    det_valid = det != 0.0
    inv_det = 1.0 / torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))
    radius = torch.where(in_front & det_valid, radius, torch.zeros_like(radius))
    return dict(depth=depth, xy=xy, conic=conic, radius=radius, in_front=in_front,
                det_valid=det_valid)


def sh_colour(dc, sh_rest, dirs):
    """Degree-3 SH colour, clamped at 0."""
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    s = sh_rest
    r = SH_C0 * dc
    r = r - SH_C1 * y * s[..., 0, :] + SH_C1 * z * s[..., 1, :] - SH_C1 * x * s[..., 2, :]
    xx, yy, zz = x * x, y * y, z * z
    xy_, yz, xz = x * y, y * z, x * z
    r = (r + SH_C2[0] * xy_ * s[..., 3, :] + SH_C2[1] * yz * s[..., 4, :]
         + SH_C2[2] * (2.0 * zz - xx - yy) * s[..., 5, :] + SH_C2[3] * xz * s[..., 6, :]
         + SH_C2[4] * (xx - yy) * s[..., 7, :])
    r = (r + SH_C3[0] * y * (3.0 * xx - yy) * s[..., 8, :] + SH_C3[1] * xy_ * z * s[..., 9, :]
         + SH_C3[2] * y * (4.0 * zz - xx - yy) * s[..., 10, :]
         + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * s[..., 11, :]
         + SH_C3[4] * x * (4.0 * zz - xx - yy) * s[..., 12, :]
         + SH_C3[5] * z * (xx - yy) * s[..., 13, :]
         + SH_C3[6] * x * (xx - 3.0 * yy) * s[..., 14, :])
    return torch.clamp_min(r + 0.5, 0.0)


def preprocess(params: Dict[str, torch.Tensor], count: int, cam: Cam) -> dict:
    """The (P, 9) rows x, y, A, B, C, opacity, r, g, b (differentiable as the
    parameters are), and the detached depth, radius and activated opacity."""
    xyz = params["xyz"]
    scale, quat, opa = activate(params["log_scale"], params["quat"], params["opacity"])
    t = project(xyz, scale, quat, cam)
    P = xyz.shape[0]
    active = torch.arange(P, device=xyz.device) < count
    base_active = t["in_front"] & t["det_valid"] & (opa >= OPACITY_THRESHOLD) & active
    radius = torch.where(base_active, t["radius"], torch.zeros_like(t["radius"]))
    rgb = sh_colour(params["dc"], params["sh_rest"], xyz - cam.center)
    rows = torch.cat([t["xy"], t["conic"], opa[:, None], rgb], dim=1)
    return dict(rows=rows, depth=t["depth"].detach(), radius=radius.detach(),
                opacity=opa.detach(), live=base_active & (radius > 0.0))


# ---------------------------------------------------------------------- binning

def splat_budget(capacity: int, factor: float, K: int) -> int:
    b = max(int(capacity * factor), 1 << 12)
    b = (b + CHUNK - 1) // CHUNK * CHUNK
    return min(b, capacity * K)


def _to_int32(v):
    return torch.clamp(v, -(2.0 ** 30), 2.0 ** 30).to(torch.int32)


def _min_power(A, B, C, mx, my, rminx, rminy, rmaxx, rmaxy):
    """The least Gaussian power over a pixel rect (StopThePop's exact cull)."""
    x_min_diff = rminx - mx
    y_min_diff = rminy - my
    x_left = (x_min_diff > 0.0).float()
    y_above = (y_min_diff > 0.0).float()
    not_in_x = x_left + (mx > rmaxx).float()
    not_in_y = y_above + (my > rmaxy).float()
    size_x = rmaxx - rminx
    size_y = rmaxy - rminy
    px = x_left * rminx + (1.0 - x_left) * rmaxx
    py = y_above * rminy + (1.0 - y_above) * rmaxy
    dx = torch.where(x_min_diff >= 0, size_x, -size_x)
    dy = torch.where(y_min_diff >= 0, size_y, -size_y)
    diffx = mx - px
    diffy = my - py
    rcp_dxdxA = 1.0 / (size_x * size_x * A + 1e-12)
    rcp_dydyC = 1.0 / (size_y * size_y * C + 1e-12)
    tx = not_in_y * torch.clamp((dx * A * diffx + dx * B * diffy) * rcp_dxdxA, 0.0, 1.0)
    ty = not_in_x * torch.clamp((dy * B * diffx + dy * C * diffy) * rcp_dydyC, 0.0, 1.0)
    ddx = mx - (px + tx * dx)
    ddy = my - (py + ty * dy)
    power = 0.5 * (A * ddx * ddx + C * ddy * ddy) + B * ddx * ddy
    return torch.where((not_in_x + not_in_y) > 0.0, power, torch.zeros_like(power))


class Binned(NamedTuple):
    sorted_gauss: torch.Tensor   # (m,) int64, P for dead entries
    starts: torch.Tensor         # (T,) int64
    lens: torch.Tensor           # (T,) int64
    num_valid: int               # live slots before the budget cut
    truncated: int               # rect tiles past the K-slot cap
    n_tx: int
    n_ty: int


def bin_tiles(pre: dict, width: int, height: int, tile: int, K: int, budget: int) -> Binned:
    """Every Gaussian's K tile slots of its rect, row-major, kept where the
    exact cull passes; keys (tile << depth_bits) | truncated depth, sorted
    stably in k-major slot order, cut at `budget` entries."""
    xy = pre["rows"][:, 0:2].detach()
    conic = pre["rows"][:, 2:5].detach()
    radius, live, opa = pre["radius"], pre["live"], pre["opacity"]
    P = xy.shape[0]
    dev = xy.device
    n_tx, n_ty = -(-width // tile), -(-height // tile)
    T = n_tx * n_ty
    depth_bits = 32 - max(int(T + 1).bit_length(), 1)
    bits = pre["depth"].float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    dkey = bits >> (31 - depth_bits)
    x, y, r = xy[:, 0], xy[:, 1], radius
    rminx = torch.clamp(_to_int32((x - r) / tile), 0, n_tx)
    rminy = torch.clamp(_to_int32((y - r) / tile), 0, n_ty)
    rmaxx = torch.clamp(_to_int32((x + r + tile - 1) / tile), 0, n_tx)
    rmaxy = torch.clamp(_to_int32((y + r + tile - 1) / tile), 0, n_ty)
    rect_w = rmaxx - rminx
    rect_count = rect_w * (rmaxy - rminy)
    k = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    safe_w = torch.clamp_min(rect_w, 1)[None, :]
    tx = rminx[None, :] + k % safe_w
    ty = rminy[None, :] + torch.div(k, safe_w, rounding_mode="floor")
    in_rect = k < rect_count[None, :]
    txf, tyf = tx.float(), ty.float()
    power = _min_power(conic[None, :, 0], conic[None, :, 1], conic[None, :, 2],
                       xy[None, :, 0], xy[None, :, 1], txf * tile, tyf * tile,
                       (txf + 1.0) * tile - 1.0, (tyf + 1.0) * tile - 1.0)
    thresh = torch.log(torch.clamp_min(opa, OPACITY_THRESHOLD) / OPACITY_THRESHOLD)
    valid = live[None, :] & in_rect & (power <= thresh[None, :])
    del power, txf, tyf
    truncated = int(torch.where(live, torch.clamp_min(rect_count - in_rect.sum(0), 0), 0).sum())
    tile_id = torch.where(valid, ty * n_tx + tx, 0).to(torch.int64)
    keys = torch.where(valid, (tile_id << depth_bits) | dkey[None, :],
                       torch.full_like(tile_id, INVALID_KEY)).reshape(-1)
    del tile_id, tx, ty, in_rect
    num_valid = int(valid.sum())
    m = min(budget, num_valid)
    sorted_keys, slots = torch.sort(keys, stable=True)
    sorted_keys, slots = sorted_keys[:m], slots[:m]
    edges = torch.searchsorted(sorted_keys >> depth_bits,
                               torch.arange(T + 1, dtype=torch.int64, device=dev), side="left")
    return Binned(slots % P, edges[:-1], edges[1:] - edges[:-1], num_valid, truncated,
                  n_tx, n_ty)


# ------------------------------------------------------------------------ blend

def _blocks(lens: torch.Tensor):
    """(tile indices, padded length L) groups of at most BLOCK_ELEMS elements."""
    ls = lens.tolist()
    i, n = 0, len(ls)
    while i < n:
        j, L = i, 0
        while j < n:
            L2 = max(L, ls[j], 1)
            if j > i and (j - i + 1) * L2 * TILE_PIX > BLOCK_ELEMS:
                break
            L, j = L2, j + 1
        yield torch.arange(i, j, device=lens.device), L
        i = j


def _entries(splats, starts, lens, tiles, L):
    ar = torch.arange(L, device=splats.device)
    valid = ar[None, :] < lens[tiles][:, None]
    idx = torch.where(valid, starts[tiles][:, None] + ar[None, :], torch.zeros_like(ar[None]))
    return splats[idx] * valid[..., None], idx, valid


def _pixels(tiles, n_tx, tile):
    flat = torch.arange(TILE_PIX, device=tiles.device)
    tx = (tiles % n_tx)[:, None]
    ty = torch.div(tiles, n_tx, rounding_mode="floor")[:, None]
    px = (tx * tile + flat[None] % tile).float()
    py = (ty * tile + torch.div(flat[None], tile, rounding_mode="floor")).float()
    return px, py


def _alpha(e, px, py):
    x, y, A, B, C, opa = (e[..., i:i + 1] for i in range(6))
    dx = x - px[:, None, :]
    dy = y - py[:, None, :]
    power = (-0.5 * A * dx - B * dy) * dx + (-0.5 * C * dy) * dy
    G = torch.exp(power)
    alpha = torch.clamp_max(opa * G, ALPHA_CAP)
    return dx, dy, G, alpha, (alpha >= OPACITY_THRESHOLD) & (power <= 0.0)


def _to_image(per_tile, n_tx, n_ty, tile):
    lead = per_tile.shape[1:-1]
    x = per_tile.reshape((n_ty, n_tx) + lead + (tile, tile))
    nl = len(lead)
    perm = tuple(range(2, 2 + nl)) + (0, 2 + nl, 1, 3 + nl)
    return x.permute(perm).reshape(lead + (n_ty * tile, n_tx * tile)).contiguous()


def _to_tiles(img, n_tx, n_ty, tile):
    lead = img.shape[:-2]
    nl = len(lead)
    x = img.reshape(lead + (n_ty, tile, n_tx, tile))
    perm = (nl, nl + 2) + tuple(range(nl)) + (nl + 1, nl + 3)
    return x.permute(perm).reshape((n_ty * n_tx,) + lead + (TILE_PIX,))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away
    from zero, as the tensor cores round their inputs; the gradient passes
    through the rounding unchanged."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def blend_forward(splats, b: Binned, tile: int, counts: dict = None, lower: bool = False):
    """Front-to-back blend of each tile's list: (image (3, Hp, Wp), final T,
    n_contrib). With `counts`, adds the (entry, pixel) pairs the result
    needs: `applied` and `stopped` (a pixel's stopping pair). `lower` takes
    the colour sum's operands in TF32."""
    dev = splats.device
    T = b.n_tx * b.n_ty
    color = torch.zeros((T, 3, TILE_PIX), dtype=torch.float32, device=dev)
    final_t = torch.ones((T, TILE_PIX), dtype=torch.float32, device=dev)
    ncontrib = torch.zeros((T, TILE_PIX), dtype=torch.int64, device=dev)
    for tiles, L in _blocks(b.lens):
        e, _, _ = _entries(splats, b.starts, b.lens, tiles, L)
        px, py = _pixels(tiles, b.n_tx, tile)
        _, _, _, alpha, contrib = _alpha(e, px, py)
        t_f = 1.0 - torch.where(contrib, alpha, torch.zeros_like(alpha))
        T_excl = torch.cumprod(torch.cat([torch.ones_like(t_f[:, :1]), t_f[:, :-1]], 1), 1)
        trigger = contrib & (T_excl * t_f < T_EPS)
        applied = contrib & ~(torch.cumsum(trigger.to(torch.int32), 1) > 0)
        del T_excl, t_f
        a = torch.where(applied, alpha, torch.zeros_like(alpha))
        T_incl = torch.cumprod(1.0 - a, 1)
        final_t[tiles] = T_incl[:, -1]
        w = a * torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]], 1)
        rgb = e[..., 6:9]
        if lower:
            w, rgb = tf32(w), tf32(rgb)
        color[tiles] = torch.einsum("glp,glc->gcp", w, rgb)
        pos = torch.arange(1, L + 1, device=dev)[None, :, None]
        ncontrib[tiles] = torch.where(applied, pos, 0).amax(1)
        if counts is not None:
            counts["applied"] += int(applied.sum())
            counts["stopped"] += int(trigger.any(1).sum())
    return (_to_image(color, b.n_tx, b.n_ty, tile), _to_image(final_t, b.n_tx, b.n_ty, tile),
            _to_image(ncontrib, b.n_tx, b.n_ty, tile))


def blend_backward(splats, b: Binned, tile: int, dl_dcolor, final_t, ncontrib, P: int):
    """(P, 9) gradients of the rows: T rebuilt back to front from final T,
    the per-entry gradients summed per Gaussian."""
    dev = splats.device
    grads = torch.zeros((P + 1, 9), dtype=torch.float32, device=dev)
    dl_t = _to_tiles(dl_dcolor, b.n_tx, b.n_ty, tile)
    ft_t = _to_tiles(final_t, b.n_tx, b.n_ty, tile)
    nc_t = _to_tiles(ncontrib, b.n_tx, b.n_ty, tile)
    for tiles, L in _blocks(b.lens):
        e, idx, valid = _entries(splats, b.starts, b.lens, tiles, L)
        px, py = _pixels(tiles, b.n_tx, tile)
        dl, ft, nc = dl_t[tiles], ft_t[tiles], nc_t[tiles]
        dx, dy, G, alpha, contrib = _alpha(e, px, py)
        pos = torch.arange(1, L + 1, device=dev)[None, :, None]
        applied = contrib & (pos <= nc[:, None, :])
        inv_om = 1.0 / (1.0 - alpha)
        f = torch.where(applied, inv_om, torch.ones_like(inv_om))
        Tb = ft[:, None, :] * torch.cumprod(f.flip(1), 1).flip(1)
        del f
        A, B, C, opa = (e[..., i:i + 1] for i in (2, 3, 4, 5))
        dlr, dlg, dlb = dl[:, 0:1], dl[:, 1:2], dl[:, 2:3]
        s1 = e[..., 6:7] * dlr + e[..., 7:8] * dlg + e[..., 8:9] * dlb
        wsel = torch.where(applied, alpha * Tb, torch.zeros_like(Tb))
        ws1 = torch.cumsum((wsel * s1).flip(1), 1).flip(1)
        Sdl = torch.cat([ws1[:, 1:], torch.zeros_like(ws1[:, :1])], 1)
        del ws1
        dalpha = torch.where(applied, Tb * s1 - Sdl * inv_om, torch.zeros_like(Tb))
        del Sdl, s1, Tb, inv_om
        E = G * dalpha
        gd = opa * E
        t1 = gd * dx
        t2 = gd * dy
        m1 = t1.sum(-1)
        m2 = t2.sum(-1)
        q = torch.stack([
            -(A[..., 0] * m1 + B[..., 0] * m2), -(C[..., 0] * m2 + B[..., 0] * m1),
            -0.5 * (t1 * dx).sum(-1), -(t1 * dy).sum(-1), -0.5 * (t2 * dy).sum(-1),
            E.sum(-1), (wsel * dlr).sum(-1), (wsel * dlg).sum(-1), (wsel * dlb).sum(-1),
        ], -1)
        gid = b.sorted_gauss[idx[valid]]
        grads.index_add_(0, gid, q[valid])
    return grads[:P]


# ------------------------------------------------------------------------- loss

def _window(device):
    x = np.arange(11, dtype=np.float64) - 5
    g = np.exp(-(x ** 2) / (2.0 * 1.5 ** 2))
    g = (g / g.sum()).astype(np.float32)
    w = torch.as_tensor(np.outer(g, g), device=device)
    return w.expand(3, 1, 11, 11).contiguous()


def ssim(img, gt, lower: bool = False):
    """Mean SSIM of two (3, H, W) images, 11x11 Gaussian window (sigma 1.5),
    zero padding. `lower` takes the window's convolution operands in TF32."""
    w = _window(img.device)
    rnd = tf32 if lower else (lambda x: x)

    def blur(x):
        return F.conv2d(rnd(x)[None], rnd(w), padding=5, groups=3)[0]

    mu1, mu2 = blur(img), blur(gt)
    s11 = blur(img * img) - mu1 * mu1
    s22 = blur(gt * gt) - mu2 * mu2
    s12 = blur(img * gt) - mu1 * mu2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))
    return m.mean()


def training_loss(img, gt, lambda_dssim, lower: bool = False):
    return ((1.0 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1.0 - ssim(img, gt, lower)))


def psnr(img, gt):
    return 10.0 * torch.log10(1.0 / ((img - gt) ** 2).mean())


# ------------------------------------------------------------------------ steps

def render(params: dict, count: int, cam: Cam, tile: int, K: int, budget: int,
           counts: dict = None, lower: bool = False):
    """Forward render: (pre, binning, splats, image (3, H, W), final T,
    n_contrib), the last two padded to the tile grid."""
    with torch.no_grad():
        pre = preprocess(params, count, cam)
        b = bin_tiles(pre, cam.width, cam.height, tile, K, budget)
        P = pre["rows"].shape[0]
        table = torch.cat([pre["rows"].detach(), pre["rows"].new_zeros((1, 9))])
        splats = table[b.sorted_gauss]
        color, final_t, nc = blend_forward(splats, b, tile, counts, lower)
    if counts is not None:
        counts["entries"] += int(b.lens.sum())
        counts["visible"] += int((pre["radius"] > 0).sum())
        counts["truncated"] += b.truncated
        counts["num_valid"] += b.num_valid
        counts["P"] = P
    return pre, b, splats, color[:, :cam.height, :cam.width], final_t, nc


def train_step(params: dict, moments: dict, count: int, cam: Cam, gt, cfg: dict,
               budget: int, counts: dict = None, loss_fn=None, lower: bool = False):
    """One step: render, loss (`loss_fn`, default `training_loss`),
    gradients, sparse Adam; `lower` takes the contractions' operands in
    TF32. Returns (loss, the gradients, the new parameters, the new moments,
    the budget loss)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    tile, K = cfg["tile_h"], cfg["max_tiles_per_gaussian"]
    with torch.enable_grad():
        pre = preprocess(leaves, count, cam)
    with torch.no_grad():
        b = bin_tiles(pre, cam.width, cam.height, tile, K, budget)
        table = torch.cat([pre["rows"].detach(), pre["rows"].new_zeros((1, 9))])
        splats = table[b.sorted_gauss]
        color, final_t, nc = blend_forward(splats, b, tile, counts, lower)
    H, W = cam.height, cam.width
    img = color[:, :H, :W].detach().requires_grad_(True)
    with torch.enable_grad():
        loss = (loss_fn(img, gt, cfg["lambda_dssim"]) if loss_fn
                else training_loss(img, gt, cfg["lambda_dssim"], lower))
        (d_img,) = torch.autograd.grad(loss, [img])
    d_pad = torch.zeros_like(color)
    d_pad[:, :H, :W] = d_img
    P = pre["rows"].shape[0]
    d_rows = blend_backward(splats, b, tile, d_pad, final_t, nc, P)
    with torch.enable_grad():
        got = torch.autograd.grad(pre["rows"], [leaves[g] for g in GROUPS], d_rows,
                                  allow_unused=True)
    grads = {g: torch.zeros_like(leaves[g]) if d is None else d for g, d in zip(GROUPS, got)}
    visible = pre["radius"] > 0.0
    lrs = dict(xyz=cfg["position_lr"], dc=cfg["feature_lr"], sh_rest=cfg["feature_lr"] / 20.0,
               opacity=cfg["opacity_lr"], log_scale=cfg["scaling_lr"], quat=cfg["rotation_lr"])
    new_p, new_m = {}, {}
    with torch.no_grad():
        for g in GROUPS:
            p, (m0, v0) = params[g], moments[g]
            mask = visible.reshape((-1,) + (1,) * (p.dim() - 1))
            m = BETA1 * m0 + (1.0 - BETA1) * grads[g]
            v = BETA2 * v0 + (1.0 - BETA2) * grads[g] * grads[g]
            new_p[g] = torch.where(mask, p + (-lrs[g] * m / (torch.sqrt(v) + ADAM_EPS)), p)
            new_m[g] = (torch.where(mask, m, m0), torch.where(mask, v, v0))
    if counts is not None:
        counts["entries"] += int(b.lens.sum())
        counts["visible"] += int(visible.sum())
        counts["P"] = P
    lost = max(b.num_valid - budget, 0)
    return float(loss.detach()), {g: torch.where(visible.reshape((-1,) + (1,) * (grads[g].dim() - 1)),
                                        grads[g], 0.0) for g in GROUPS}, new_p, new_m, lost


def next_budget_factor(factor: float, capacity: int, K: int, lost: int) -> float:
    """The engine's splat-budget growth after a step that lost entries past
    the budget: x1.5 of the effective factor, capped at K."""
    if lost <= 0 or factor >= K:
        return factor
    eff = splat_budget(max(capacity, 1), factor, K) / max(capacity, 1)
    return min(max(factor, eff) * 1.5, float(K))


def leaf_norms(tensors: dict) -> dict:
    return {g: float(torch.linalg.vector_norm(t.double())) for g, t in tensors.items()}


def gap_of_norms(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's."""
    names = [g for g in ref if keep is None or g in keep]
    if not names:
        return 0.0
    med = float(np.median([ref[g] for g in names]))
    return max(abs(prog[g] - ref[g]) / max(ref[g], med, 1e-30) for g in names)


def check_train(params0: dict, count: int, cams: list, gts: list, cfg: dict, capacity: int,
                factor: float, calls: list, tf32: bool = False, counts: dict = None,
                loss_fn=None) -> dict:
    """The reference's first steps from the inputs, step i on cams[i] and
    gts[i], grouped into calls of `calls` steps as the engine's optimize()
    calls: each call's last loss, the first step's gradient norms and the
    norms of the parameters' change after the last step, by leaf. The
    splat budget grows after a call that lost entries, as the engine's.
    `tf32` computes the control: TF32 allowed in matmuls and convolutions,
    and the operands of the blend's colour sum and of SSIM's window rounded
    to TF32 (cuBLAS and cuDNN keep float32 for shapes as narrow as these).
    `loss_fn` plants a fault in the loss."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        K = cfg["max_tiles_per_gaussian"]
        params = {g: t.clone() for g, t in params0.items()}
        moments = {g: (torch.zeros_like(t), torch.zeros_like(t)) for g, t in params0.items()}
        losses, g1, i = [], None, 0
        for n in calls:
            budget, lost = splat_budget(capacity, factor, K), 0
            for _ in range(n):
                loss, grads, params, moments, step_lost = train_step(
                    params, moments, count, cams[i], gts[i], cfg, budget,
                    counts if i == 0 else None, loss_fn, tf32)
                if i == 0:
                    g1 = leaf_norms(grads)
                lost, i = max(lost, step_lost), i + 1
                del grads
            losses.append(loss)
            factor = next_budget_factor(factor, capacity, K, lost)
        change = leaf_norms({g: params[g] - params0[g] for g in GROUPS})
        return dict(losses=losses, grad_norms=g1, change_norms=change)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def moved_leaves(grad_norms: dict) -> list:
    """The leaves whose first gradient is not nought to rounding: at least a
    thousandth of the median leaf's norm."""
    med = float(np.median(list(grad_norms.values())))
    return [g for g, n in grad_norms.items() if n >= 1e-3 * med]


def eval_view(params: dict, count: int, cam: Cam, gt, cfg: dict, budget: int,
              tf32: bool = False):
    """(PSNR, SSIM) of one view, the image clamped to [0, 1] first."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            *_, img, _, _ = render(params, count, cam, cfg["tile_h"],
                                   cfg["max_tiles_per_gaussian"], budget, lower=tf32)
            img = img.clamp(0.0, 1.0)
            return float(psnr(img, gt)), float(ssim(img, gt, tf32))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

