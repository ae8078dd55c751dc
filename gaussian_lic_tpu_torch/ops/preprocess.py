"""Per-Gaussian preprocess: kernels K5 (`preprocess_forward`) and K6
(`preprocess_backward`), joined by the autograd Function `Preprocess`.

The counterpart of the program XLA fuses on the TPU from the JAX package's
`models/gaussians.py` activations (scaling = exp, rotation = q / (|q| +
1e-12), opacity = sigmoid), `ops/projection.py:project_gaussians`,
`ops/sh.py:eval_sh_color` and `ops/rasterize.py:_pack_rows` (and of its
autodiff): the reference's
preprocessCUDA (forward.cu:232-319) and BACKWARD::preprocess
(backward.cu:312-377, 599-657). Per Gaussian, K5 computes the projection
(frustum depth, pixel mean, EWA conic, radius), `base_active` and the
masked radius of the binning, and the SH colour, and writes the packed
splat row (x, y, A, B, C, opacity, r, g, b, then 7 zeros) straight into a
(P + 1, 16) table whose last row is zero: the table K1's gather indexes
(the sorted list's dead id P reads the zero row). It also writes the
detached depth, radius and base_active that the binning reads (x, y and the
conic are views of the table). K6 takes the blend's per-Gaussian gradient
of the nine row attributes, K2's (P, 9) output as it is (a view of K2's
12-float table), recomputes the forward terms instead of reading saved ones
(fewer bytes) and writes d xyz (projection and SH direction), d scale, d
quat (through the normalisation), d opacity, d dc and d sh_rest.

Two input forms (`raw`): the map's stored parameters log_scale, quat and
opa_logit, which K5 activates in registers exactly as `activate` (CUDA's
torch.exp, the norm chain, torch.sigmoid) and whose gradients K6 writes,
chained through the activations (the train step, the sharded step, every
render of a map); or scale, quat and opacity already activated (the dense
oracle's and the probes' scenes, `colors`). From the stored parameters K5
also writes the activated opacity (P,), which the binning reads.

Bounds on an H100 (3.35 TB/s) at P = 2^20: K5 reads 59 floats and writes a
16-float row, depth, radius and a flag (~0.10 ms); K6 reads the 9 gradient
columns (stride 12) and the 232 B of inputs and writes 236 B (~0.16 ms).
From the stored parameters K5 also writes the opacity and K6 reads its
logit, 4 B a Gaussian each (+0.0013 ms).
Both are one thread per Gaussian over per-row arithmetic, memory bound. K6
stages a block's 128 rows of every input in shared memory so that every
device-memory access is coalesced, and writes its gradients back the same
way (csrc/preprocess_backward.cu says why); `preprocess_backward_probe`
launches its timing variants (K6_VARIANTS).

Dispatch by the tensors' device, as `ops/blend.py`: CUDA tensors launch the
kernels (csrc/preprocess_forward.cu, csrc/preprocess_backward.cu) or raise;
CPU tensors take the plain chain (`preprocess_forward_plain`: projection,
SH and `pack_rows`, recorded with autograd, whose backward is autograd's).
`preprocess_backward_plain` is the plain closed form of K6, mirroring it
line for line, with autograd's masks. `LAUNCHES` counts kernel launches.

The rows' gradient reaches K6 through `Splats.attrs`, a (P, 9) stand-in
output of `Preprocess` (zero-strided, no memory): `_Blend` (ops/rasterize.py)
gathers from `Splats.table` and returns its (P, 9) gradient for `attrs`, so
nothing pads or copies it between K2 and K6.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gaussian_lic_tpu_torch.camera import Camera
from gaussian_lic_tpu_torch.ops import sh as sh_ops
from gaussian_lic_tpu_torch.ops.blend import N_ATTR, SPLAT_ROWS, _launch, _ptr, _stream
from gaussian_lic_tpu_torch.ops.projection import OPACITY_THRESHOLD, projection_terms

# Launch counts of K5 and K6 (plain-version calls are not counted).
LAUNCHES = {"preprocess_forward": 0, "preprocess_backward": 0}
# K6's timing variants (csrc/preprocess_backward.cuh K6Variant, in its
# order), off the main path: base is K6, direct K6's arithmetic on the first
# design's access pattern (K6's outputs bit for bit); noshio (no SH loads or
# d_sh stores) and noproj (no projection backward) are timing only.
K6_VARIANTS = ("base", "direct", "noshio", "noproj")
K6_TIMING_ONLY = ("noshio", "noproj")
PROBE_LAUNCHES = {v: 0 for v in K6_VARIANTS}

_F = ctypes.c_float


def reset_launches() -> None:
    for counter in (LAUNCHES, PROBE_LAUNCHES):
        for k in counter:
            counter[k] = 0


class Splats(NamedTuple):
    """What the binning and the blend take from the preprocess."""

    table: torch.Tensor        # (P+1, 16) packed rows, last row zero; no gradient
    attrs: torch.Tensor        # (P, 9) stand-in carrying the rows' gradient to K6
                               # (with `colors`: the plain chain's (P, 16) rows)
    xy: torch.Tensor           # (P, 2) view of the table, detached
    conic: torch.Tensor        # (P, 3) view of the table, detached
    depth: torch.Tensor        # (P,)
    radius: torch.Tensor       # (P,) ceil'd radius, 0 where not base_active
    base_active: torch.Tensor  # (P,) bool: in front, det != 0, opacity >= 1/255, active
    opacity: torch.Tensor      # (P,) activated opacity, detached


def activate(log_scale, quat, opa_logit):
    """GaussianMap's activations of the stored parameters (models/gaussians.py):
    (exp(log_scale), quat / (|quat| + 1e-12), sigmoid(opa_logit))."""
    rotation = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-12)
    return torch.exp(log_scale), rotation, torch.sigmoid(opa_logit)


def pack_rows(xy, conic, opacity, rgb) -> torch.Tensor:
    """(P, 16) rows: x, y, A, B, C, opa, r, g, b, then 7 zero columns."""
    P = xy.shape[0]
    pad = torch.zeros((P, SPLAT_ROWS - N_ATTR), dtype=xy.dtype, device=xy.device)
    return torch.cat([xy, conic, opacity[:, None], rgb, pad], dim=1)


def row_table(rows: torch.Tensor) -> torch.Tensor:
    """(P+1, 16): the rows and a zero row for the sorted list's dead id P."""
    return torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])


def _camera_args(camera: Camera):
    """(R_cw, t_cw, full_proj, cam_center) contiguous float32 on the camera's
    device, and the static floats of the intrinsics in kernel order: W, H,
    fx, fy, limx_neg, limx_pos, limy_neg, limy_pos."""
    intr = camera.intr
    tensors = tuple(t.contiguous() for t in (camera.pose.R_cw, camera.pose.t_cw,
                                             camera.full_proj, camera.cam_center))
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"camera tensors must be float32, got {t.dtype}")
    floats = (float(intr.width), float(intr.height), float(intr.fx), float(intr.fy),
              intr.limx_neg, intr.limx_pos, intr.limy_neg, intr.limy_pos)
    return tensors, tuple(_F(v) for v in floats)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def preprocess_forward_plain(xyz, scale, quat, opacity, camera, dc=None, sh_rest=None,
                             sh_degree=3, active=None, no_color=False, colors=None,
                             raw=False) -> dict:
    """The plain chain K5 replaces: with `raw`, `activate` of the stored
    parameters (scale, quat, opacity then hold log_scale, quat, opa_logit);
    `project_gaussians`, the binning's base_active and masked radius,
    `eval_sh_color` (zeros with `no_color`, `colors` where given) and
    `pack_rows`. Returns rows (P, 16), differentiable as its inputs are,
    the (P+1, 16) table, depth, radius, base_active and the activated
    opacity, detached."""
    if raw:
        scale, quat, opacity = activate(scale, quat, opacity)
    t = projection_terms(xyz, scale, quat, camera)
    base_active = t["in_front"] & t["det_valid"] & (opacity >= OPACITY_THRESHOLD)
    if active is not None:
        base_active = base_active & active
    radius = torch.where(base_active, t["radius"], torch.zeros_like(t["radius"]))
    if no_color:
        rgb = torch.zeros_like(xyz)
    elif colors is not None:
        rgb = colors
    else:
        rgb = sh_ops.eval_sh_color(sh_degree, dc, sh_rest, xyz - camera.cam_center)
    rows = pack_rows(t["xy"], t["conic"], opacity, rgb)
    return dict(rows=rows, table=row_table(rows.detach()), depth=t["depth"].detach(),
                radius=radius.detach(), base_active=base_active, opacity=opacity.detach())


def _norm_backward(v, n, g):
    """d v of v / (n + 1e-12), n = |v| (dim -1), for the cotangent g:
    autograd's division and norm backward (0 where n is 0)."""
    D = n + 1e-12
    dot = (g * v).sum(-1, keepdim=True)
    scale = torch.where(n == 0, torch.zeros_like(n), dot / (D * D * n))
    return g / D - v * scale


def _sh_basis(d, deg):
    """[(B_k (P,1), dB_k/d(x, y, z) three (P,1))] for the active rest
    coefficients k of degree <= deg, at unit directions d (P, 3)."""
    C1, C2, C3 = sh_ops.SH_C1, sh_ops.SH_C2, sh_ops.SH_C3
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    o = torch.zeros_like(x)
    xx, yy, zz = x * x, y * y, z * z
    out = []
    if deg > 0:
        out += [(-C1 * y, (o, o - C1, o)), (C1 * z, (o, o, o + C1)),
                (-C1 * x, (o - C1, o, o))]
    if deg > 1:
        out += [(C2[0] * x * y, (C2[0] * y, C2[0] * x, o)),
                (C2[1] * y * z, (o, C2[1] * z, C2[1] * y)),
                (C2[2] * (2 * zz - xx - yy), (-2 * C2[2] * x, -2 * C2[2] * y, 4 * C2[2] * z)),
                (C2[3] * x * z, (C2[3] * z, o, C2[3] * x)),
                (C2[4] * (xx - yy), (2 * C2[4] * x, -2 * C2[4] * y, o))]
    if deg > 2:
        out += [(C3[0] * y * (3 * xx - yy), (C3[0] * 6 * x * y, C3[0] * (3 * xx - 3 * yy), o)),
                (C3[1] * x * y * z, (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y)),
                (C3[2] * y * (4 * zz - xx - yy),
                 (C3[2] * -2 * x * y, C3[2] * (4 * zz - xx - 3 * yy), C3[2] * 8 * y * z)),
                (C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                 (C3[3] * -6 * x * z, C3[3] * -6 * y * z, C3[3] * (6 * zz - 3 * xx - 3 * yy))),
                (C3[4] * x * (4 * zz - xx - yy),
                 (C3[4] * (4 * zz - 3 * xx - yy), C3[4] * -2 * x * y, C3[4] * 8 * x * z)),
                (C3[5] * z * (xx - yy), (C3[5] * 2 * x * z, C3[5] * -2 * y * z, C3[5] * (xx - yy))),
                (C3[6] * x * (xx - 3 * yy), (C3[6] * (3 * xx - 3 * yy), C3[6] * -6 * x * y, o))]
    return out


@torch.no_grad()
def preprocess_backward_plain(xyz, scale, quat, opacity, camera, dc, sh_rest, sh_degree,
                              d_attrs, raw=False):
    """The closed-form backward of the plain chain for the rows' gradient
    `d_attrs` (P, 9) (x, y, A, B, C, opacity, r, g, b): (d xyz, d scale,
    d quat, d opacity, d dc, d sh_rest). It recomputes the forward terms
    and applies autograd's masks: the clamp of tx/ty passes inside its
    closed bounds, the selects on tz and det_valid pass where they take the
    computed value, the colour's clamp at 0 where the colour is >= 0, the
    ceil'd radius and the detached outputs give nothing, and coefficients
    above the active degree get zero. With `raw` (scale, quat, opacity are
    log_scale, quat, opa_logit as stored) it applies `activate` first and
    returns the stored parameters' gradients: exp's backward (d s times s),
    the first normalisation's (0 where |quat| is 0, as the second's) and
    torch.sigmoid's, `d (1 - s) s`. K6 (csrc/preprocess_backward.cu) is its
    line-for-line counterpart."""
    if raw:
        stored, (scale, quat, opacity) = quat, activate(scale, quat, opacity)
        out = list(preprocess_backward_plain(xyz, scale, quat, opacity, camera, dc, sh_rest,
                                             sh_degree, d_attrs))
        out[1] = out[1] * scale
        out[2] = _norm_backward(stored, torch.linalg.norm(stored, dim=-1, keepdim=True), out[2])
        out[3] = torch.ops.aten.sigmoid_backward(out[3], opacity)
        return tuple(out)
    intr = camera.intr
    Rc, Fp = camera.pose.R_cw, camera.full_proj
    t = projection_terms(xyz, scale, quat, camera)
    gx, gy, gA, gB, gC, go, gr, gg, gb = d_attrs.unbind(1)

    # pixel mean: xy = ((ph * inv_w + 1) * S - 1) / 2
    ax = gx * (0.5 * intr.width)
    ay = gy * (0.5 * intr.height)
    d_phx = ax * t["inv_w"]
    d_phy = ay * t["inv_w"]
    d_inv_w = ax * t["phx"] + ay * t["phy"]
    d_pw = -d_inv_w * t["inv_w"] * t["inv_w"]

    # conic = (c, -b, a) / det, det = a c - b^2 where det != 0
    a, b, c, inv_det = t["a"], t["b"], t["c"], t["inv_det"]
    d_a = gC * inv_det
    d_b = -gB * inv_det
    d_c = gA * inv_det
    d_inv_det = gA * c - gB * b + gC * a
    d_det = torch.where(t["det_valid"], -d_inv_det * inv_det * inv_det, torch.zeros_like(a))
    d_a = d_a + d_det * c
    d_c = d_c + d_det * a
    d_b = d_b - 2.0 * b * d_det

    # a = m0 S m0 + 0.3, b = m1 S m0, c = m1 S m1 + 0.3 (S symmetric)
    m0 = (t["m00"], t["m01"], t["m02"])
    m1 = (t["m10"], t["m11"], t["m12"])
    tt = (t["t0"], t["t1"], t["t2"])
    uu = (t["u0"], t["u1"], t["u2"])
    dS = {}
    for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)):
        if i == j:
            dS[i, j] = d_a * m0[i] * m0[i] + d_b * m1[i] * m0[i] + d_c * m1[i] * m1[i]
        else:
            dS[i, j] = (2.0 * d_a * m0[i] * m0[j] + d_b * (m1[i] * m0[j] + m1[j] * m0[i])
                        + 2.0 * d_c * m1[i] * m1[j])
    d_m0 = [2.0 * d_a * tt[j] + d_b * uu[j] for j in range(3)]
    d_m1 = [d_b * tt[j] + 2.0 * d_c * uu[j] for j in range(3)]

    # m0 = J00 Rc[0] + J02 Rc[2], m1 = J11 Rc[1] + J12 Rc[2]
    d_J00 = d_m0[0] * Rc[0, 0] + d_m0[1] * Rc[0, 1] + d_m0[2] * Rc[0, 2]
    d_J02 = d_m0[0] * Rc[2, 0] + d_m0[1] * Rc[2, 1] + d_m0[2] * Rc[2, 2]
    d_J11 = d_m1[0] * Rc[1, 0] + d_m1[1] * Rc[1, 1] + d_m1[2] * Rc[1, 2]
    d_J12 = d_m1[0] * Rc[2, 0] + d_m1[1] * Rc[2, 1] + d_m1[2] * Rc[2, 2]

    # J00 = fx / tz, J02 = -fx tx / tz^2 (and y)
    fx, fy = float(intr.fx), float(intr.fy)
    inv_tz, inv_tz2, tz = t["inv_tz"], t["inv_tz2"], t["tz"]
    d_inv_tz2 = -fx * t["tx"] * d_J02 - fy * t["ty"] * d_J12
    d_inv_tz = fx * d_J00 + fy * d_J11 + 2.0 * inv_tz * d_inv_tz2
    d_tx = -fx * inv_tz2 * d_J02
    d_ty = -fy * inv_tz2 * d_J12
    # tx = clamp(pvx / tz) tz
    zero = torch.zeros_like(tz)
    d_rx = torch.where((t["rx"] >= intr.limx_neg) & (t["rx"] <= intr.limx_pos), d_tx * tz, zero)
    d_ry = torch.where((t["ry"] >= intr.limy_neg) & (t["ry"] <= intr.limy_pos), d_ty * tz, zero)
    d_tz = (-d_inv_tz * inv_tz * inv_tz + d_tx * t["cx"] + d_ty * t["cy"]
            - (d_rx * t["rx"] + d_ry * t["ry"]) / tz)
    d_pvx = d_rx / tz
    d_pvy = d_ry / tz
    d_depth = torch.where(t["tz_kept"], d_tz, zero)
    d_xyz = torch.stack([d_pvx * Rc[0, k] + d_pvy * Rc[1, k] + d_depth * Rc[2, k]
                         + d_phx * Fp[0, k] + d_phy * Fp[1, k] + d_pw * Fp[3, k]
                         for k in range(3)], dim=1)

    # S_ij = sum_k s_k^2 R_ik R_jk
    R = [[t[f"R{i}{k}"] for k in range(3)] for i in range(3)]
    sig = (t["s0"], t["s1"], t["s2_"])
    M = [[2.0 * dS[i, i] if i == j else dS[min(i, j), max(i, j)] for j in range(3)]
         for i in range(3)]
    dR = [[sig[k] * (M[i][0] * R[0][k] + M[i][1] * R[1][k] + M[i][2] * R[2][k])
           for k in range(3)] for i in range(3)]
    d_sig = [dS[0, 0] * R[0][k] * R[0][k] + dS[1, 1] * R[1][k] * R[1][k]
             + dS[2, 2] * R[2][k] * R[2][k] + dS[0, 1] * R[0][k] * R[1][k]
             + dS[0, 2] * R[0][k] * R[2][k] + dS[1, 2] * R[1][k] * R[2][k] for k in range(3)]
    d_scale = torch.stack([2.0 * scale[:, k] * d_sig[k] for k in range(3)], dim=1)

    # R of the normalised quaternion (r, x, y, z)
    qr, qx, qy, qz = t["qr"], t["qx"], t["qy"], t["qz"]
    d_qr = 2.0 * (-qz * dR[0][1] + qy * dR[0][2] + qz * dR[1][0] - qx * dR[1][2]
                  - qy * dR[2][0] + qx * dR[2][1])
    d_qx = 2.0 * (qy * dR[0][1] + qz * dR[0][2] + qy * dR[1][0] - 2.0 * qx * dR[1][1]
                  - qr * dR[1][2] + qz * dR[2][0] + qr * dR[2][1] - 2.0 * qx * dR[2][2])
    d_qy = 2.0 * (-2.0 * qy * dR[0][0] + qx * dR[0][1] + qr * dR[0][2] + qx * dR[1][0]
                  + qz * dR[1][2] - qr * dR[2][0] + qz * dR[2][1] - 2.0 * qy * dR[2][2])
    d_qz = 2.0 * (-2.0 * qz * dR[0][0] - qr * dR[0][1] + qx * dR[0][2] + qr * dR[1][0]
                  - 2.0 * qz * dR[1][1] + qy * dR[1][2] + qx * dR[2][0] + qy * dR[2][1])
    d_quat = _norm_backward(quat, t["qnorm"], torch.stack([d_qr, d_qx, d_qy, d_qz], dim=1))

    # SH: rgb = clamp_min(C0 dc + sum_k B_k(d) sh_k + 0.5, 0), d = dirs / |dirs|
    dirs = xyz - camera.cam_center
    n = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    d = dirs / (n + 1e-12)
    raw = sh_ops.sh_color_unclamped(sh_degree, dc, sh_rest, dirs)
    dr = torch.where(raw >= 0.0, torch.stack([gr, gg, gb], dim=1), torch.zeros_like(raw))
    d_dc = sh_ops.SH_C0 * dr
    d_sh = torch.zeros_like(sh_rest)
    d_d = [torch.zeros_like(n) for _ in range(3)]
    for k, (B, dB) in enumerate(_sh_basis(d, sh_degree)):
        d_sh[:, k] = B * dr
        w = (dr * sh_rest[:, k]).sum(-1, keepdim=True)
        d_d = [d_d[i] + w * dB[i] for i in range(3)]
    d_xyz = d_xyz + _norm_backward(dirs, n, torch.cat(d_d, dim=1))
    return d_xyz, d_scale, d_quat, go.clone(), d_dc, d_sh


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_inputs(tensors: dict, device) -> None:
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        want = torch.bool if name == "active" else torch.float32
        if t.dtype != want or tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{name} must be {shape} {want} on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _sh_args(sh_rest, sh_degree, no_color):
    S = 0 if sh_rest is None else sh_rest.shape[1]
    if not no_color and S < (sh_degree + 1) ** 2 - 1:
        raise ValueError(f"degree {sh_degree} needs {(sh_degree + 1) ** 2 - 1} rest "
                         f"coefficients, sh_rest has {S}")
    return S


def _k5(xyz, scale, quat, opacity, camera, dc, sh_rest, sh_degree, active, no_color,
        raw=False):
    """K5 on CUDA tensors: (table, depth, radius, base_active, the activated
    opacity); with `raw`, from the stored parameters."""
    from gaussian_lic_tpu_torch import _build

    P, dev = xyz.shape[0], xyz.device
    S = _sh_args(sh_rest, sh_degree, no_color)
    _check_inputs(dict(xyz=(xyz, (P, 3)), scale=(scale, (P, 3)), quat=(quat, (P, 4)),
                       opacity=(opacity, (P,)), active=(active, (P,)),
                       dc=(None if no_color else dc, (P, 3)),
                       sh_rest=(None if no_color else sh_rest, (P, S, 3))), dev)
    cam, floats = _camera_args(camera)
    lib = _build.load()
    table = torch.empty((P + 1, SPLAT_ROWS), dtype=torch.float32, device=dev)
    depth = torch.empty((P,), dtype=torch.float32, device=dev)
    radius = torch.empty((P,), dtype=torch.float32, device=dev)
    base_active = torch.empty((P,), dtype=torch.bool, device=dev)
    opa = torch.empty((P,), dtype=torch.float32, device=dev) if raw else opacity
    null = ctypes.c_void_p(None)
    _launch(lib.cdll.glic_preprocess_forward, _ptr(xyz), _ptr(scale), _ptr(quat),
            _ptr(opacity), null if no_color else _ptr(dc), null if no_color else _ptr(sh_rest),
            null if active is None else _ptr(active), *(_ptr(t) for t in cam),
            ctypes.c_longlong(P), S, sh_degree, int(no_color), int(raw), *floats,
            _ptr(table), _ptr(depth), _ptr(radius), _ptr(base_active),
            _ptr(opa) if raw else null, _stream(dev))
    LAUNCHES["preprocess_forward"] += 1
    return table, depth, radius, base_active, opa


def _k6(xyz, scale, quat, camera, dc, sh_rest, sh_degree, d_attrs, variant=None,
        opacity=None, raw=False):
    """K6 on CUDA tensors: (d xyz, d scale, d quat, d opacity, d dc,
    d sh_rest); with `variant`, that variant of K6_VARIANTS through the
    probe entry; with `raw`, of the stored parameters (scale, quat and
    `opacity` then hold log_scale, quat and opa_logit; opacity is read only
    then). `d_attrs` (P, 9) may have any row stride (K2's is 12) and must
    have unit column stride; every array may start at any row of a larger
    one (the mesh step's shards)."""
    from gaussian_lic_tpu_torch import _build

    P, dev = xyz.shape[0], xyz.device
    S = _sh_args(sh_rest, sh_degree, False)
    if raw and opacity is None:
        raise ValueError("K6 from the stored parameters reads opa_logit: pass opacity")
    _check_inputs(dict(xyz=(xyz, (P, 3)), scale=(scale, (P, 3)), quat=(quat, (P, 4)),
                       opacity=(opacity if raw else None, (P,)),
                       dc=(dc, (P, 3)), sh_rest=(sh_rest, (P, S, 3)),
                       d_attrs=(d_attrs, (P, N_ATTR))), dev)
    if d_attrs.stride(1) != 1:
        raise ValueError(f"K6 reads d_attrs rows of unit column stride, got strides "
                         f"{tuple(d_attrs.stride())}")
    cam, floats = _camera_args(camera)
    lib = _build.load()
    outs = [torch.empty_like(t) for t in (xyz, scale, quat)]
    outs.append(torch.empty((P,), dtype=torch.float32, device=dev))
    outs += [torch.empty_like(dc), torch.empty_like(sh_rest)]
    args = (_ptr(xyz), _ptr(scale), _ptr(quat),
            _ptr(opacity) if raw else ctypes.c_void_p(None), _ptr(dc), _ptr(sh_rest),
            *(_ptr(t) for t in cam), _ptr(d_attrs), ctypes.c_longlong(d_attrs.stride(0)),
            ctypes.c_longlong(P), S, sh_degree, int(raw), *floats, *(_ptr(t) for t in outs),
            _stream(dev))
    if variant is None:
        _launch(lib.cdll.glic_preprocess_backward, *args)
        LAUNCHES["preprocess_backward"] += 1
    else:
        _launch(lib.cdll.glic_preprocess_probe_backward, K6_VARIANTS.index(variant), *args)
        PROBE_LAUNCHES[variant] += 1
    return tuple(outs)


def preprocess_forward(xyz, scale, quat, opacity, camera, dc=None, sh_rest=None,
                       sh_degree=3, active=None, no_color=False, raw=False):
    """K5, no gradient: (table (P+1, 16), depth, radius, base_active, the
    activated opacity) on the inputs' device (CPU tensors: the plain
    version's); with `raw`, from the stored log_scale, quat and opa_logit."""
    if xyz.device.type == "cpu":
        p = preprocess_forward_plain(xyz, scale, quat, opacity, camera, dc, sh_rest,
                                     sh_degree, active, no_color, raw=raw)
        return p["table"], p["depth"], p["radius"], p["base_active"], p["opacity"]
    if xyz.device.type != "cuda":
        raise ValueError(f"the preprocess takes CPU or CUDA tensors, got {xyz.device}")
    xyz, scale, quat, opacity = (t.contiguous() for t in (xyz, scale, quat, opacity))
    if not no_color:
        dc, sh_rest = dc.contiguous(), sh_rest.contiguous()
    if active is not None:
        active = active.contiguous()
    return _k5(xyz, scale, quat, opacity, camera, dc, sh_rest, sh_degree, active, no_color,
               raw)


def preprocess_backward(xyz, scale, quat, opacity, camera, dc, sh_rest, sh_degree, d_attrs,
                        raw=False):
    """K6: the six gradients for the rows' gradient d_attrs (P, 9) (CPU
    tensors: `preprocess_backward_plain`); with `raw`, of the stored
    log_scale, quat and opa_logit."""
    if xyz.device.type == "cpu":
        return preprocess_backward_plain(xyz, scale, quat, opacity, camera, dc, sh_rest,
                                         sh_degree, d_attrs, raw)
    if xyz.device.type != "cuda":
        raise ValueError(f"the preprocess takes CPU or CUDA tensors, got {xyz.device}")
    xyz, scale, quat, opacity, dc, sh_rest = (
        t.contiguous() for t in (xyz, scale, quat, opacity, dc, sh_rest))
    return _k6(xyz, scale, quat, camera, dc, sh_rest, sh_degree, d_attrs, opacity=opacity,
               raw=raw)


def preprocess_backward_probe(variant, xyz, scale, quat, opacity, camera, dc, sh_rest,
                              sh_degree, d_attrs, raw=False):
    """K6's timing variant `variant` (K6_VARIANTS), with preprocess_backward's
    arguments and outputs. CPU tensors: `preprocess_backward_plain` for the
    variants that compute K6's outputs; the timing-only ones have no plain
    version and raise."""
    if variant not in K6_VARIANTS:
        raise ValueError(f"unknown K6 variant {variant!r}; one of {K6_VARIANTS}")
    if xyz.device.type == "cpu":
        if variant in K6_TIMING_ONLY:
            raise ValueError(f"K6 {variant} is a timing probe of the card: it has no plain "
                             "version")
        return preprocess_backward_plain(xyz, scale, quat, opacity, camera, dc, sh_rest,
                                         sh_degree, d_attrs, raw)
    if xyz.device.type != "cuda":
        raise ValueError(f"the preprocess takes CPU or CUDA tensors, got {xyz.device}")
    xyz, scale, quat, opacity, dc, sh_rest = (
        t.contiguous() for t in (xyz, scale, quat, opacity, dc, sh_rest))
    return _k6(xyz, scale, quat, camera, dc, sh_rest, sh_degree, d_attrs, variant, opacity,
               raw)


class Preprocess(torch.autograd.Function):
    """(xyz, scale, quat, opacity, dc, sh_rest) -> (table, attrs, depth,
    radius, base_active, the activated opacity), differentiable through
    `attrs`; with `raw`, scale, quat and opacity are the stored log_scale,
    quat and opa_logit. On CUDA tensors the forward is K5 and the backward
    K6; on CPU tensors the forward is the plain chain, recorded on detached
    copies of the inputs, and the backward is autograd's over that record
    (the same floats as autograd of the chain itself)."""

    @staticmethod
    def forward(ctx, xyz, scale, quat, opacity, dc, sh_rest, camera, sh_degree, active, raw):
        P = xyz.shape[0]
        ctx.camera, ctx.sh_degree, ctx.raw, ctx.record = camera, sh_degree, raw, None
        if xyz.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need) for t, need in
                          zip((xyz, scale, quat, opacity, dc, sh_rest), ctx.needs_input_grad)]
                p = preprocess_forward_plain(*leaves[:4], camera, leaves[4], leaves[5],
                                             sh_degree, active, raw=raw)
            ctx.record = (p["rows"], leaves)
            table, depth, radius, base_active, opa = (
                p[k] for k in ("table", "depth", "radius", "base_active", "opacity"))
        else:
            table, depth, radius, base_active, opa = preprocess_forward(
                xyz, scale, quat, opacity, camera, dc, sh_rest, sh_degree, active, raw=raw)
            ctx.save_for_backward(xyz, scale, quat, opacity, dc, sh_rest)
        opa = opa if raw else opa.detach()   # the activated form hands back its input
        attrs = table.new_zeros(()).expand(P, N_ATTR)
        ctx.mark_non_differentiable(table, depth, radius, base_active, opa)
        return table, attrs, depth, radius, base_active, opa

    @staticmethod
    def backward(ctx, _d_table, d_attrs, _d_depth, _d_radius, _d_base_active, _d_opa):
        none = (None,) * 4
        if ctx.record is None:
            xyz, scale, quat, opacity, dc, sh_rest = ctx.saved_tensors
            return preprocess_backward(xyz, scale, quat, opacity, ctx.camera, dc, sh_rest,
                                       ctx.sh_degree, d_attrs, ctx.raw) + none
        rows, leaves = ctx.record
        need = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(rows, need, F.pad(d_attrs, (0, SPLAT_ROWS - N_ATTR)),
                                       allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in leaves) + none


def preprocess(xyz, scale, quat, opacity, camera, dc=None, sh_rest=None, sh_degree=3,
               active=None, no_color=False, colors=None, raw=False) -> Splats:
    """K5 with K6 as its backward (`Preprocess`) where a gradient is wanted,
    else K5 alone (always with `no_color`, the alpha-only pass). With
    `raw`, scale, quat and opacity are the map's stored log_scale, quat and
    opa_logit, and the gradients are theirs. Given `colors` in place of SH,
    the plain chain on every device: `attrs` is then its differentiable
    (P, 16) rows."""
    P = xyz.shape[0]
    inputs = (xyz, scale, quat, opacity, dc, sh_rest)
    if colors is not None:
        p = preprocess_forward_plain(xyz, scale, quat, opacity, camera, active=active,
                                     colors=colors, raw=raw)
        table, attrs, depth, radius, base_active, opa = (
            p[k] for k in ("table", "rows", "depth", "radius", "base_active", "opacity"))
    elif no_color or not (torch.is_grad_enabled()
                          and any(t is not None and t.requires_grad for t in inputs)):
        table, depth, radius, base_active, opa = preprocess_forward(
            xyz.detach(), scale.detach(), quat.detach(), opacity.detach(), camera,
            None if no_color else dc.detach(), None if no_color else sh_rest.detach(),
            sh_degree, active, no_color, raw)
        attrs = table.new_zeros(()).expand(P, N_ATTR)
    else:
        table, attrs, depth, radius, base_active, opa = Preprocess.apply(
            xyz, scale, quat, opacity, dc, sh_rest, camera, sh_degree, active, raw)
    return Splats(table, attrs, table[:P, 0:2], table[:P, 2:5], depth, radius, base_active,
                  opa)
