"""Per-Gaussian geometry: projection, 3D covariance, EWA 2D covariance, conic, radius.

The preprocess stage of the CUDA rasterizer (forward.cu:232-319, helpers
forward.cu:79-149, auxiliary.h:41-56,149-171), the same arithmetic in the same
order as the JAX package's `ops/projection.py`:

  * frustum cull at p_view.z > 0.2            (in_frustum, auxiliary.h:160)
  * p_w = 1 / (p_hom.w + 1e-7)                (forward.cu:280)
  * cov3D = R diag(s^2) R^T from normalized quat
  * EWA cov2D with frustum-clamped Jacobian + 0.3 dilation
  * conic = inverse 2x2; radius = ceil(3*sqrt(l1)), l1 = mid + sqrt(max(0.1, mid^2-det))
  * pix = ((ndc+1)*S - 1)/2                   (auxiliary.h:41-44)

Every contraction is written out as (P,) component arithmetic, so it runs in
true float32 on any device and torch autograd supplies the backward
(backward.cu:138-310 in the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_lic_tpu_torch.camera import Camera

FRUSTUM_NEAR = 0.2        # auxiliary.h:160
COV2D_DILATION = 0.3      # forward.cu:115-116
OPACITY_THRESHOLD = 1.0 / 255.0  # forward.h OPACITY_THRESHOLD


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion (w,x,y,z) -> rotation matrix (...,3,3), Hamilton
    convention (computeCov3D's R, forward.cu:133-137)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q.unbind(-1)
    R = torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
            2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
            2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def build_cov3d(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T as full (...,3,3) (computeCov3D, forward.cu:120-149).
    `scale` is the activated (exp'd) scale; `quat` need not be normalized."""
    R = quat_to_rotmat(quat)
    RS = R * scale[..., None, :]  # R @ diag(s)
    return (RS.unsqueeze(-2) * RS.unsqueeze(-3)).sum(-1)  # RS @ RS^T in f32


class ProjectionResult(NamedTuple):
    """Per-Gaussian screen-space quantities. All (P,...) float32 unless noted."""

    in_front: torch.Tensor   # (P,) bool — passed near-plane cull
    depth: torch.Tensor      # (P,) view-space z
    xy: torch.Tensor         # (P,2) pixel-space mean
    cov2d: torch.Tensor      # (P,3) packed (a, b, c) of [[a,b],[b,c]], dilated
    conic: torch.Tensor      # (P,3) packed inverse (A, B, C)
    radius: torch.Tensor     # (P,) float radius in pixels (ceil'd), 0 where culled
    det_valid: torch.Tensor  # (P,) bool — 2D covariance invertible


def _affine3(x, y, z, M: torch.Tensor, row: int, t) -> torch.Tensor:
    """Row `row` of xyz @ M^T + t, in the order of an f32 dot product."""
    return x * M[row, 0] + y * M[row, 1] + z * M[row, 2] + t


def project_gaussians(
    xyz: torch.Tensor,        # (P,3) world means
    scale: torch.Tensor,      # (P,3) activated scales
    quat: torch.Tensor,       # (P,4) rotations (normalized inside)
    camera: Camera,
) -> ProjectionResult:
    """Vectorized preprocess geometry (forward.cu:232-305, minus SH/culling counts)."""
    intr = camera.intr
    R_cw = camera.pose.R_cw
    t_cw = camera.pose.t_cw
    fp = camera.full_proj
    X, Y, Z = xyz.unbind(-1)

    # world -> view (transformPoint4x3)
    pvx = _affine3(X, Y, Z, R_cw, 0, t_cw[0])
    pvy = _affine3(X, Y, Z, R_cw, 1, t_cw[1])
    depth = _affine3(X, Y, Z, R_cw, 2, t_cw[2])
    in_front = depth > FRUSTUM_NEAR

    # world -> clip -> ndc -> pixels (forward.cu:278-281, auxiliary.h:41)
    phx = _affine3(X, Y, Z, fp, 0, fp[0, 3])
    phy = _affine3(X, Y, Z, fp, 1, fp[1, 3])
    pw = _affine3(X, Y, Z, fp, 3, fp[3, 3])
    inv_w = 1.0 / (pw + 1e-7)
    W = float(intr.width)
    H = float(intr.height)
    xy = torch.stack(
        [
            ((phx * inv_w + 1.0) * W - 1.0) * 0.5,
            ((phy * inv_w + 1.0) * H - 1.0) * 0.5,
        ],
        dim=-1,
    )

    # EWA: clamp the Jacobian evaluation point (forward.cu:91-94)
    tz = torch.where(depth.abs() > 1e-8, depth, torch.full_like(depth, 1e-8))
    tx = torch.clamp(pvx / tz, intr.limx_neg, intr.limx_pos) * tz
    ty = torch.clamp(pvy / tz, intr.limy_neg, intr.limy_pos) * tz

    # J = [[fx/tz, 0, -fx*tx/tz^2], [0, fy/tz, -fy*ty/tz^2]]  (forward.cu:96-99)
    fx = float(intr.fx)
    fy = float(intr.fy)
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    J00 = fx * inv_tz
    J11 = fy * inv_tz
    J02 = -fx * tx * inv_tz2
    J12 = -fy * ty * inv_tz2
    m00 = J00 * R_cw[0, 0] + J02 * R_cw[2, 0]
    m01 = J00 * R_cw[0, 1] + J02 * R_cw[2, 1]
    m02 = J00 * R_cw[0, 2] + J02 * R_cw[2, 2]
    m10 = J11 * R_cw[1, 0] + J12 * R_cw[2, 0]
    m11 = J11 * R_cw[1, 1] + J12 * R_cw[2, 1]
    m12 = J11 * R_cw[1, 2] + J12 * R_cw[2, 2]

    # Sigma = R diag(s^2) R^T, six unique entries as (P,) tensors
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
    s2_ = scale[..., 2] * scale[..., 2]
    S00 = s0 * R00 * R00 + s1 * R01 * R01 + s2_ * R02 * R02
    S01 = s0 * R00 * R10 + s1 * R01 * R11 + s2_ * R02 * R12
    S02 = s0 * R00 * R20 + s1 * R01 * R21 + s2_ * R02 * R22
    S11 = s0 * R10 * R10 + s1 * R11 * R11 + s2_ * R12 * R12
    S12 = s0 * R10 * R20 + s1 * R11 * R21 + s2_ * R12 * R22
    S22 = s0 * R20 * R20 + s1 * R21 * R21 + s2_ * R22 * R22

    # cov2D = M Sigma M^T (quadratic forms, expanded)
    t0 = S00 * m00 + S01 * m01 + S02 * m02
    t1 = S01 * m00 + S11 * m01 + S12 * m02
    t2 = S02 * m00 + S12 * m01 + S22 * m02
    a = m00 * t0 + m01 * t1 + m02 * t2 + COV2D_DILATION
    b = m10 * t0 + m11 * t1 + m12 * t2
    u0 = S00 * m10 + S01 * m11 + S02 * m12
    u1 = S01 * m10 + S11 * m11 + S12 * m12
    u2 = S02 * m10 + S12 * m11 + S22 * m12
    c = m10 * u0 + m11 * u1 + m12 * u2 + COV2D_DILATION
    cov2d = torch.stack([a, b, c], dim=-1)

    det = a * c - b * b
    det_valid = det != 0.0  # forward.cu:288
    safe_det = torch.where(det_valid, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # radius (forward.cu:296-298)
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))
    radius = torch.where(in_front & det_valid, radius, torch.zeros_like(radius))

    return ProjectionResult(
        in_front=in_front,
        depth=depth,
        xy=xy,
        cov2d=cov2d,
        conic=conic,
        radius=radius,
        det_valid=det_valid,
    )


def max_contrib_power_rect(
    conic: torch.Tensor,    # (..., 3) packed (A, B, C)
    xy: torch.Tensor,       # (..., 2) Gaussian pixel center
    rect_min: torch.Tensor, # (..., 2) tile pixel min (inclusive)
    rect_max: torch.Tensor, # (..., 2) tile pixel max (inclusive)
) -> torch.Tensor:
    """StopThePop exact tile culling on stacked inputs — see
    max_contrib_power_rect_components."""
    return max_contrib_power_rect_components(
        conic[..., 0], conic[..., 1], conic[..., 2],
        xy[..., 0], xy[..., 1],
        rect_min[..., 0], rect_min[..., 1],
        rect_max[..., 0], rect_max[..., 1],
    )


def max_contrib_power_rect_components(
    A, B, C,               # conic components, any broadcastable shape
    mx, my,                # Gaussian pixel center
    rminx, rminy,          # tile pixel min (inclusive)
    rmaxx, rmaxy,          # tile pixel max (inclusive)
) -> torch.Tensor:
    """StopThePop exact tile culling: the minimum of the Gaussian power
    q(d) = 0.5(A dx^2 + C dy^2) + B dx dy over a pixel rect
    (max_contrib_power_rect_gaussian_float, forward.h:39-80). A tile
    contributes iff this min-power <= log(opacity/THRESHOLD). Returns 0 when
    the center lies inside the rect."""
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

    dx = torch.where(x_min_diff >= 0, size_x, -size_x)  # copysign(size, diff)
    dy = torch.where(y_min_diff >= 0, size_y, -size_y)

    diffx = mx - px
    diffy = my - py

    eps = 1e-12
    rcp_dxdxA = 1.0 / (size_x * size_x * A + eps)
    rcp_dydyC = 1.0 / (size_y * size_y * C + eps)

    tx = not_in_y * torch.clamp((dx * A * diffx + dx * B * diffy) * rcp_dxdxA, 0.0, 1.0)
    ty = not_in_x * torch.clamp((dy * B * diffx + dy * C * diffy) * rcp_dydyC, 0.0, 1.0)
    qx = px + tx * dx
    qy = py + ty * dy

    ddx = mx - qx
    ddy = my - qy
    power = 0.5 * (A * ddx * ddx + C * ddy * ddy) + B * ddx * ddy
    outside = (not_in_x + not_in_y) > 0.0
    return torch.where(outside, power, torch.zeros_like(power))
