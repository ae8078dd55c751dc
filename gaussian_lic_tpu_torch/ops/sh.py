"""Real spherical harmonics color evaluation (degrees 0..3).

Parity with computeColorFromSH (forward.cu:29-77) and the SH constants
(auxiliary.h:22-39). Color layout matches the reference model: a DC term (n,3) stored
separately from 15 rest coefficients (n,15,3) (gaussian.h / gaussian.cpp:277-282).

RGB2SH / SH2RGB follow gaussian.h:46-48: sh = (rgb − 0.5)/C0.

Differentiable by torch autograd; the clamp at 0 (forward.cu:73-76) is expressed
with torch.clamp_min, so autograd reproduces the reference's clamped-gradient
masking (backward.cu's `clamped` logic).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """(rgb − 0.5) / C0  (gaussian.h:46)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * SH_C0 + 0.5


def eval_sh_color(
    deg: int,
    dc: torch.Tensor,       # (..., 3)
    sh_rest: torch.Tensor,  # (..., M-1, 3) with M = (deg_max+1)^2; 15 for deg_max=3
    dirs: torch.Tensor,     # (..., 3) unnormalized view directions (mean − campos)
) -> torch.Tensor:
    """Evaluate view-dependent RGB, clamped at 0 (forward.cu:29-77).

    `deg` is the *active* degree (static); sh_rest may carry more coefficients than
    the active degree uses — extras are ignored, as in the reference where
    sh_degree gates the polynomial order.
    """
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    result = SH_C0 * dc
    if deg > 0:
        x = d[..., 0:1]
        y = d[..., 1:2]
        z = d[..., 2:3]
        result = (
            result
            - SH_C1 * y * sh_rest[..., 0, :]
            + SH_C1 * z * sh_rest[..., 1, :]
            - SH_C1 * x * sh_rest[..., 2, :]
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh_rest[..., 3, :]
                + SH_C2[1] * yz * sh_rest[..., 4, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh_rest[..., 5, :]
                + SH_C2[3] * xz * sh_rest[..., 6, :]
                + SH_C2[4] * (xx - yy) * sh_rest[..., 7, :]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh_rest[..., 8, :]
                    + SH_C3[1] * xy * z * sh_rest[..., 9, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh_rest[..., 10, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh_rest[..., 11, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh_rest[..., 12, :]
                    + SH_C3[5] * z * (xx - yy) * sh_rest[..., 13, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh_rest[..., 14, :]
                )
    result = result + 0.5
    return torch.clamp_min(result, 0.0)
