"""GaussianMap: the learnable map state (reference gaussian.{h,cpp}).

As in the JAX package's `models/gaussians.py`, the map is a set of
fixed-capacity padded tensors plus an active `count`: appending Gaussians is
a masked write into the padding, optimizer moments need no splicing (the
padding holds zeros until first use), and capacity doubles only when full.

Parameters and activations (gaussian.h:103-186, gaussian.cpp:147-175):
  xyz (C,3) | dc (C,3) | sh_rest (C,15,3) | log_scale (C,3) | quat wxyz (C,4)
  | opa_logit (C,) ; scaling = exp, rotation = normalize, opacity = sigmoid.
  Exposure (3,4) is carried and applied by the renderer when `apply_exposure`.

Initialization (gaussian.cpp:212-304): color -> SH DC via (c-0.5)/C0; scale =
log(scaling_scale * depth / focal) with focal = (fx+fy)/2; identity quats;
opacity logit of 0.1. Skybox (`skybox_points_num > 0`): points on a far
hemisphere (radius x 10, theta ~ U[0, 2pi), phi = acos(1 - 1.4u)), DC color
(0.7, 0.8, 0.95), opacity 0.7, scales from the 3-NN mean distance (ops.knn).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from gaussian_lic_tpu_torch.ops import sh as sh_ops
from gaussian_lic_tpu_torch.ops.knn import mean_knn_dist2
from gaussian_lic_tpu_torch.ops.projection import build_cov3d

Device = Union[str, torch.device]


class LearningRates(NamedTuple):
    """Per-group LRs (trainingSetup, gaussian.cpp:399-424)."""

    xyz: float
    dc: float
    sh_rest: float  # feature_lr / 20
    opacity: float
    log_scale: float
    quat: float

    @classmethod
    def from_params(cls, p) -> "LearningRates":
        return cls(
            xyz=p.position_lr,
            dc=p.feature_lr,
            sh_rest=p.feature_lr / 20.0,
            opacity=p.opacity_lr,
            log_scale=p.scaling_lr,
            quat=p.rotation_lr,
        )


def _inverse_sigmoid_scalar(x: float) -> float:
    return float(np.log(x / (1.0 - x)))


OPA_LOGIT_INIT = _inverse_sigmoid_scalar(0.1)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """general_utils::inverse_sigmoid: log(x / (1 - x))."""
    return torch.log(x / (1.0 - x))


def _identity_quats(n: int, device: Device) -> torch.Tensor:
    q = torch.zeros((n, 4), dtype=torch.float32, device=device)
    q[:, 0] = 1.0
    return q


@dataclass
class GaussianMap:
    """Padded-capacity Gaussian map. All tensors share leading dim = capacity."""

    xyz: torch.Tensor        # (C, 3)
    dc: torch.Tensor         # (C, 3)
    sh_rest: torch.Tensor    # (C, S, 3), S = (deg+1)^2-1
    log_scale: torch.Tensor  # (C, 3)
    quat: torch.Tensor       # (C, 4) wxyz
    opa_logit: torch.Tensor  # (C,)
    count: torch.Tensor      # () int32 — number of active Gaussians
    exposure: torch.Tensor   # (3, 4) affine color correction
    sh_degree: int = 3
    skybox_count: int = 0

    def replace(self, **kw) -> "GaussianMap":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ----- capacity / masks -----

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def active_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.count

    # ----- activations (gaussian.cpp:147-175) -----

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.log_scale)

    @property
    def rotation(self) -> torch.Tensor:
        return self.quat / (torch.linalg.norm(self.quat, dim=-1, keepdim=True) + 1e-12)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opa_logit)

    def covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """Full (C,3,3) Sigma = R diag((m s)^2) R^T (getCovariance, gaussian.cpp:177-205)."""
        return build_cov3d(scaling_modifier * self.scaling, self.rotation)

    # ----- parameter dict for the optimizer -----

    def trainable(self) -> dict:
        return {
            "xyz": self.xyz,
            "dc": self.dc,
            "sh_rest": self.sh_rest,
            "opacity": self.opa_logit,
            "log_scale": self.log_scale,
            "quat": self.quat,
        }

    def with_trainable(self, t: dict) -> "GaussianMap":
        return self.replace(
            xyz=t["xyz"],
            dc=t["dc"],
            sh_rest=t["sh_rest"],
            opa_logit=t["opacity"],
            log_scale=t["log_scale"],
            quat=t["quat"],
        )

    # ----- construction -----

    @classmethod
    def empty(cls, capacity: int, sh_degree: int = 3, skybox_count: int = 0,
              device: Device = "cpu") -> "GaussianMap":
        S = (sh_degree + 1) ** 2 - 1
        z = dict(dtype=torch.float32, device=device)
        exposure = torch.cat([torch.eye(3, **z), torch.zeros((3, 1), **z)], dim=1)
        return cls(
            xyz=torch.zeros((capacity, 3), **z),
            dc=torch.zeros((capacity, 3), **z),
            sh_rest=torch.zeros((capacity, S, 3), **z),
            log_scale=torch.zeros((capacity, 3), **z),
            quat=_identity_quats(capacity, device),
            opa_logit=torch.full((capacity,), OPA_LOGIT_INIT, **z),
            count=torch.zeros((), dtype=torch.int32, device=device),
            exposure=exposure,
            sh_degree=sh_degree,
            skybox_count=skybox_count,
        )

    def grow(self, new_capacity: int) -> "GaussianMap":
        """Capacity growth: repad with zeros/defaults (the reference instead
        concatenates tensors every keyframe, gaussian.cpp:456)."""
        if new_capacity < self.capacity:
            raise ValueError(f"cannot shrink {self.capacity} -> {new_capacity}")
        extra = new_capacity - self.capacity
        if extra == 0:
            return self

        def pad(x, fill=0.0):
            block = torch.full((extra,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
            return torch.cat([x, block], dim=0)

        return self.replace(
            xyz=pad(self.xyz),
            dc=pad(self.dc),
            sh_rest=pad(self.sh_rest),
            log_scale=pad(self.log_scale),
            quat=torch.cat([self.quat, _identity_quats(extra, self.device)], dim=0),
            opa_logit=pad(self.opa_logit, OPA_LOGIT_INIT),
        )


def point_attributes(
    points: torch.Tensor,   # (N,3) world positions
    colors: torch.Tensor,   # (N,3) RGB in [0,1]
    depths: torch.Tensor,   # (N,) camera-frame depth at observation time
    focal: float,           # (fx+fy)/2  (gaussian.cpp:222)
    scaling_scale: float,
    sh_rest_dim: int,
) -> Tuple[torch.Tensor, ...]:
    """LiDAR point -> Gaussian parameters, shared by init and densification
    (gaussian.cpp:227-240 and 612-627): DC from color, scale = log(s*d/f),
    identity rotation, opacity logit of 0.1."""
    n = points.shape[0]
    dev = points.device
    dc = sh_ops.rgb_to_sh(colors)
    sh_rest = torch.zeros((n, sh_rest_dim, 3), dtype=torch.float32, device=dev)
    log_scale = torch.log(
        torch.clamp_min(scaling_scale * depths / focal, 1e-10)
    )[:, None].repeat(1, 3)
    quat = _identity_quats(n, dev)
    opa = torch.full((n,), OPA_LOGIT_INIT, dtype=torch.float32, device=dev)
    return points, dc, sh_rest, log_scale, quat, opa


def skybox_uniforms(num: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The skybox's two (num,) U[0, 1) draws, from a CPU `generator`. The JAX
    package draws them with jax.random, which torch cannot reproduce; tests
    substitute its draws here."""
    u1 = torch.rand(num, generator=generator, dtype=torch.float32)
    u2 = torch.rand(num, generator=generator, dtype=torch.float32)
    return u1, u2


def make_skybox(
    num: int,
    radius: float,
    seed: int = 0,
    device: Device = "cpu",
) -> Tuple[torch.Tensor, ...]:
    """Skybox Gaussians on a far hemisphere (gaussian.cpp:243-273).

    Positions at radius x 10 with phi = acos(1 - 1.4u) (dips ~23 degrees below
    the horizon), sky-blue DC (0.7, 0.8, 0.95), opacity 0.7, isotropic scales
    from the mean distance to the 3 nearest neighbours (distCUDA2 -> ops.knn).
    The uniforms come from a CPU generator seeded with `seed` and the
    positions are computed on the CPU too, so a run on the card and one on
    the CPU start from the same skybox: the card's cos/sin/acos differ from
    the CPU's in the last bits, enough to move a point across a Morton cell
    and change its kNN candidates."""
    u1, u2 = skybox_uniforms(num, torch.Generator(device="cpu").manual_seed(seed))
    theta = (2.0 * math.pi) * u1
    phi = torch.acos(1.0 - 1.4 * u2)
    r = radius * 10.0
    xyz = torch.stack(
        [r * torch.cos(theta) * torch.sin(phi), r * torch.sin(theta) * torch.sin(phi),
         r * torch.cos(phi)],
        dim=1,
    ).to(device)
    rgb = torch.tensor([[0.7, 0.8, 0.95]], dtype=torch.float32, device=device).repeat(num, 1)
    dc = sh_ops.rgb_to_sh(rgb)
    dist2 = torch.clamp_min(mean_knn_dist2(xyz), 1e-7)  # gaussian.cpp:261
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    quat = _identity_quats(num, device)
    opa = torch.full((num,), _inverse_sigmoid_scalar(0.7), dtype=torch.float32, device=device)
    return xyz, dc, log_scale, quat, opa


def initialize_map(
    points: np.ndarray,
    colors: np.ndarray,
    depths: np.ndarray,
    *,
    focal: float,
    scaling_scale: float = 1.0,
    sh_degree: int = 3,
    capacity: int = 1 << 18,
    skybox_points_num: int = 0,
    skybox_radius: float = 1000.0,
    seed: int = 0,
    device: Device = "cpu",
) -> GaussianMap:
    """First-keyframe map initialization (GaussianModel::initialize,
    gaussian.cpp:212-304): the skybox Gaussians first (so that export can
    slice them off, gaussian.cpp:310-316), then all accumulated LiDAR points."""
    n_sky = skybox_points_num
    n_total = points.shape[0] + n_sky
    while capacity < n_total:
        capacity *= 2
    S = (sh_degree + 1) ** 2 - 1
    gm = GaussianMap.empty(capacity, sh_degree, skybox_count=n_sky, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    xyz, dc, sh_rest, ls, q, o = point_attributes(
        torch.as_tensor(points, **f32),
        torch.as_tensor(colors, **f32),
        torch.as_tensor(depths, **f32),
        focal,
        scaling_scale,
        S,
    )
    if n_sky > 0:
        sky_xyz, sky_dc, sky_ls, sky_q, sky_o = make_skybox(n_sky, skybox_radius, seed, device)
        xyz, dc, ls, q, o = (torch.cat(p) for p in ((sky_xyz, xyz), (sky_dc, dc), (sky_ls, ls),
                                                     (sky_q, q), (sky_o, o)))
        sh_rest = torch.cat([sh_rest.new_zeros((n_sky,) + sh_rest.shape[1:]), sh_rest])
    for field, val in (("xyz", xyz), ("dc", dc), ("sh_rest", sh_rest),
                       ("log_scale", ls), ("quat", q), ("opa_logit", o)):
        getattr(gm, field)[:n_total] = val
    gm.count = torch.tensor(n_total, dtype=torch.int32, device=device)
    return gm


def append_gaussians(
    gm: GaussianMap,
    xyz: torch.Tensor,       # (M, 3) candidate positions (padded)
    dc: torch.Tensor,        # (M, 3)
    log_scale: torch.Tensor, # (M, 3)
    opa_logit: torch.Tensor, # (M,)
    valid: torch.Tensor,     # (M,) bool — which candidates to append
) -> GaussianMap:
    """Masked append into the padding (replaces densificationPostfix,
    gaussian.cpp:426-497): the valid candidates, in order, go to slots
    count, count+1, ...; those past capacity are dropped. Returns a map with
    new tensors and the count advanced; `gm` is left as it was."""
    M = xyz.shape[0]
    offs = torch.cumsum(valid.to(torch.int64), 0) - 1          # position among valid
    dest = gm.count.to(torch.int64) + offs
    keep = valid & (dest < gm.capacity)
    # dropped candidates write to a scratch row at index `capacity`
    dest = torch.where(keep, dest, torch.full_like(dest, gm.capacity))
    n_new = valid.sum(dtype=torch.int32)

    def put(table, rows):
        out = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
        out.index_copy_(0, dest, rows)
        return out[:-1]

    quat_new = _identity_quats(M, gm.device)
    sh_new = torch.zeros((M,) + gm.sh_rest.shape[1:], dtype=torch.float32, device=gm.device)
    return gm.replace(
        xyz=put(gm.xyz, xyz),
        dc=put(gm.dc, dc),
        sh_rest=put(gm.sh_rest, sh_new),
        log_scale=put(gm.log_scale, log_scale),
        quat=put(gm.quat, quat_new),
        opa_logit=put(gm.opa_logit, opa_logit),
        count=torch.clamp_max(gm.count + n_new, gm.capacity).to(torch.int32),
    )
