"""Camera model: pinhole intrinsics + pose -> view/projection transforms.

Same semantics as the JAX package's `camera.py` (reference: src/camera.h), in
column-vector convention:

  p_view  = R_cw @ p + t_cw                     (world -> camera)
  p_clip  = P @ [p_view, 1]                     (off-center pinhole projection)
  ndc     = p_clip[:3] / (p_clip[3] + 1e-7)
  pix     = ((ndc + 1) * S - 1) / 2

The 3x3/4x4 contractions are written as elementwise products and sums, so
they run in true float32 whatever `torch.backends.cuda.matmul.allow_tf32` says.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from gaussian_lic_tpu_torch.utils import trace

ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclass(frozen=True)
class Intrinsics:
    """Static per-rig camera intrinsics (camera.h:38-50)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    znear: float = 0.01   # camera.h:127
    zfar: float = 100.0   # camera.h:126

    @property
    def fov_x(self) -> float:
        return 2.0 * math.atan(self.width / (2.0 * self.fx))

    @property
    def fov_y(self) -> float:
        return 2.0 * math.atan(self.height / (2.0 * self.fy))

    @property
    def tan_fov_x(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fov_y(self) -> float:
        return self.height / (2.0 * self.fy)

    # Frustum clamp limits (camera.h:63-66).
    @property
    def limx_neg(self) -> float:
        return -0.15 * self.width / self.fx - self.cx / self.fx

    @property
    def limx_pos(self) -> float:
        return 1.15 * self.width / self.fx - self.cx / self.fx

    @property
    def limy_neg(self) -> float:
        return -0.15 * self.height / self.fy - self.cy / self.fy

    @property
    def limy_pos(self) -> float:
        return 1.15 * self.height / self.fy - self.cy / self.fy

    def projection_matrix(self) -> np.ndarray:
        """Off-center perspective projection P (4,4), column-vector convention
        (camera.h:89-110 stores its transpose)."""
        W, H = float(self.width), float(self.height)
        P = np.zeros((4, 4), dtype=np.float32)
        P[0, 0] = 1.0 / self.tan_fov_x
        P[1, 1] = 1.0 / self.tan_fov_y
        P[0, 2] = (2.0 * self.cx - W) / W
        P[1, 2] = (2.0 * self.cy - H) / H
        P[3, 2] = 1.0
        P[2, 2] = self.zfar / (self.zfar - self.znear)
        P[2, 3] = -(self.zfar * self.znear) / (self.zfar - self.znear)
        return P


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, m) @ (..., m) as an f32 elementwise product and sum."""
    return (M * v.unsqueeze(-2)).sum(-1)


@dataclass
class CameraPose:
    """World->camera pose tensors: R_cw (..., 3, 3), t_cw (..., 3)."""

    R_cw: torch.Tensor
    t_cw: torch.Tensor

    @property
    def cam_center(self) -> torch.Tensor:
        """Camera position in the world frame (camera.h:61): -R_cw^T t_cw."""
        return -matvec(self.R_cw.transpose(-1, -2), self.t_cw)

    def view_matrix(self) -> torch.Tensor:
        """(..., 4, 4) world->camera homogeneous transform."""
        batch = self.t_cw.shape[:-1]
        V = torch.zeros(batch + (4, 4), dtype=self.R_cw.dtype, device=self.R_cw.device)
        V[..., :3, :3] = self.R_cw
        V[..., :3, 3] = self.t_cw
        # a Python scalar stored into a CUDA tensor is a pageable copy that
        # waits for the stream
        trace.sync("upload", V.__setitem__, (..., 3, 3), 1.0)
        return V


@dataclass
class Camera:
    """A render-ready camera: static intrinsics + pose + full projection P @ V."""

    intr: Intrinsics
    pose: CameraPose
    full_proj: torch.Tensor  # (..., 4, 4)

    @property
    def cam_center(self) -> torch.Tensor:
        return self.pose.cam_center

    @property
    def device(self) -> torch.device:
        return self.full_proj.device


def make_camera(
    intr: Intrinsics,
    R_wc: ArrayLike,
    t_wc: ArrayLike,
    device: Union[str, torch.device, None] = None,
) -> Camera:
    """Build a Camera from a world-from-camera pose (gaussian.cpp:52-57):
    R_cw = R_wc^T, t_cw = -R_wc^T t_wc. `device` defaults to the device of a
    tensor `R_wc`, else the CPU."""
    if device is None:
        device = R_wc.device if isinstance(R_wc, torch.Tensor) else "cpu"
    R_wc = trace.upload(R_wc, dtype=torch.float32, device=device)
    t_wc = trace.upload(t_wc, dtype=torch.float32, device=device)
    R_cw = R_wc.transpose(-1, -2).contiguous()
    t_cw = -matvec(R_cw, t_wc)
    pose = CameraPose(R_cw=R_cw, t_cw=t_cw)
    P = trace.upload(intr.projection_matrix(), device=device)
    V = pose.view_matrix()
    # P @ V with the batch on V
    full_proj = (P.unsqueeze(-1) * V.unsqueeze(-3)).sum(-2)
    return Camera(intr=intr, pose=pose, full_proj=full_proj)


def look_at(
    eye: np.ndarray, target: np.ndarray, up: np.ndarray = (0.0, 0.0, 1.0)
) -> Tuple[np.ndarray, np.ndarray]:
    """World-from-camera (R_wc, t_wc) with the +z camera axis pointing at
    `target` (OpenCV convention: x right, y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    n = np.linalg.norm(x)
    if n < 1e-8:  # degenerate: view parallel to up
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
        n = np.linalg.norm(x)
    x = x / n
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=1)  # columns are camera axes in world frame
    return R_wc.astype(np.float32), eye.astype(np.float32)
