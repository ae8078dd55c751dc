"""Frame ingestion and keyframe storage (reference C4: Dataset, gaussian.cpp:41-111).

Train keyframes live in a fixed-capacity device-side `KeyframeBuffer` of
stacked poses and uint8 images, so a train step takes its GT image on the
device with no host traffic. Test (non-keyframe) cameras stay on the host.
LiDAR points accumulate on the host between keyframes and are consumed by map
initialization / densification, which clear them (gaussian.cpp:301-303,
635-637). `FrameInput`, `TestCamera` and `PointAccumulator` hold only numpy
arrays and are the same as the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Union

import numpy as np
import torch

from gaussian_lic_tpu_torch.camera import Camera, CameraPose, Intrinsics, make_camera

Device = Union[str, torch.device]


@dataclass
class FrameInput:
    """One aligned (points, pose, image) triplet from the odometry front-end."""

    timestamp: float
    R_wc: np.ndarray          # (3,3) world-from-camera rotation
    t_wc: np.ndarray          # (3,)
    image: np.ndarray         # (H,W,3) uint8 RGB or float [0,1]
    points: np.ndarray        # (N,3) world-frame LiDAR points
    colors: np.ndarray        # (N,3) RGB in [0,1]

    def image_u8(self) -> np.ndarray:
        img = self.image
        if img.dtype == np.uint8:
            return img
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)


@dataclass
class TestCamera:
    """Held-out (non-keyframe) view for in-sequence novel-view eval."""

    name: str
    R_wc: np.ndarray
    t_wc: np.ndarray
    image_u8: np.ndarray      # (H,W,3)


@dataclass
class KeyframeBuffer:
    """Device-side stacked train cameras. Fixed capacity F; the host tracks count."""

    R_cw: torch.Tensor       # (F,3,3)
    t_cw: torch.Tensor       # (F,3)
    full_proj: torch.Tensor  # (F,4,4)
    images: torch.Tensor     # (F,3,H,W) uint8

    @classmethod
    def empty(cls, capacity: int, intr: Intrinsics, device: Device = "cpu") -> "KeyframeBuffer":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            R_cw=torch.zeros((capacity, 3, 3), **f32),
            t_cw=torch.zeros((capacity, 3), **f32),
            full_proj=torch.zeros((capacity, 4, 4), **f32),
            images=torch.zeros((capacity, 3, intr.height, intr.width),
                               dtype=torch.uint8, device=device),
        )

    def set_frame(self, idx: int, cam: Camera, image_u8: np.ndarray) -> "KeyframeBuffer":
        """Write keyframe `idx` in place; returns self."""
        chw = np.ascontiguousarray(np.transpose(image_u8, (2, 0, 1)))
        self.R_cw[idx] = cam.pose.R_cw
        self.t_cw[idx] = cam.pose.t_cw
        self.full_proj[idx] = cam.full_proj
        self.images[idx] = torch.from_numpy(chw).to(self.images.device)
        return self

    def camera(self, intr: Intrinsics, idx: int) -> Camera:
        """The Camera of keyframe `idx`."""
        return Camera(
            intr=intr,
            pose=CameraPose(R_cw=self.R_cw[idx], t_cw=self.t_cw[idx]),
            full_proj=self.full_proj[idx],
        )

    def grow(self, new_capacity: int) -> "KeyframeBuffer":
        """Capacity growth of the stacked buffers."""
        cap = self.images.shape[0]
        if new_capacity < cap:
            raise ValueError(f"cannot shrink {cap} -> {new_capacity}")
        extra = new_capacity - cap

        def pad(x):
            return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])], dim=0)

        return KeyframeBuffer(
            R_cw=pad(self.R_cw), t_cw=pad(self.t_cw),
            full_proj=pad(self.full_proj), images=pad(self.images),
        )


@dataclass
class PointAccumulator:
    """Host-side LiDAR point accumulation between keyframes."""

    points: List[np.ndarray] = field(default_factory=list)
    colors: List[np.ndarray] = field(default_factory=list)
    depths: List[np.ndarray] = field(default_factory=list)
    dropped: int = 0

    def add(self, frame: FrameInput) -> None:
        if frame.points.size == 0:
            return
        pts = np.asarray(frame.points, np.float32)
        cols = np.asarray(frame.colors, np.float32)
        # camera-frame depth at observation time (gaussian.cpp:66-70)
        R_cw = np.asarray(frame.R_wc, np.float64).T
        t_cw = -R_cw @ np.asarray(frame.t_wc, np.float64)
        z = (pts @ R_cw.T + t_cw)[:, 2].astype(np.float32)
        keep = z > 0  # assert(pt_c(2) > 0) in the reference (gaussian.cpp:69)
        self.dropped += int((~keep).sum())
        self.points.append(pts[keep])
        self.colors.append(cols[keep])
        self.depths.append(z[keep])

    @property
    def total(self) -> int:
        return sum(p.shape[0] for p in self.points)

    def take(self):
        """Return stacked (points, colors, depths) and clear."""
        if not self.points:
            out = (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32),
            )
        else:
            out = (
                np.concatenate(self.points, axis=0),
                np.concatenate(self.colors, axis=0),
                np.concatenate(self.depths, axis=0),
            )
        self.points, self.colors, self.depths = [], [], []
        return out


def build_camera(intr: Intrinsics, frame: FrameInput, device: Device = "cpu") -> Camera:
    return make_camera(intr, np.asarray(frame.R_wc), np.asarray(frame.t_wc), device=device)
