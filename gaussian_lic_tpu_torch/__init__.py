"""gaussian_lic_tpu_torch — the PyTorch + CUDA port of gaussian_lic_tpu.

The streaming mapper's keyframe path (map init, densification, train steps)
on an NVIDIA H100, with the tile blend forward and backward as hand-written
CUDA kernels (csrc/, built with nvcc on first use by `_build.py`). The JAX
package `gaussian_lic_tpu` is the reference; this package imports torch and
numpy only.
"""

from gaussian_lic_tpu_torch.camera import Camera, CameraPose, Intrinsics, make_camera
from gaussian_lic_tpu_torch.config import PRESETS, Params, load_params

__version__ = "0.1.0"

__all__ = [
    "Params",
    "load_params",
    "PRESETS",
    "Intrinsics",
    "CameraPose",
    "Camera",
    "make_camera",
]
