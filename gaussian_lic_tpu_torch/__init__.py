"""gaussian_lic_tpu_torch — the PyTorch + CUDA port of gaussian_lic_tpu.

The streaming mapping application on an NVIDIA H100: stream ingest
(recorded directories, rosbags, live ROS), map init with the skybox,
densification, train steps with the erank term, and the end of the run
(eval with PSNR/SSIM/LPIPS, PLY export, checkpoints), driven by
`python -m gaussian_lic_tpu_torch`. The tile blend forward and backward are
hand-written CUDA kernels (csrc/, built with nvcc on first use by
`_build.py`). The JAX package `gaussian_lic_tpu` is the reference; this
package imports torch and numpy only.
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
