"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy arrays. The JAX package runs on the CPU (tests/conftest.py).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

# tier-1 runs the suite under several xdist workers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "torch_goldens")


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or JAX array) -> CPU torch tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_max(a, b) -> float:
    """max |a - b| relative to max |b| (0 when both are all zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = np.abs(b).max() if b.size else 0.0
    diff = np.abs(a - b).max() if b.size else 0.0
    if denom == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return float(diff / denom)


def golden_tool():
    """The goldens tool, tools/make_torch_goldens.py, as a module."""
    path = os.path.join(ROOT, "tools", "make_torch_goldens.py")
    spec = importlib.util.spec_from_file_location("make_torch_goldens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_golden(name: str, source: str) -> dict:
    """`source` "file": the committed tests/torch_goldens/<name>.npz;
    "live": the JAX package run now (interpret-mode Pallas, minutes)."""
    if source == "file":
        with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
            return dict(z)
    return getattr(golden_tool(), f"make_{name}")()


# golden source parametrization: the live JAX run is slow-marked
GOLDEN_SOURCES = ["file", pytest.param("live", marks=pytest.mark.slow)]


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda:0")


def small_rig():
    """(Intrinsics, Params) of the train and engine goldens (64x64)."""
    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.config import Params

    tool = golden_tool()
    jcfg = tool.small_params()
    cfg = Params(**{f: getattr(jcfg, f) for f in Params.__dataclass_fields__})
    return Intrinsics(**tool.SMALL_RIG), cfg


def frames_from(d: dict):
    """FrameInputs (the port's) from a golden's frame_* arrays."""
    from gaussian_lic_tpu_torch.engine.dataset import FrameInput

    return [
        FrameInput(float(i), d["frame_R_wc"][i], d["frame_t_wc"][i],
                   d["frame_images"][i], d["frame_points"][i], d["frame_colors"][i])
        for i in range(len(d["frame_images"]))
    ]


def initial_state(d: dict):
    """The train golden's initial map, keyframes and zero Adam moments, as
    the port's: (intr, cfg, count, gm, kf, opt)."""
    from gaussian_lic_tpu_torch.engine.dataset import KeyframeBuffer, build_camera
    from gaussian_lic_tpu_torch.models.gaussians import GaussianMap
    from gaussian_lic_tpu_torch.ops.adam import AdamState

    intr, cfg = small_rig()
    count = int(d["count"])
    gm = GaussianMap.empty(cfg.initial_capacity, cfg.sh_degree)
    for f in ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit"):
        getattr(gm, f)[:count] = torch.tensor(d[f"init_{f}"])
    gm.count = torch.tensor(count, dtype=torch.int32)
    kf = KeyframeBuffer.empty(cfg.max_train_keyframes, intr)
    for i, fr in enumerate(frames_from(d)):
        kf.set_frame(i, build_camera(intr, fr), fr.image_u8())
    opt = {k: AdamState.zeros_like(v) for k, v in gm.trainable().items()}
    return intr, cfg, count, gm, kf, opt
