"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc + ctypes.

On first use, `load()` compiles every `.cu` file of csrc/ into one shared
library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/libglic_kernels_<hash>.so csrc/*.cu

into `gaussian_lic_tpu_torch/build/` (git-ignored), and loads it with
ctypes. The file name carries a hash of the sources and flags, so an edited
source is never served from a stale library. The build writes a temporary
file and renames it, so concurrent builders never load a half-written one.
Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # rows, m_pad, starts, lens, color, final_t, n_contrib,
    # n_tx, n_ty, tile_w, tile_h, no_color, stream
    "glic_blend_forward": (_VP, _LL, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
    # rows, m_pad, starts, lens, dl_dcolor, final_t, n_contrib, grads,
    # n_tx, n_ty, tile_w, tile_h, stream
    "glic_blend_backward": (_VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP),
}


@dataclass
class KernelLibrary:
    cdll: ctypes.CDLL
    path: str
    build_seconds: float   # 0.0 when an existing library was loaded
    build_log: str         # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = srcs + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in deps:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return srcs, h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises if nvcc fails."""
    srcs, digest = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libglic_kernels_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}\n{res.stderr}"
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
    cdll = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    cdll.glic_error_string.argtypes = [ctypes.c_int]
    cdll.glic_error_string.restype = ctypes.c_char_p
    return KernelLibrary(cdll=cdll, path=path, build_seconds=seconds, build_log=log)


def error_string(code: int) -> str:
    return load().cdll.glic_error_string(code).decode()
