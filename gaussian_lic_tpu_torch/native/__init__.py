"""Native host runtime: builds the repo's `csrc/glic_runtime.cpp` (the same
source the JAX package builds) with g++ on first use and binds it with ctypes.

It holds the reference's C++ host paths: the three-queue stream aligner
(mapping.cpp:31-122) and the PLY writer/reader (gaussian.cpp:306-397). The
library goes to `gaussian_lic_tpu_torch/build/_glic_runtime.so` (git-ignored),
never to the JAX package's directory. Python fallbacks exist everywhere
(engine.stream, io.ply); `available()` says which path is active, and
`GLIC_DISABLE_NATIVE=1` forces the fallbacks.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "csrc", "glic_runtime.cpp")
_SO = os.path.join(_PKG_DIR, "build", "_glic_runtime.so")


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # build to a process-unique path and rename: a concurrent process must
    # never load a half-written library
    tmp = f"{_SO}.build.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return _SO


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    u64p = c.POINTER(c.c_uint64)
    f32p = c.POINTER(c.c_float)
    lib.glic_aligner_new.restype = c.c_void_p
    lib.glic_aligner_new.argtypes = [c.c_double]
    lib.glic_aligner_free.restype = None
    lib.glic_aligner_free.argtypes = [c.c_void_p]
    lib.glic_aligner_push_points.restype = None
    lib.glic_aligner_push_points.argtypes = [c.c_void_p, c.c_double, c.c_uint64, c.c_double]
    lib.glic_aligner_push_pose.restype = None
    lib.glic_aligner_push_pose.argtypes = [c.c_void_p, c.c_double, c.c_uint64]
    lib.glic_aligner_push_image.restype = None
    lib.glic_aligner_push_image.argtypes = [c.c_void_p, c.c_double, c.c_uint64]
    lib.glic_aligner_last_point_walltime.restype = c.c_double
    lib.glic_aligner_last_point_walltime.argtypes = [c.c_void_p]
    lib.glic_aligner_dropped.restype = c.c_uint64
    lib.glic_aligner_dropped.argtypes = [c.c_void_p]
    lib.glic_aligner_pop.restype = c.c_int
    lib.glic_aligner_pop.argtypes = [
        c.c_void_p, c.POINTER(c.c_double), u64p, u64p, u64p, u64p, c.POINTER(c.c_int),
    ]
    lib.glic_ply_write.restype = c.c_int
    lib.glic_ply_write.argtypes = [
        c.c_char_p, c.c_int64, c.c_int, f32p, f32p, f32p, f32p, f32p, f32p,
    ]
    lib.glic_ply_read_header.restype = c.c_int
    lib.glic_ply_read_header.argtypes = [
        c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int), c.POINTER(c.c_int64),
    ]
    lib.glic_ply_read.restype = c.c_int
    lib.glic_ply_read.argtypes = [
        c.c_char_p, c.c_int64, c.c_int, c.c_int64, f32p, f32p, f32p, f32p, f32p, f32p,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    so = _build()
    if so is None:
        return None
    try:
        return _bind(ctypes.CDLL(so))
    except OSError:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The native runtime library, built on first use; None when it is
    disabled or cannot be built (no g++, no source) — callers fall back to
    Python."""
    if os.environ.get("GLIC_DISABLE_NATIVE") == "1":
        return None
    return _load()


def available() -> bool:
    return get_lib() is not None
