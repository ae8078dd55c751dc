"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc + ctypes.

On first use, `load()` compiles every `.cu` file of csrc/ to an object,
one nvcc process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o

links the objects into one shared library with a plain C interface,
`build/libglic_kernels_<hash>.so` in `gaussian_lic_tpu_torch/build/`
(git-ignored), and loads it with ctypes. The file name carries a hash of
the sources and flags, so an edited source is never served from a stale
library. The build links in a temporary directory and renames the result,
so concurrent builds never load a half-written one.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # xyz, scale, quat, opacity, dc, sh_rest, active, R_cw, t_cw, full_proj,
    # cam_center, P, S, deg, no_color, raw, W, H, fx, fy, limx_neg, limx_pos,
    # limy_neg, limy_pos, table, depth, radius, base_active, opa_out, stream
    "glic_preprocess_forward": (_VP,) * 11 + (_LL, _I, _I, _I, _I) + (_F,) * 8 + (_VP,) * 6,
    # xyz, scale, quat, opa_logit, dc, sh_rest, R_cw, t_cw, full_proj,
    # cam_center, d_attrs, d_stride, P, S, deg, raw, W, H, fx, fy, limits (4),
    # d_xyz, d_scale, d_quat, d_opacity, d_dc, d_sh_rest, stream
    "glic_preprocess_backward": (_VP,) * 11 + (_LL, _LL, _I, _I, _I) + (_F,) * 8 + (_VP,) * 7,
    # variant, then glic_preprocess_backward's arguments
    "glic_preprocess_probe_backward": (_I,) + (_VP,) * 11 + (_LL, _LL, _I, _I, _I) + (_F,) * 8
                                      + (_VP,) * 7,
    # groups, n_groups, rows, visible, count (or null), b1, 1 - b1, b2, 1 - b2, eps,
    # stream
    "glic_sparse_adam": (_VP, _I, _LL, _VP, _VP) + (_F,) * 5 + (_VP,),
    # xy, xy_stride, conic, conic_stride, depth, dkey, opacity, radius, active,
    # P, K, depth_bits, n_tx, n_ty, tile_w, tile_h, band_ty0, band_n_ty,
    # opacity threshold, keys, touched, sums, stream
    "glic_bin_keys": (_VP, _LL, _VP, _LL) + (_VP,) * 5 + (_LL,) + (_I,) * 8 + (_F,)
                     + (_VP,) * 4,
    # bytes (or -1), previous (int*)
    "glic_l2_fetch_granularity": (_I, _VP),
    # variant, then glic_bin_keys' arguments
    "glic_bin_keys_probe": (_I, _VP, _LL, _VP, _LL) + (_VP,) * 5 + (_LL,) + (_I,) * 8 + (_F,)
                           + (_VP,) * 4,
    # keys, slots, m_eff, m_pad, P, T, depth_bits, tile0, magic, shift, touched,
    # sums, slot_keys (each or null), n_slot_keys, sorted_gauss, starts, lens,
    # cnt, stream
    "glic_bin_ranges": (_VP, _VP, _LL, _LL, _I, _I, _I, _I, _LL, _I) + (_VP,) * 3 + (_LL,)
                       + (_VP,) * 5,
    # variant, then glic_bin_ranges' arguments
    "glic_bin_ranges_probe": (_I, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _LL, _I) + (_VP,) * 3
                             + (_LL,) + (_VP,) * 5,
    # table, n_rows, ids, m, out, stream
    "glic_gather_splats": (_VP, _LL, _VP, _LL, _VP, _VP),
    # keys, n_slots, keys_a, slots_a, keys_b, slots_b, scratch, sort_words, stream
    "glic_sort_live": (_VP, _LL) + (_VP,) * 7,
    # x, x channel and row strides, y, its strides, C, H, W, r0, r1, konst (13
    # host floats), partials (or null), block_sums, stream
    "glic_ssim_forward": (_VP, _LL, _LL, _VP, _LL, _LL) + (_I,) * 5 + (_VP,) * 4,
    # variant, then glic_ssim_forward's arguments
    "glic_ssim_forward_probe": (_I, _VP, _LL, _LL, _VP, _LL, _LL) + (_I,) * 5 + (_VP,) * 4,
    # x, its strides, y, its strides, C, H, W, r0, r1, konst, partials, grad,
    # d, stream
    "glic_ssim_backward": (_VP, _LL, _LL, _VP, _LL, _LL) + (_I,) * 5 + (_VP,) * 5,
    # variant, then glic_ssim_backward's arguments
    "glic_ssim_backward_probe": (_I, _VP, _LL, _LL, _VP, _LL, _LL) + (_I,) * 5 + (_VP,) * 5,
    # rows, m_pad, starts, lens, color, final_t, n_contrib,
    # n_tx, n_ty, tile_w, tile_h, no_color, stream
    "glic_blend_forward": (_VP, _LL, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
    # rows, m_pad, starts, lens, tile_order, dl_dcolor, final_t, n_contrib,
    # sorted_gauss, table, n_tx, n_ty, tile_w, tile_h, stream
    "glic_blend_backward": (_VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                            _I, _I, _I, _I, _VP),
    # variant, rows, m_pad, starts, lens, color, final_t, n_contrib, walked,
    # n_tx, n_ty, tile_w, tile_h, konst (9 host floats or null), stream
    "glic_blend_probe_forward": (_I, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP,
                                 _I, _I, _I, _I, _VP, _VP),
    # variant, rows, m_pad, starts, lens, tile_order, dl_dcolor, final_t, n_contrib,
    # sorted_gauss, out, walked, n_tx, n_ty, tile_w, tile_h, stream
    "glic_blend_probe_backward": (_I, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _I, _I, _I, _I, _VP),
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


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(cmd, proc) -> str:
    """`proc`'s output; raises if it failed."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return out


def _compile_and_link(srcs, path) -> str:
    """nvcc each source in parallel, link into `path`; returns nvcc's output."""
    nvcc = _nvcc()
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmpdir, os.path.basename(src) + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj] for src, obj in zip(srcs, objs)]
        procs = [_start(c) for c in cmds]
        try:
            logs = [_wait(c, p) for c, p in zip(cmds, procs)]
        finally:
            for p in procs:   # a failed source leaves no compiler running
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tmp = os.path.join(tmpdir, "lib.so")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        logs.append(_wait(link, _start(link)))
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return "".join(logs)


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises if nvcc fails."""
    srcs, digest = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libglic_kernels_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        t0 = time.perf_counter()
        log = _compile_and_link(srcs, path)
        seconds = time.perf_counter() - t0
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
