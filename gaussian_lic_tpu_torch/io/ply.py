"""3DGS-standard PLY export and import.

The counterpart of the JAX package's `io/ply.py`, byte for byte the same file
(GaussianModel::saveMap, gaussian.cpp:306-397): binary little-endian, vertex
properties x,y,z, f_dc_0-2, f_rest_0-44 (channel-major: index = channel*S +
coeff), opacity (logit), scale_0-2 (log), rot_0-3 (unnormalized wxyz). The
skybox Gaussians are left out by slicing off the first `skybox_count` rows
(gaussian.cpp:310-316). The writer goes through the native runtime when it
builds, as the JAX writer does.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np


def _header(num: int, sh_rest: int) -> bytes:
    props = ["x", "y", "z"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(3 * sh_rest)]
    props += ["opacity"]
    props += [f"scale_{i}" for i in range(3)]
    props += [f"rot_{i}" for i in range(4)]
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {num}",
        *[f"property float {p}" for p in props],
        "end_header",
    ]
    return ("\n".join(lines) + "\n").encode("ascii")


def save_ply(
    path: str,
    xyz: np.ndarray,        # (n,3)
    dc: np.ndarray,         # (n,3) SH DC
    sh_rest: np.ndarray,    # (n,S,3)
    opa_logit: np.ndarray,  # (n,)
    log_scale: np.ndarray,  # (n,3)
    quat: np.ndarray,       # (n,4)
    skybox_count: int = 0,
    use_native: bool = True,
) -> None:
    sl = slice(skybox_count, None)
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32)[sl])
    dc = np.ascontiguousarray(np.asarray(dc, np.float32)[sl])
    sh_rest = np.ascontiguousarray(np.asarray(sh_rest, np.float32)[sl])
    opa = np.ascontiguousarray(np.asarray(opa_logit, np.float32)[sl].reshape(-1))
    ls = np.ascontiguousarray(np.asarray(log_scale, np.float32)[sl])
    q = np.ascontiguousarray(np.asarray(quat, np.float32)[sl])
    n, S = sh_rest.shape[0], sh_rest.shape[1]

    if use_native:
        from gaussian_lic_tpu_torch import native

        lib = native.get_lib()
        if lib is not None:
            def fp(a):
                return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

            rc = lib.glic_ply_write(path.encode(), n, S, fp(xyz), fp(dc), fp(sh_rest),
                                    fp(opa), fp(ls), fp(q))
            if rc == 0:
                return
            raise IOError(f"native PLY write failed (rc={rc}): {path}")

    # channel-major rest coefficients (gaussian.cpp:313: transpose(1,2).flatten(1))
    rest = np.transpose(sh_rest, (0, 2, 1)).reshape(n, 3 * S)
    rec = np.concatenate([xyz, dc, rest, opa.reshape(-1, 1), ls, q], axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(_header(n, S))
        f.write(rec.tobytes())


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a 3DGS PLY (this package's or any ecosystem-standard one).
    Returns arrays keyed xyz, dc, sh_rest, opa_logit, log_scale, quat."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    num = None
    props = []
    fmt = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            num = int(parts[2])
        elif parts[0] == "property":
            if parts[1] != "float":
                raise ValueError(f"unsupported property type {parts[1]}")
            props.append(parts[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    if num is None:
        raise ValueError(f"no vertex element in {path}")
    arr = np.frombuffer(data, dtype="<f4", count=num * len(props),
                        offset=head_end).reshape(num, len(props))
    col = {p: i for i, p in enumerate(props)}
    S = sum(1 for p in props if p.startswith("f_rest_")) // 3
    rest = arr[:, [col[f"f_rest_{i}"] for i in range(3 * S)]]
    return dict(
        xyz=arr[:, [col["x"], col["y"], col["z"]]].copy(),
        dc=arr[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]].copy(),
        sh_rest=np.transpose(rest.reshape(num, 3, S), (0, 2, 1)).copy(),
        opa_logit=arr[:, col["opacity"]].copy(),
        log_scale=arr[:, [col[f"scale_{i}"] for i in range(3)]].copy(),
        quat=arr[:, [col[f"rot_{i}"] for i in range(4)]].copy(),
    )


def save_map_ply(path: str, gm) -> None:
    """Export a GaussianMap's active Gaussians, the skybox left out."""
    n = int(gm.count)

    def host(x):
        return x[:n].detach().cpu().numpy()

    save_ply(path, host(gm.xyz), host(gm.dc), host(gm.sh_rest), host(gm.opa_logit),
             host(gm.log_scale), host(gm.quat), skybox_count=gm.skybox_count)
