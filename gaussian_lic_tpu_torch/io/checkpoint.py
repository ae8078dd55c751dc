"""Mid-run checkpoint and resume (the reference saves only the final PLY).

The counterpart of the JAX package's `io/checkpoint.py`, with the same npz
keys and `format_version` 1, so a checkpoint written by either package loads
in the other: the GaussianMap's arrays, the sparse-Adam moments as
`opt_<group>_m` / `opt_<group>_v`, and trainer bookkeeping as `extra_<key>`,
in one compressed npz.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from gaussian_lic_tpu_torch.interop import (
    MAP_FIELDS, adam_state_from_numpy, gaussian_map_from_numpy, to_numpy,
)
from gaussian_lic_tpu_torch.models.gaussians import GaussianMap

_FORMAT_VERSION = 1


def save_checkpoint(path: str, gm: GaussianMap, opt_state: Optional[dict] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    payload: Dict[str, np.ndarray] = {
        "format_version": np.asarray(_FORMAT_VERSION),
        "sh_degree": np.asarray(gm.sh_degree),
        "skybox_count": np.asarray(gm.skybox_count),
        **to_numpy(gm),
    }
    for name, st in (opt_state or {}).items():
        payload[f"opt_{name}_m"] = to_numpy(st.exp_avg)
        payload[f"opt_{name}_v"] = to_numpy(st.exp_avg_sq)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_checkpoint(
    path: str, device: Union[str, torch.device] = "cpu",
) -> Tuple[GaussianMap, Optional[dict], Dict[str, Any]]:
    """(GaussianMap, {group: AdamState} or None, extra) with every tensor on
    `device`."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {int(z['format_version'])}")
        gm = gaussian_map_from_numpy({k: z[k] for k in MAP_FIELDS},
                                     sh_degree=int(z["sh_degree"]),
                                     skybox_count=int(z["skybox_count"]), device=device)
        opt_names = sorted({k[len("opt_"):-2] for k in z.files
                            if k.startswith("opt_") and k.endswith("_m")})
        opt_state = adam_state_from_numpy(
            {name: {"exp_avg": z[f"opt_{name}_m"], "exp_avg_sq": z[f"opt_{name}_v"]}
             for name in opt_names}, device=device) if opt_names else None
        extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return gm, opt_state, extra
