"""State carried across from the JAX package, as numpy arrays.

`gaussian_map_from_numpy` / `adam_state_from_numpy` take the fields of the
JAX package's `GaussianMap` and `AdamState`s (converted with `np.asarray`)
and build this package's, copying the data; `to_numpy` goes back.
`lpips_from_numpy` builds the LPIPS module from the JAX package's LPIPS
parameters. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from gaussian_lic_tpu_torch.models.gaussians import GaussianMap
from gaussian_lic_tpu_torch.ops.adam import AdamState
from gaussian_lic_tpu_torch.ops.lpips import LPIPS

Device = Union[str, torch.device]
MAP_FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit", "count",
              "exposure")


def gaussian_map_from_numpy(
    arrays: Mapping[str, np.ndarray], *, sh_degree: int, skybox_count: int,
    device: Device,
) -> GaussianMap:
    """GaussianMap from numpy arrays keyed by MAP_FIELDS."""
    missing = set(MAP_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"missing GaussianMap fields: {sorted(missing)}")
    t = {k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
         for k in MAP_FIELDS if k != "count"}
    count = torch.tensor(int(np.asarray(arrays["count"])), dtype=torch.int32, device=device)
    return GaussianMap(count=count, sh_degree=sh_degree, skybox_count=skybox_count, **t)


def adam_state_from_numpy(
    states: Mapping[str, Mapping[str, np.ndarray]], *, device: Device,
) -> Dict[str, AdamState]:
    """{group: AdamState} from {group: {"exp_avg": ..., "exp_avg_sq": ...}}."""
    return {
        name: AdamState(
            torch.tensor(np.asarray(st["exp_avg"], np.float32), device=device),
            torch.tensor(np.asarray(st["exp_avg_sq"], np.float32), device=device),
        )
        for name, st in states.items()
    }


def lpips_from_numpy(params: Mapping[str, np.ndarray], *, device: Device) -> LPIPS:
    """The LPIPS module from the JAX package's LPIPS parameters (keyed
    conv{i}_w, conv{i}_b, lin{i}_w)."""
    return LPIPS({k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()},
                 device=device)


def to_numpy(obj):
    """GaussianMap -> {field: array}; {group: AdamState} -> {group: {...}};
    a tensor -> array."""
    if isinstance(obj, GaussianMap):
        return {k: getattr(obj, k).detach().cpu().numpy() for k in MAP_FIELDS}
    if isinstance(obj, AdamState):
        return {"exp_avg": obj.exp_avg.detach().cpu().numpy(),
                "exp_avg_sq": obj.exp_avg_sq.detach().cpu().numpy()}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    raise TypeError(f"cannot convert {type(obj).__name__}")
