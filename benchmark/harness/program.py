"""The program's objects, built from the benchmark's inputs through the
port's public constructors: a `MappingEngine` that holds a seeded map, a
keyframe buffer of the given poses and images and, for the eval path, the
keyframes' names and held-out views.
"""

from __future__ import annotations

import torch


def engine(run, params, imgs, R_wc, t_wc, optimizer: bool = True):
    """A `MappingEngine` at the cell's configuration (its seed the run's)
    holding `params` (the map's stored parameters, copied) and keyframes of
    world-from-camera poses `R_wc`, `t_wc` and uint8 images `imgs`
    (n, 3, H, W); with `optimizer`, zero Adam moments."""
    from gaussian_lic_tpu_torch.camera import make_camera
    from gaussian_lic_tpu_torch.config import Params
    from gaussian_lic_tpu_torch.engine.dataset import KeyframeBuffer
    from gaussian_lic_tpu_torch.engine.trainer import MappingEngine
    from gaussian_lic_tpu_torch.models.gaussians import GaussianMap
    from gaussian_lic_tpu_torch.ops.adam import AdamState

    p, a, dev = run.config["params"], run.config["assumed"], run.device
    eng = MappingEngine(Params(**dict(p, seed=run.seed)), device=dev)
    cams = [make_camera(eng.intr, R_wc[i], t_wc[i], device=dev) for i in range(len(R_wc))]
    eng.kf_buffer = KeyframeBuffer(
        R_cw=torch.stack([c.pose.R_cw for c in cams]), t_cw=torch.stack([c.pose.t_cw for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]), images=imgs)
    eng.kf_count = len(cams)
    f32 = dict(dtype=torch.float32, device=dev)
    eng.gm = GaussianMap(
        xyz=params["xyz"].clone(), dc=params["dc"].clone(), sh_rest=params["sh_rest"].clone(),
        log_scale=params["log_scale"].clone(), quat=params["quat"].clone(),
        opa_logit=params["opacity"].clone(),
        count=torch.tensor(a["map_live"], dtype=torch.int32, device=dev),
        exposure=torch.cat([torch.eye(3, **f32), torch.zeros((3, 1), **f32)], 1),
        sh_degree=p["sh_degree"], skybox_count=p["skybox_points_num"])
    if optimizer:
        eng.opt_state = {g: AdamState.zeros_like(t) for g, t in eng.gm.trainable().items()}
    return eng
