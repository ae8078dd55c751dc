"""Multi-GPU training and rendering on torch.distributed (the JAX package's
`parallel/`): tile-row bands, one per rank, over a sharded map."""

from gaussian_lic_tpu_torch.parallel.launch import spawn
from gaussian_lic_tpu_torch.parallel.sharded import (
    Mesh,
    bin_gaussians_sharded,
    gather_state,
    make_mesh,
    make_sharded_render,
    make_sharded_train_bundle,
    make_sharded_train_step,
    render_band,
    shard_state,
)

__all__ = [
    "Mesh",
    "bin_gaussians_sharded",
    "gather_state",
    "make_mesh",
    "make_sharded_render",
    "make_sharded_train_bundle",
    "make_sharded_train_step",
    "render_band",
    "shard_state",
    "spawn",
]
