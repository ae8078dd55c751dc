"""Configuration: the reference's flat-YAML ``Params`` plus the rasterizer knobs.

The same keys, defaults and presets as the JAX package's `config.py`, so one
YAML file (config/{fastlivo,r3live,mcd}.yaml) drives both packages.
`opt_bundle_sizes` splits a keyframe's steps into bundles, as in the JAX
package (each a CUDA graph on the card, engine/trainer.py); its sizes must be
positive. `splat_chunk` is accepted for YAML parity and unused here: the CUDA
blend kernels stage their own batches. `bucket_overprovision` sizes the
multi-GPU binning's buckets (parallel/sharded.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class Params:
    """All run configuration (frozen, hashable)."""

    # --- dataset / camera (reference: mapping.h:88-96) ---
    width: int = 640
    height: int = 512
    fx: float = 431.795259219
    fy: float = 431.550090267
    cx: float = 310.833037316
    cy: float = 266.985989326
    select_every_k_frame: int = 5

    # --- gaussian model (mapping.h:98-105) ---
    sh_degree: int = 3
    white_background: bool = False
    random_background: bool = False
    convert_SHs_python: bool = False    # accepted for config parity; unused
    compute_cov3D_python: bool = False  # accepted for config parity; unused
    lambda_erank: float = 0.0
    scaling_scale: float = 1.0

    # --- optimization (mapping.h:107-112) ---
    position_lr: float = 0.00016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2

    # --- exposure / skybox (mapping.h:114-117) ---
    apply_exposure: bool = False
    exposure_lr: float = 0.001
    skybox_points_num: int = 100000
    skybox_radius: float = 1000.0

    # --- training loop (gaussian.cpp:645) ---
    max_iters_per_keyframe: int = 100
    # Steps a keyframe runs as bundles of these sizes, greedily (100 -> 64 +
    # 16 + 16 + 4); a size of 1 is implied. Each must be > 0.
    opt_bundle_sizes: tuple = (64, 16, 4, 1)

    # --- rasterizer knobs (no reference counterpart) ---
    tile_h: int = 32             # image-tile height (tile_h*tile_w must be 1024)
    tile_w: int = 32
    # Static K tile-slots per Gaussian; rects needing more are truncated and
    # counted in the render's `truncated` counter.
    max_tiles_per_gaussian: int = 8
    splat_chunk: int = 16        # accepted for YAML parity; unused
    # Sorted-splat-list budget as a multiple of capacity. The engine grows it
    # x1.5 (capped at max_tiles_per_gaussian) when a step reports budget loss.
    splat_budget_factor: float = 1.7
    # Multi-GPU binning (parallel/sharded.py): the bucket each source rank
    # sends each band holds m_pair = max(ceil(b m / D) rounded down to 256,
    # 512) entries, b this value, m = max(M / D, 1024) the band's share of the
    # splat budget M, D the ranks. Entries past a full bucket count as
    # budget_lost.
    bucket_overprovision: float = 1.5

    # --- capacity management ---
    initial_capacity: int = 1 << 18     # Gaussian array capacity at startup
    # Candidate point batches of an extend pad up to the next power-of-two
    # multiple of this (every accumulated point is processed).
    densify_budget: int = 1 << 16
    max_train_keyframes: int = 512      # capacity of the stacked keyframe buffer

    # --- misc ---
    znear: float = 0.01
    zfar: float = 100.0
    seed: int = 0

    def __post_init__(self) -> None:
        # YAML gives lists; Params must stay hashable
        if not isinstance(self.opt_bundle_sizes, tuple):
            object.__setattr__(
                self, "opt_bundle_sizes", tuple(self.opt_bundle_sizes)
            )
        # the greedy decomposition never ends on a size <= 0
        if not all(int(k) == k and k > 0 for k in self.opt_bundle_sizes):
            raise ValueError(f"opt_bundle_sizes must be positive integers, got "
                             f"{self.opt_bundle_sizes}")

    @property
    def num_sh_rest(self) -> int:
        return (self.sh_degree + 1) ** 2 - 1

    def replace(self, **kw: Any) -> "Params":
        return dataclasses.replace(self, **kw)


# Reference dataset presets: config/fastlivo.yaml, config/r3live.yaml, config/mcd.yaml.
PRESETS: Dict[str, Dict[str, Any]] = {
    "fastlivo": dict(
        width=640, height=512,
        fx=431.795259219, fy=431.550090267, cx=310.833037316, cy=266.985989326,
    ),
    "r3live": dict(
        width=640, height=512,
        fx=431.71205, fy=431.70855, cx=320.3404, cy=259.1696,
    ),
    "mcd": dict(
        width=640, height=480,
        fx=385.538839108671, fy=385.6733947077097,
        cx=328.2882031921083, cy=243.5295974916248,
    ),
}


def load_params(
    path: Optional[str] = None,
    preset: Optional[str] = None,
    **overrides: Any,
) -> Params:
    """Build Params from a YAML file (reference schema), a named preset, or kwargs.

    Unknown keys raise to catch typos, as the reference's eager YAML::as<T>
    does (mapping.h:56-86).
    """
    fields = {f.name for f in dataclasses.fields(Params)}
    kw: Dict[str, Any] = {}
    if preset is not None:
        if preset not in PRESETS:
            raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
        kw.update(PRESETS[preset])
    if path is not None:
        import yaml  # lazy: only needed for file configs

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        unknown = set(raw) - fields
        if unknown:
            raise KeyError(f"unknown config keys in {path}: {sorted(unknown)}")
        kw.update(raw)
    unknown = set(overrides) - fields
    if unknown:
        raise KeyError(f"unknown config overrides: {sorted(unknown)}")
    kw.update(overrides)
    return Params(**kw)
