"""Reference outputs of the JAX package for the PyTorch port's tests.

Runs `gaussian_lic_tpu` on the CPU, with the Pallas blend kernels in interpret
mode, on small seeded scenes, and returns (or writes) the inputs and outputs as
.npz files:

  blend.npz   K1 `blend_forward` (color and no_color) and K2 `blend_backward`
              at 64x64 with 128 Gaussians, mapped from tile-major to image space;
  train.npz   1 and 10 steps of `_make_train_step(with_grads=True)`;
  engine.npz  a 3-keyframe `MappingEngine.add_frame` run;
  finalize.npz  a 9-frame run with a 64-point skybox (every 3rd frame a
              keyframe), then `finalize` with randinit LPIPS: the skybox's
              uniform draws, the eval results and the PLY file's bytes.

Interpret-mode Pallas is slow on a CPU (tens of seconds to minutes per case),
which is why the port's fast tests read these files instead of running the JAX
side live. The slow-marked tests call the `make_*` functions below and compare
against them directly.

Usage:
    python tools/make_torch_goldens.py              # write into a temp dir
    python tools/make_torch_goldens.py --write      # write tests/torch_goldens/
    python tools/make_torch_goldens.py --only blend --out DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "torch_goldens")
SEED = 20261016

# Small rig shared by the train and engine cases: 64x64 = 2x2 tiles of 32x32.
SMALL_RIG = dict(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0)


def _jax_cpu():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def small_params(**kw):
    """The Params of the train and engine cases (JAX package's dataclass)."""
    from gaussian_lic_tpu.config import Params

    base = dict(
        SMALL_RIG,
        select_every_k_frame=2,
        skybox_points_num=0,
        initial_capacity=512,
        densify_budget=256,
        max_train_keyframes=4,
        max_tiles_per_gaussian=16,
        seed=SEED % 1000,
    )
    base.update(kw)
    return Params(**base)


# ---------------------------------------------------------------------------
# K1 / K2 on a fixed splat list
# ---------------------------------------------------------------------------

def blend_scene(rng: np.random.Generator, n: int = 128):
    """96 random Gaussians plus a cluster of 32 opaque ones at the centre, so
    that some pixels reach the T < 1e-4 termination."""
    n_rand = n - 32
    xyz = np.concatenate([
        np.stack([rng.uniform(-2.5, 2.5, n_rand), rng.uniform(-2.5, 2.5, n_rand),
                  rng.uniform(3.0, 8.0, n_rand)], axis=1),
        np.stack([rng.normal(0, 0.3, 32), rng.normal(0, 0.3, 32),
                  rng.uniform(3.0, 5.0, 32)], axis=1),
    ]).astype(np.float32)
    scale = (np.abs(rng.normal(size=(n, 3))) * 0.12 + 0.05).astype(np.float32)
    scale[n_rand:] *= 3.0
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = np.concatenate([rng.uniform(0.2, 0.95, n_rand),
                              rng.uniform(0.9, 0.99, 32)]).astype(np.float32)
    dc = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    sh_rest = (rng.normal(size=(n, 15, 3)) * 0.05).astype(np.float32)
    return xyz, scale, quat, opacity, dc, sh_rest


BLEND_BUDGET = 1 << 12   # max_total_splats of the blend case


def blend_rows():
    """The blend case's packed per-Gaussian rows (P, 16) and binning, from
    the JAX package (no Pallas): the primal and the integer arguments of
    `rasterize._make_blend` at 64x64, and the rng after the scene's draws."""
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.camera import Intrinsics, look_at, make_camera
    from gaussian_lic_tpu.ops import sh as sh_ops
    from gaussian_lic_tpu.ops import tiles as tiles_ops
    from gaussian_lic_tpu.ops.blend_pallas import CHUNK
    from gaussian_lic_tpu.ops.projection import OPACITY_THRESHOLD, project_gaussians
    from gaussian_lic_tpu.ops.rasterize import _pack_rows

    rng = np.random.default_rng(SEED)
    intr = Intrinsics(width=64, height=64, fx=48.0, fy=48.0, cx=32.0, cy=32.0)
    R_wc, t_wc = look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    cam = make_camera(intr, R_wc, t_wc)
    xyz, scale, quat, opacity, dc, sh_rest = (
        jnp.asarray(a) for a in blend_scene(rng)
    )
    grid = tiles_ops.TileGrid(width=64, height=64, tile_w=32, tile_h=32)
    proj = project_gaussians(xyz, scale, quat, cam)
    active = proj.in_front & proj.det_valid & (opacity >= OPACITY_THRESHOLD)
    radius = jnp.where(active, proj.radius, 0.0)
    rgb = sh_ops.eval_sh_color(3, dc, sh_rest, xyz - cam.cam_center)
    b = tiles_ops.bin_gaussians(
        proj.xy, proj.depth, proj.conic, opacity, radius, active, grid,
        max_tiles_per_gaussian=16, max_total_splats=BLEND_BUDGET, align=CHUNK,
    )
    return _pack_rows(proj.xy, proj.conic, opacity, rgb), b, grid, rng


def make_blend() -> dict:
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops.blend_pallas import (
        SPLAT_ROWS, SUB, blend_backward, blend_forward, swizzle_tiles, unswizzle_tiles,
    )

    rows, b, grid, rng = blend_rows()
    splat_rows = jnp.take(rows, b.sorted_gauss, axis=0, mode="fill", fill_value=0.0)
    m_pad = splat_rows.shape[0]
    splats = splat_rows.reshape(m_pad // SUB, SUB * SPLAT_ROWS)
    kw = dict(n_tx=grid.n_tx, n_ty=grid.n_ty, tile_h=32, tile_w=32, interpret=True)
    color_t, ft_t, nc_t = blend_forward(splats, b.tile_starts, b.tile_lens, **kw)
    _, ft_nc_t, _ = blend_forward(splats, b.tile_starts, b.tile_lens,
                                  no_color=True, **kw)
    dl = rng.normal(size=(3, 64, 64)).astype(np.float32)
    sw = dict(n_tx=grid.n_tx, n_ty=grid.n_ty, tile_h=32, tile_w=32)
    grads = blend_backward(
        splats, b.tile_starts, b.tile_lens, swizzle_tiles(jnp.asarray(dl), **sw),
        ft_t, nc_t, **kw,
    )
    return dict(
        splats=np.asarray(splat_rows, np.float32),
        tile_starts=np.asarray(b.tile_starts, np.int32),
        tile_lens=np.asarray(b.tile_lens, np.int32),
        grid=np.array([grid.n_tx, grid.n_ty, 32, 32], np.int32),
        color=np.asarray(unswizzle_tiles(color_t, **sw)),
        final_t=np.asarray(unswizzle_tiles(ft_t, **sw)),
        n_contrib=np.asarray(unswizzle_tiles(nc_t, **sw)),
        final_t_no_color=np.asarray(unswizzle_tiles(ft_nc_t, **sw)),
        dl_dcolor=dl,
        entry_grads=np.asarray(grads[:9].T),
    )


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _small_world_frames(n_frames: int, seed: int):
    from gaussian_lic_tpu.camera import Intrinsics
    from gaussian_lic_tpu.utils.synthetic import make_sequence, make_world

    rng = np.random.default_rng(seed)
    intr = Intrinsics(**SMALL_RIG)
    world = make_world(rng, n_points=300, intr=intr)
    return make_sequence(world, n_frames=n_frames, points_per_frame=100, rng=rng)


def _frames_dict(frames) -> dict:
    return dict(
        frame_R_wc=np.stack([np.asarray(f.R_wc, np.float32) for f in frames]),
        frame_t_wc=np.stack([np.asarray(f.t_wc, np.float32) for f in frames]),
        frame_images=np.stack([f.image_u8() for f in frames]),
        frame_points=np.stack([np.asarray(f.points, np.float32) for f in frames]),
        frame_colors=np.stack([np.asarray(f.colors, np.float32) for f in frames]),
    )


GM_FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit")
GROUPS = ("xyz", "dc", "sh_rest", "opacity", "log_scale", "quat")


def make_train(n_steps: int = 10) -> dict:
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.camera import Intrinsics
    from gaussian_lic_tpu.engine.dataset import KeyframeBuffer, build_camera
    from gaussian_lic_tpu.engine.trainer import PARAM_GROUPS, _make_train_step
    from gaussian_lic_tpu.models.gaussians import initialize_map
    from gaussian_lic_tpu.ops import adam as adam_ops

    cfg = small_params()
    intr = Intrinsics(**SMALL_RIG)
    frames = _small_world_frames(3, SEED + 1)
    pts = np.concatenate([f.points for f in frames])
    cols = np.concatenate([f.colors for f in frames])
    depths = []
    for f in frames:
        R_cw = np.asarray(f.R_wc, np.float64).T
        t_cw = -R_cw @ np.asarray(f.t_wc, np.float64)
        depths.append((np.asarray(f.points) @ R_cw.T + t_cw)[:, 2].astype(np.float32))
    depths = np.concatenate(depths)
    gm = initialize_map(pts, cols, depths, focal=(cfg.fx + cfg.fy) / 2.0,
                        sh_degree=3, capacity=cfg.initial_capacity)
    kf = KeyframeBuffer.empty(cfg.max_train_keyframes, intr)
    for i, f in enumerate(frames):
        kf = kf.set_frame(i, build_camera(intr, f), f.image_u8())
    opt = {n: adam_ops.AdamState(jnp.zeros_like(gm.trainable()[n]),
                                 jnp.zeros_like(gm.trainable()[n]))
           for n in PARAM_GROUPS}
    n = int(gm.count)
    out = dict(_frames_dict(frames), count=np.int32(n),
               idxs=np.random.default_rng(SEED).integers(0, 3, n_steps).astype(np.int32))
    for name in GM_FIELDS:
        out[f"init_{name}"] = np.asarray(getattr(gm, name))[:n]
    step = _make_train_step(intr, cfg, with_grads=True)
    losses, n_vis = [], []
    for s in range(n_steps):
        gm, opt, m = step(gm, opt, kf, jnp.asarray(out["idxs"][s]),
                          jnp.asarray(s + 1, jnp.int32))
        losses.append(float(m["loss"]))
        n_vis.append(int(m["n_visible"]))
        if s == 0:
            for g in GROUPS:
                out[f"grad1_{g}"] = np.asarray(m["grads"][g])[:n]
        if s in (0, n_steps - 1):
            tag = "step1" if s == 0 else "final"
            for name in GM_FIELDS:
                out[f"{tag}_{name}"] = np.asarray(getattr(gm, name))[:n]
    out["losses"] = np.array(losses, np.float32)
    out["n_visible"] = np.array(n_vis, np.int32)
    return out


# ---------------------------------------------------------------------------
# 3-keyframe engine run
# ---------------------------------------------------------------------------

class _RecordingRng:
    """Forwards the engine's numpy RNG calls and records each optimize list."""

    def __init__(self, rng):
        self.rng = rng
        self.lists = []

    def choice(self, *a, **k):
        return self.rng.choice(*a, **k)

    def shuffle(self, x):
        self.rng.shuffle(x)
        self.lists.append(np.array(x, np.int32))


def make_engine(n_frames: int = 6) -> dict:
    _jax_cpu()
    from gaussian_lic_tpu.engine.trainer import MappingEngine

    cfg = small_params()
    frames = _small_world_frames(n_frames, SEED + 2)
    eng = MappingEngine(cfg)
    eng.rng = _RecordingRng(eng.rng)
    counts, losses = [], []
    for f in frames:
        if eng.add_frame(f):
            counts.append(int(eng.gm.count))
            losses.append(eng.last_metrics["loss"])
    opt_lists = eng.rng.lists
    return dict(
        _frames_dict(frames),
        counts=np.array(counts, np.int32),
        losses=np.array(losses, np.float32),
        opt_lists=np.concatenate(opt_lists),
        opt_list_lens=np.array([len(x) for x in opt_lists], np.int32),
        params_json=np.array(json.dumps({
            k: getattr(cfg, k) for k in (
                "width", "height", "fx", "fy", "cx", "cy", "select_every_k_frame",
                "initial_capacity", "densify_budget", "max_train_keyframes",
                "max_tiles_per_gaussian", "seed")
        })),
    )


# ---------------------------------------------------------------------------
# end of run: a 9-frame engine run with a skybox, then finalize
# ---------------------------------------------------------------------------

FINALIZE_SKYBOX = 64
RESULT_KEYS = ("train_psnr", "train_ssim", "train_lpips", "test_psnr", "test_ssim",
               "test_lpips", "num_gaussians")


def finalize_params():
    """The Params of the finalize case: every 3rd frame trains, 64 skybox points."""
    return small_params(select_every_k_frame=3, skybox_points_num=FINALIZE_SKYBOX)


def make_finalize(n_frames: int = 9) -> dict:
    jax = _jax_cpu()
    from gaussian_lic_tpu.engine.trainer import MappingEngine

    cfg = finalize_params()
    frames = _small_world_frames(n_frames, SEED + 3)
    # the skybox draws of models/gaussians.make_skybox
    k1, k2 = jax.random.split(jax.random.PRNGKey(cfg.seed))
    u1 = np.asarray(jax.random.uniform(k1, (cfg.skybox_points_num,)))
    u2 = np.asarray(jax.random.uniform(k2, (cfg.skybox_points_num,)))
    with tempfile.TemporaryDirectory() as tmp:
        eng = MappingEngine(cfg, result_path=tmp, lpips_path="randinit")
        for f in frames:
            eng.add_frame(f)
        res = eng.finalize()
        with open(os.path.join(tmp, "point_cloud.ply"), "rb") as f:
            ply = f.read()
    return dict(
        _frames_dict(frames),
        skybox_u1=u1, skybox_u2=u2,
        results=np.array([res[k] for k in RESULT_KEYS], np.float64),
        ply=np.frombuffer(ply, np.uint8),
        kf_count=np.int32(eng.kf_count),
    )


CASES = {"blend": make_blend, "train": make_train, "engine": make_engine,
         "finalize": make_finalize}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help=f"write into {os.path.relpath(GOLDEN_DIR, ROOT)}/")
    ap.add_argument("--out", default=None, help="output directory (overrides --write)")
    ap.add_argument("--only", default=",".join(CASES),
                    help="comma-separated subset of: " + ",".join(CASES))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    out_dir = args.out or (GOLDEN_DIR if args.write else tempfile.mkdtemp())
    os.makedirs(out_dir, exist_ok=True)
    for name in args.only.split(","):
        t0 = time.perf_counter()
        arrays = CASES[name]()
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez_compressed(path, **arrays)
        print(f"{name}: {os.path.getsize(path)} bytes -> {path} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
