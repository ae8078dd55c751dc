"""Reference outputs of the JAX package for the PyTorch port's tests.

Runs `gaussian_lic_tpu` on the CPU, with the Pallas blend kernels in interpret
mode, on small seeded scenes, and returns (or writes) the inputs and outputs as
.npz files:

  blend.npz   K1 `blend_forward` (color and no_color) and K2 `blend_backward`
              at 64x64 with 128 Gaussians, mapped from tile-major to image space;
  nan_row.npz K1 and K2 on blend.npz's list with a NaN-opacity row in front
              of each tile (the port's utils/synthetic.nan_opacity_list);
  tile_shapes.npz  K1 and K2 at every tile of 1024 pixels (1x1024 to
              1024x1), 8 tiles an image (1024x8, 8x1024 or 128x64), each
              tile walking its own copy of a seeded 160-row list;
  train.npz   1 and 10 steps of `_make_train_step(with_grads=True)`;
  engine.npz  a 3-keyframe `MappingEngine.add_frame` run;
  bundle.npz  a 4-step `_make_train_bundle` from train.npz's initial state,
              `_decompose_bundles` on seeded cases, and a 5-keyframe engine
              run with opt_bundle_sizes (4, 2) and its compile count;
  finalize.npz  a 9-frame run with a 64-point skybox (every 3rd frame a
              keyframe), then `finalize` with randinit LPIPS: the skybox's
              uniform draws, the eval results and the PLY file's bytes;
  parallel.npz  the sharded binning, render and two train steps
              (`parallel/sharded.py`) on 2- and 4-device CPU meshes;
  sharded_bundle.npz  a 3-step `make_sharded_train_bundle` on the parallel
              case's setup scene at D = 2 and 4, and the same 3 steps of
              `make_sharded_train_step(with_grads=True)`.

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
    # the parallel case's meshes need host devices (as tests/conftest.py sets)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
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


def make_nan_row() -> dict:
    """K1 and K2 (Pallas, interpret mode) on the blend case's list with a
    NaN-opacity row in front of each tile: jnp.minimum(0.99, NaN) is NaN, so
    the alpha >= 1/255 test rejects the row."""
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops.blend_pallas import (
        SPLAT_ROWS, SUB, blend_backward, blend_forward, swizzle_tiles, unswizzle_tiles,
    )

    from gaussian_lic_tpu_torch.utils.synthetic import nan_opacity_list

    with np.load(os.path.join(GOLDEN_DIR, "blend.npz")) as z:
        d = dict(z)
    sp, st, ln, _ = nan_opacity_list(d["splats"], d["tile_starts"], d["tile_lens"])
    splats = jnp.asarray(sp).reshape(sp.shape[0] // SUB, SUB * SPLAT_ROWS)
    sw = dict(n_tx=2, n_ty=2, tile_h=32, tile_w=32)
    kw = dict(sw, interpret=True)
    color_t, ft_t, nc_t = blend_forward(splats, jnp.asarray(st), jnp.asarray(ln), **kw)
    grads = blend_backward(splats, jnp.asarray(st), jnp.asarray(ln),
                           swizzle_tiles(jnp.asarray(d["dl_dcolor"]), **sw), ft_t, nc_t, **kw)
    return dict(color=np.asarray(unswizzle_tiles(color_t, **sw)),
                final_t=np.asarray(unswizzle_tiles(ft_t, **sw)),
                n_contrib=np.asarray(unswizzle_tiles(nc_t, **sw)),
                entry_grads=np.asarray(grads[:9].T))


# (tile_h, tile_w) of the tile_shapes case: every tile of 1024 pixels, each
# on an image of 8 of its tiles. Prefix of the image's keys, (height, width),
# the x of its cluster of opaque splats, and the shapes it holds; the wide
# image's keys carry no prefix.
TILE_SHAPES_IMAGES = (
    ("", (8, 1024), 300.0, ((4, 256), (1, 1024), (2, 512), (8, 128))),
    ("tall_", (1024, 8), None, ((128, 8), (256, 4), (512, 2), (1024, 1))),
    ("block_", (64, 128), 40.0, ((16, 64), (32, 32), (64, 16))),
)
TILE_SHAPES = tuple(s for *_, shapes in TILE_SHAPES_IMAGES for s in shapes)
TILE_SHAPES_IMAGE = TILE_SHAPES_IMAGES[0][1]   # the wide image (height, width)


def tile_shapes_list(rng: np.random.Generator, n: int = 160, image=TILE_SHAPES_IMAGE,
                     cluster_x: float = 300.0) -> np.ndarray:
    """(n, 16) gathered rows: n seeded splats over an image of (height,
    width) `image` (a cluster of 24 opaque ones at (cluster_x, height / 2),
    so that some pixels reach the T < 1e-4 termination)."""
    h, w = image
    n_rand = n - 24
    x = np.concatenate([rng.uniform(0, w, n_rand), rng.normal(cluster_x, 2, 24)])
    y = np.concatenate([rng.uniform(-1, h + 1, n_rand), rng.normal(h / 2, 1, 24)])
    sx = np.concatenate([rng.uniform(0.8, 6.0, n_rand), rng.uniform(3.0, 5.0, 24)])
    sy = np.concatenate([rng.uniform(0.5, 3.0, n_rand), rng.uniform(3.0, 5.0, 24)])
    th = rng.uniform(0, np.pi, n)
    c, s_ = np.cos(th), np.sin(th)
    cxx = c * c * sx * sx + s_ * s_ * sy * sy
    cyy = s_ * s_ * sx * sx + c * c * sy * sy
    cxy = c * s_ * (sx * sx - sy * sy)
    det = cxx * cyy - cxy * cxy
    opa = np.concatenate([rng.uniform(0.2, 0.95, n_rand), rng.uniform(0.9, 0.99, 24)])
    rows = np.zeros((n, 16), np.float32)
    rows[:, :9] = np.stack([x, y, cyy / det, -cxy / det, cxx / det, opa,
                             *rng.uniform(0, 1, (3, n))], 1)
    return rows


def _transposed(rows: np.ndarray) -> np.ndarray:
    """The rows with x and y swapped (the conic's A and C with them)."""
    out = rows.copy()
    out[:, [0, 1, 2, 4]] = rows[:, [1, 0, 4, 2]]
    return out


def make_tile_shapes() -> dict:
    """K1 and K2 (Pallas, interpret mode) at each tile shape of TILE_SHAPES:
    on each image of TILE_SHAPES_IMAGES the 8 tiles' ranges are 8 copies of
    one 160-row list (each entry's gradient row is its tile's), so each tile
    tests every row at its 1024 pixels; outputs mapped to image space. The
    tall image's list is the wide one's recipe, transposed."""
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops.blend_pallas import (
        SPLAT_ROWS, SUB, blend_backward, blend_forward, swizzle_tiles, unswizzle_tiles,
    )

    out = {}
    for i, (prefix, (h, w), cluster_x, shapes) in enumerate(TILE_SHAPES_IMAGES):
        rng = np.random.default_rng(SEED + 4 + i)
        if cluster_x is None:
            one = _transposed(tile_shapes_list(rng, image=(w, h)))
        else:
            one = tile_shapes_list(rng, image=(h, w), cluster_x=cluster_x)
        rows = np.concatenate([one] * 8)   # 1280 rows: 5 DMA windows of 256
        dl = rng.normal(size=(3, h, w)).astype(np.float32)
        splats = jnp.asarray(rows).reshape(rows.shape[0] // SUB, SUB * SPLAT_ROWS)
        out.update({f"{prefix}splats": rows, f"{prefix}dl_dcolor": dl})
        for th, tw in shapes:
            sw = dict(n_tx=w // tw, n_ty=h // th, tile_h=th, tile_w=tw)
            n_tiles = sw["n_tx"] * sw["n_ty"]
            st = jnp.arange(n_tiles, dtype=jnp.int32) * len(one)
            ln = jnp.full((n_tiles,), len(one), jnp.int32)
            color_t, ft_t, nc_t = blend_forward(splats, st, ln, interpret=True, **sw)
            grads = blend_backward(splats, st, ln, swizzle_tiles(jnp.asarray(dl), **sw),
                                   ft_t, nc_t, interpret=True, **sw)
            tag = f"{th}x{tw}"
            out.update({
                f"{tag}_image": np.array(prefix),
                f"{tag}_grid": np.array([sw["n_tx"], sw["n_ty"], th, tw], np.int32),
                f"{tag}_tile_starts": np.asarray(st), f"{tag}_tile_lens": np.asarray(ln),
                f"{tag}_color": np.asarray(unswizzle_tiles(color_t, **sw)),
                f"{tag}_final_t": np.asarray(unswizzle_tiles(ft_t, **sw)),
                f"{tag}_n_contrib": np.asarray(unswizzle_tiles(nc_t, **sw)),
                f"{tag}_entry_grads": np.asarray(grads[:9].T),
            })
    return out


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


def _train_init():
    """The train case's JAX state: (cfg, intr, frames, map, keyframes, zero
    Adam moments)."""
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.camera import Intrinsics
    from gaussian_lic_tpu.engine.dataset import KeyframeBuffer, build_camera
    from gaussian_lic_tpu.engine.trainer import PARAM_GROUPS
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
    return cfg, intr, frames, gm, kf, opt


def make_train(n_steps: int = 10) -> dict:
    import jax.numpy as jnp

    from gaussian_lic_tpu.engine.trainer import _make_train_step

    cfg, intr, frames, gm, kf, opt = _train_init()
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
# k-step train bundles
# ---------------------------------------------------------------------------

BUNDLE_K = 4
BUNDLE_ENGINE_SIZES = (4, 2)
BUNDLE_METRICS = ("loss", "n_visible", "visible_sum", "budget_lost", "truncated", "overflow")


def decompose_cases(n_cases: int = 64):
    """Seeded (n, sizes) for `_decompose_bundles`: n in [0, 300), 1-4 sizes
    in [1, 80)."""
    rng = np.random.default_rng(SEED + 3)
    return [(int(rng.integers(0, 300)), tuple(int(v) for v in rng.integers(1, 80,
                                                                            rng.integers(1, 5))))
            for _ in range(n_cases)]


def make_bundle() -> dict:
    """JAX `_make_train_bundle(intr, cfg, 4)` from the train case's initial
    state on 4 seeded keyframe ids; `_decompose_bundles` on
    `decompose_cases()`; and a 10-frame `MappingEngine` run with
    opt_bundle_sizes (4, 2) (5 keyframes, lists of 1-5 steps, those of 3-5
    in several bundles; the keyframe buffer grows at the 5th), with its
    optimize lists, counts, losses and `timers.compiles`."""
    import jax.numpy as jnp

    from gaussian_lic_tpu.engine.trainer import (
        MappingEngine, _decompose_bundles, _make_train_bundle,
    )

    cfg, intr, _, gm, kf, opt = _train_init()
    n = int(gm.count)
    idxs = np.random.default_rng(SEED + 5).integers(0, 3, BUNDLE_K).astype(np.int32)
    gm_b, _, m = _make_train_bundle(intr, cfg, BUNDLE_K)(
        gm, opt, kf, jnp.asarray(idxs), jnp.asarray(1, jnp.int32))
    out = dict(bundle_idxs=idxs)
    for name in GM_FIELDS:
        out[f"bundle_{name}"] = np.asarray(getattr(gm_b, name))[:n]
    for k in BUNDLE_METRICS:
        out[f"bundle_m_{k}"] = np.asarray(m[k])

    cases = decompose_cases()
    outs = [_decompose_bundles(c, sizes) for c, sizes in cases]
    out.update(dec_n=np.array([c for c, _ in cases], np.int32),
               dec_sizes=np.concatenate([s for _, s in cases]).astype(np.int32),
               dec_sizes_len=np.array([len(s) for _, s in cases], np.int32),
               dec_out=np.concatenate([np.asarray(o, np.int32) for o in outs]),
               dec_out_len=np.array([len(o) for o in outs], np.int32))

    frames = _small_world_frames(10, SEED + 4)
    eng = MappingEngine(small_params(opt_bundle_sizes=BUNDLE_ENGINE_SIZES))
    eng.rng = _RecordingRng(eng.rng)
    counts, losses = [], []
    for f in frames:
        if eng.add_frame(f):
            counts.append(int(eng.gm.count))
            losses.append(eng.last_metrics["loss"])
    out.update(_frames_dict(frames), counts=np.array(counts, np.int32),
               losses=np.array(losses, np.float32),
               opt_lists=np.concatenate(eng.rng.lists),
               opt_list_lens=np.array([len(x) for x in eng.rng.lists], np.int32),
               compiles=np.int32(eng.timers.compiles),
               overflow=np.float32(eng.last_metrics["overflow"]))
    return out


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


# ---------------------------------------------------------------------------
# the sharded binning, render and train step on 2- and 4-device CPU meshes
# ---------------------------------------------------------------------------

PARALLEL_MESHES = (2, 4)
PARALLEL_RIG = dict(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0)


def parallel_params(**kw):
    """The Params of the parallel case (tests/test_parallel.py's setup):
    128x64 in (8,128) tiles, 8 tile rows, so both meshes keep the tile shape."""
    from gaussian_lic_tpu.config import Params

    base = dict(PARALLEL_RIG, skybox_points_num=0, initial_capacity=512,
                max_tiles_per_gaussian=16, max_train_keyframes=4, tile_h=8, tile_w=128)
    base.update(kw)
    return Params(**base)


def parallel_scene():
    """(gm, frames) of tests/test_parallel.py's setup (seed 7, 3 frames)."""
    from gaussian_lic_tpu.camera import Intrinsics
    from gaussian_lic_tpu.engine.dataset import build_camera
    from gaussian_lic_tpu.models.gaussians import initialize_map
    from gaussian_lic_tpu.utils.synthetic import make_sequence, make_world

    intr = Intrinsics(**PARALLEL_RIG)
    rng = np.random.default_rng(7)
    world = make_world(rng, n_points=250)
    frames = make_sequence(world, n_frames=3, points_per_frame=150, rng=rng)
    pts = np.concatenate([f.points for f in frames])
    cols = np.concatenate([f.colors for f in frames])
    cam0 = build_camera(intr, frames[0])
    z = (pts @ np.asarray(cam0.pose.R_cw).T + np.asarray(cam0.pose.t_cw))[:, 2]
    keep = z > 0
    gm = initialize_map(pts[keep], cols[keep], z[keep].astype(np.float32),
                        focal=60.0, scaling_scale=1.0, sh_degree=3, capacity=512)
    return gm, frames


def tied_scene():
    """(gm, frames) of tests/test_parallel.py's TestDepthKeyTies: 64
    Gaussians on one z-plane (equal truncated depth keys) with large
    overlapping footprints, so the blend order within a tile is the k-major
    slot order."""
    from gaussian_lic_tpu.models.gaussians import initialize_map
    from gaussian_lic_tpu.utils.synthetic import make_sequence, make_world

    P = 64
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-0.7, 0.7, P),
                    np.full(P, 4.0)], axis=1).astype(np.float32)
    cols = rng.uniform(0.05, 0.95, (P, 3)).astype(np.float32)
    gm = initialize_map(pts, cols, np.full(P, 4.0, np.float32), focal=60.0,
                        scaling_scale=8.0, sh_degree=0, capacity=P)
    world = make_world(rng, n_points=64)
    frames = make_sequence(world, n_frames=1, points_per_frame=32, rng=rng)
    return gm, frames


def _keyframes(intr, frames, capacity):
    from gaussian_lic_tpu.engine.dataset import KeyframeBuffer, build_camera

    kf = KeyframeBuffer.empty(capacity, intr)
    for i, f in enumerate(frames):
        kf = kf.set_frame(i, build_camera(intr, f), f.image_u8())
    return kf


def _map_dict(prefix: str, gm) -> dict:
    out = {f"{prefix}_{name}": np.asarray(getattr(gm, name)) for name in GM_FIELDS}
    out[f"{prefix}_count"] = np.int32(int(gm.count))
    return out


def sharded_binning(mesh, n_dev, grid, band_n_ty, K, m_pair, inputs):
    """bin_gaussians_sharded on every device of `mesh` (replicated inputs):
    each output stacked over the devices, (D, ...)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gaussian_lic_tpu.ops.blend_pallas import CHUNK
    from gaussian_lic_tpu.parallel.sharded import AXIS_TILES, bin_gaussians_sharded

    def body(*args):
        out = bin_gaussians_sharded(*args, grid, axis_name=AXIS_TILES, n_dev=n_dev,
                                    band_n_ty=band_n_ty, max_tiles_per_gaussian=K,
                                    m_pair=m_pair, align=CHUNK)
        return tuple(x[None] for x in out)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(),) * 6,
                               out_specs=(P(AXIS_TILES),) * 7, check_vma=False))
    return [np.asarray(x) for x in fn(*inputs)]


BIN_FIELDS = ("sorted_gauss", "tile_starts", "tile_lens", "cnt", "num_valid",
              "budget_lost", "truncated")


def make_parallel() -> dict:
    """JAX's sharded functions at D = 2 and 4: the binning of camera 0's
    projection (bin_gaussians_sharded, per device), make_sharded_render on
    keyframe 0 of the setup scene and of the tied-depth scene, and two steps
    of make_sharded_train_step(with_grads=True) on keyframes 0 and 1."""
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.camera import Intrinsics
    from gaussian_lic_tpu.engine.dataset import KeyframeBuffer
    from gaussian_lic_tpu.engine.trainer import PARAM_GROUPS
    from gaussian_lic_tpu.ops import adam as adam_ops
    from gaussian_lic_tpu.ops.projection import OPACITY_THRESHOLD, project_gaussians
    from gaussian_lic_tpu.ops.rasterize import _splat_budget_for
    from gaussian_lic_tpu.parallel import (
        make_mesh, make_sharded_render, make_sharded_train_step,
    )
    from gaussian_lic_tpu.parallel.sharded import _band_geometry

    cfg = parallel_params()
    intr = Intrinsics(**PARALLEL_RIG)
    gm, frames = parallel_scene()
    kf = _keyframes(intr, frames, cfg.max_train_keyframes)
    tgm, tframes = tied_scene()
    tkf = _keyframes(intr, tframes, 2)
    tcfg = parallel_params(initial_capacity=64)
    out = dict(_map_dict("map", gm), **_map_dict("tied", tgm),
               **{f"frames_{k}": v for k, v in _frames_dict(frames).items()},
               **{f"tied_frames_{k}": v for k, v in _frames_dict(tframes).items()})

    # camera 0's projection: the binning's inputs, as render_band makes them
    cam = KeyframeBuffer.camera(kf, intr, jnp.asarray(0, jnp.int32))
    proj = project_gaussians(gm.xyz, gm.scaling, gm.rotation, cam)
    opa = gm.opacity
    active = (proj.in_front & proj.det_valid & (opa >= OPACITY_THRESHOLD)
              & gm.active_mask())
    radius = jnp.where(active, proj.radius, 0.0)
    inputs = (proj.xy, proj.depth, proj.conic, opa, radius, active)
    for name, a in zip(("xy", "depth", "conic", "opacity", "radius", "active"), inputs):
        out[f"bin_in_{name}"] = np.asarray(a)

    zeros = {name: adam_ops.AdamState(jnp.zeros_like(gm.trainable()[name]),
                                      jnp.zeros_like(gm.trainable()[name]))
             for name in PARAM_GROUPS}
    for D in PARALLEL_MESHES:
        mesh = make_mesh(D)
        grid, band_n_ty = _band_geometry(intr, cfg, D)
        m_local = max(_splat_budget_for(gm.capacity, cfg) // D, 1 << 10)
        m_pair = max(-(-int(cfg.bucket_overprovision * m_local) // D) // 256 * 256, 512)
        out[f"bin{D}_m_pair"] = np.int32(m_pair)
        for f, a in zip(BIN_FIELDS, sharded_binning(
                mesh, D, grid, band_n_ty, cfg.max_tiles_per_gaussian, m_pair, inputs)):
            out[f"bin{D}_{f}"] = a
        img, ft = make_sharded_render(intr, cfg, mesh)(gm, kf, jnp.asarray(0, jnp.int32))
        out[f"render{D}_image"], out[f"render{D}_final_t"] = np.asarray(img), np.asarray(ft)
        img, ft = make_sharded_render(intr, tcfg, mesh)(tgm, tkf, jnp.asarray(0, jnp.int32))
        out[f"tied{D}_image"], out[f"tied{D}_final_t"] = np.asarray(img), np.asarray(ft)
        step = make_sharded_train_step(intr, cfg, mesh, with_grads=True)
        gm_s, opt_s = gm, zeros
        for i in range(2):
            gm_s, opt_s, m = step(gm_s, opt_s, kf, jnp.asarray(i % 2, jnp.int32),
                                  jnp.asarray(i + 1, jnp.int32))
            tag = f"step{D}_{i}"
            out[f"{tag}_loss"] = np.float32(m["loss"])
            out[f"{tag}_n_visible"] = np.int32(m["n_visible"])
            for g in PARAM_GROUPS:
                out[f"{tag}_grad_{g}"] = np.asarray(m["grads"][g])
            for name in GM_FIELDS:
                out[f"{tag}_{name}"] = np.asarray(getattr(gm_s, name))
    return out


SHARDED_BUNDLE_IDS = (0, 1, 0)


def make_sharded_bundle() -> dict:
    """JAX's make_sharded_train_bundle(intr, cfg, make_mesh(D), 3) at D = 2
    and 4 on the parallel case's setup scene (parallel.npz holds it) from
    zero moments, keyframes SHARDED_BUNDLE_IDS, exposure step 1: the final
    map and the bundle's metrics; and the same 3 steps of
    make_sharded_train_step(with_grads=True), whose gradients tell the
    tests' float-noise lanes."""
    _jax_cpu()
    import jax.numpy as jnp

    from gaussian_lic_tpu.camera import Intrinsics
    from gaussian_lic_tpu.engine.trainer import PARAM_GROUPS
    from gaussian_lic_tpu.ops import adam as adam_ops
    from gaussian_lic_tpu.parallel import (
        make_mesh, make_sharded_train_bundle, make_sharded_train_step,
    )

    cfg = parallel_params()
    intr = Intrinsics(**PARALLEL_RIG)
    gm, frames = parallel_scene()
    kf = _keyframes(intr, frames, cfg.max_train_keyframes)
    zeros = {name: adam_ops.AdamState(jnp.zeros_like(gm.trainable()[name]),
                                      jnp.zeros_like(gm.trainable()[name]))
             for name in PARAM_GROUPS}
    k = len(SHARDED_BUNDLE_IDS)
    out = dict(idxs=np.array(SHARDED_BUNDLE_IDS, np.int32), map_count=np.int32(int(gm.count)))
    for D in PARALLEL_MESHES:
        mesh = make_mesh(D)
        gm_b, _, m = make_sharded_train_bundle(intr, cfg, mesh, k)(
            gm, zeros, kf, jnp.asarray(SHARDED_BUNDLE_IDS, jnp.int32), jnp.asarray(1, jnp.int32))
        for name in GM_FIELDS:
            out[f"bundle{D}_{name}"] = np.asarray(getattr(gm_b, name))
        for name in BUNDLE_METRICS:
            out[f"bundle{D}_m_{name}"] = np.asarray(m[name])
        step = make_sharded_train_step(intr, cfg, mesh, with_grads=True)
        gm_s, opt_s = gm, zeros
        for i, idx in enumerate(SHARDED_BUNDLE_IDS):
            gm_s, opt_s, m = step(gm_s, opt_s, kf, jnp.asarray(idx, jnp.int32),
                                  jnp.asarray(i + 1, jnp.int32))
            tag = f"step{D}_{i}"
            out[f"{tag}_loss"] = np.float32(m["loss"])
            out[f"{tag}_n_visible"] = np.int32(m["n_visible"])
            for g in PARAM_GROUPS:
                out[f"{tag}_grad_{g}"] = np.asarray(m["grads"][g])
            for name in GM_FIELDS:
                out[f"{tag}_{name}"] = np.asarray(getattr(gm_s, name))
    return out


CASES = {"blend": make_blend, "nan_row": make_nan_row, "tile_shapes": make_tile_shapes,
         "train": make_train,
         "engine": make_engine, "bundle": make_bundle, "finalize": make_finalize,
         "parallel": make_parallel, "sharded_bundle": make_sharded_bundle}


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
