"""The port's map extension against the benchmark's plain extend.

`MappingEngine._extend` (the accumulated points padded to a power-of-two
multiple of `densify_budget`, then `extend_step`: the `no_color` render,
projection, per-pixel nearest-depth dedup, the alpha < 0.99 test and the
masked append) on the CPU's plain path, held against
`benchmark/reference/extend.py`, which is written from the original's
`extend` (gaussian.cpp:499-638) and imports nothing of the program, on
seeded small maps: the appended count and every row of every field equal,
bit for bit. The cases: ties in pixel and depth, points behind the camera
and outside the image, pixels the map already covers opaquely, no
candidates at all, and more candidates than `densify_budget` (M doubled).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import ROOT

from gaussian_lic_tpu_torch.camera import make_camera
from gaussian_lic_tpu_torch.config import Params
from gaussian_lic_tpu_torch.engine.dataset import FrameInput, KeyframeBuffer
from gaussian_lic_tpu_torch.engine.trainer import MappingEngine
from gaussian_lic_tpu_torch.models.gaussians import GaussianMap

sys.path.append(os.path.join(ROOT, "benchmark"))
from reference import extend as plain_extend  # noqa: E402
from reference import splat  # noqa: E402

W, H = 64, 48
ROWS, LIVE = 1024, 300
CFG = dict(width=W, height=H, fx=50.0, fy=52.0, cx=31.3, cy=24.6, tile_h=32, tile_w=32,
           max_tiles_per_gaussian=16, skybox_points_num=0, densify_budget=256,
           scaling_scale=1.0, seed=0)
F32 = np.float32


def _pose(yaw: float, eye=(0.0, 0.0, 0.0)):
    """World-from-camera (R_wc, t_wc): a turn of `yaw` about the y axis."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return R.astype(F32), np.asarray(eye, F32)


def _map(rng, opaque: bool):
    """A seeded map of LIVE Gaussians in ROWS rows in front of the keyframe
    camera; with `opaque`, 40 of them stacked at the image's centre, at
    opacity 0.993, so that pixels there read alpha >= 0.99."""
    z = rng.uniform(2.0, 10.0, LIVE)
    xyz = np.stack([rng.uniform(-0.6, 0.6, LIVE) * z, rng.uniform(-0.45, 0.45, LIVE) * z, z], 1)
    logit = rng.uniform(-3.0, 1.0, LIVE)
    log_scale = np.log(z * rng.uniform(0.01, 0.05, LIVE))[:, None].repeat(3, 1)
    if opaque:
        xyz[:40] = [0.0, 0.0, 3.0] + rng.normal(0.0, 0.01, (40, 3))
        logit[:40] = 5.0
        log_scale[:40] = np.log(0.3)
    quat = rng.normal(0.0, 1.0, (LIVE, 4))
    rows = dict(xyz=xyz, dc=rng.normal(0.0, 0.5, (LIVE, 3)),
                sh_rest=rng.normal(0.0, 0.1, (LIVE, 15, 3)), opacity=logit, log_scale=log_scale,
                quat=quat)
    out = {}
    for g, v in rows.items():
        t = torch.zeros((ROWS,) + v.shape[1:], dtype=torch.float32)
        if g == "quat":
            t[:, 0] = 1.0
        if g == "opacity":
            t[:] = float(np.log(0.1 / 0.9))
        t[:LIVE] = torch.as_tensor(v.astype(F32))
        out[g] = t
    return out


def _points(rng, n, R_wc, t_wc, z_range=(1.0, 12.0), margin=0.0):
    """n world points seen from the camera (R_wc, t_wc): depth in
    `z_range`, projecting up to `margin` of the image outside it."""
    z = rng.uniform(*z_range, n)
    u = rng.uniform(-margin, 1.0 + margin, n) * W
    v = rng.uniform(-margin, 1.0 + margin, n) * H
    cam = np.stack([(u - CFG["cx"]) * z / CFG["fx"], (v - CFG["cy"]) * z / CFG["fy"], z], 1)
    return (cam @ R_wc.T.astype(np.float64) + t_wc).astype(F32)


def _frame(R_wc, t_wc, pts, rng):
    return dict(R_wc=R_wc, t_wc=t_wc, points=np.asarray(pts, F32),
                colors=rng.uniform(0.05, 0.95, (len(pts), 3)).astype(F32))


def _ties(rng, R_kf, t_kf):
    """Points repeated (same pixel, same depth: the first wins), along one
    ray at several depths (the nearest wins) and at one depth inside one
    pixel; besides, a frame seen from elsewhere."""
    base = _points(rng, 120, R_kf, t_kf)
    ray = base[:10, None, :] * np.array([1.0, 0.7, 1.3, 0.9])[None, :, None]
    same_z = base[10:20].copy()
    same_z[:, 0] += 1e-4
    pts = np.concatenate([base, base[:15], ray.reshape(-1, 3).astype(F32), same_z])
    R2, t2 = _pose(0.05, (0.1, 0.0, -0.2))
    return [_frame(R2, t2, _points(rng, 80, R2, t2), rng), _frame(R_kf, t_kf, pts, rng)]


def _behind_and_outside(rng, R_kf, t_kf):
    """Points the keyframe sees past the image's edges, and points behind
    it that a camera turned the other way observed (a positive depth
    there)."""
    R_back, t_back = _pose(np.pi, (0.0, 0.0, 0.5))
    return [_frame(R_kf, t_kf, _points(rng, 150, R_kf, t_kf, margin=0.6), rng),
            _frame(R_back, t_back, _points(rng, 150, R_back, t_back, z_range=(0.6, 6.0),
                                           margin=0.3), rng)]


def _opaque(rng, R_kf, t_kf):
    return [_frame(R_kf, t_kf, _points(rng, 300, R_kf, t_kf), rng)]


def _empty(rng, R_kf, t_kf):
    return [_frame(R_kf, t_kf, np.zeros((0, 3), F32), rng)]


def _past_budget(rng, R_kf, t_kf):
    """600 candidates, over twice densify_budget: M is 1024."""
    return [_frame(R_kf, t_kf, _points(rng, 300, R_kf, t_kf), rng),
            _frame(R_kf, t_kf, _points(rng, 300, R_kf, t_kf, z_range=(0.5, 4.0)), rng)]


CASES = {"ties": (_ties, False), "behind_and_outside": (_behind_and_outside, False),
         "opaque_pixels": (_opaque, True), "no_candidates": (_empty, False),
         "past_densify_budget": (_past_budget, False)}


def _engine(params, R_kf, t_kf):
    eng = MappingEngine(Params(**CFG), device="cpu")
    eng.kf_buffer = KeyframeBuffer.empty(2, eng.intr)
    eng.kf_buffer.set_frame(0, make_camera(eng.intr, R_kf, t_kf),
                            np.zeros((H, W, 3), np.uint8))
    eng.kf_count = 1
    eng.gm = GaussianMap(
        xyz=params["xyz"].clone(), dc=params["dc"].clone(), sh_rest=params["sh_rest"].clone(),
        log_scale=params["log_scale"].clone(), quat=params["quat"].clone(),
        opa_logit=params["opacity"].clone(), count=torch.tensor(LIVE, dtype=torch.int32),
        exposure=torch.cat([torch.eye(3), torch.zeros((3, 1))], 1), sh_degree=3)
    return eng


@pytest.mark.parametrize("case", sorted(CASES))
def test_extend_matches_the_plain_extend(case):
    make, opaque = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    params = _map(rng, opaque)
    R_kf, t_kf = _pose(0.1, (0.05, -0.02, 0.0))
    frames = make(rng, R_kf, t_kf)

    eng = _engine(params, R_kf, t_kf)
    for i, f in enumerate(frames):
        eng.accum.add(FrameInput(timestamp=0.1 * i, image=np.zeros((H, W, 3), np.uint8), **f))
    n = eng.accum.total
    added = eng._extend(0)

    p = dict(CFG, lambda_dssim=0.2)
    cam = splat.camera(p, torch.as_tensor(R_kf), torch.as_tensor(t_kf))
    budget = splat.splat_budget(ROWS, 1.7, CFG["max_tiles_per_gaussian"])
    ref, count, ref_added = plain_extend.extend(params, LIVE, cam,
                                                *plain_extend.gathered(frames), p, budget)

    assert added == ref_added and int(eng.gm.count) == count == LIVE + added
    got = eng.gm.trainable()
    for g, t in ref.items():
        assert torch.equal(got[g], t), g
    if case == "no_candidates":
        assert n == 0 and added == 0
    elif case == "past_densify_budget":
        assert n > 2 * CFG["densify_budget"] and added > 0
    else:
        assert 0 < added < n


def test_the_cases_reach_what_they_name():
    """Each case's inputs hold what its name says, by the reference's own
    arithmetic: ties kept out, points behind the camera and outside the
    image, opaque pixels that turn candidates away."""
    R_kf, t_kf = _pose(0.1, (0.05, -0.02, 0.0))
    p = dict(CFG, lambda_dssim=0.2)
    cam = splat.camera(p, torch.as_tensor(R_kf), torch.as_tensor(t_kf))
    budget = splat.splat_budget(ROWS, 1.7, CFG["max_tiles_per_gaussian"])

    def look(case):
        make, opaque = CASES[case]
        rng = np.random.default_rng(sorted(CASES).index(case) + 11)
        params = _map(rng, opaque)
        pts, _, _ = plain_extend.gathered(make(rng, R_kf, t_kf))
        x, y, z = plain_extend.pixels(torch.as_tensor(pts), cam, CFG["cx"], CFG["cy"])
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        pix = torch.where(inside, y * W + x, torch.full_like(x, -1))
        return params, pix, z, inside

    _, pix, z, inside = look("ties")
    on = pix[inside]
    assert len(torch.unique(on)) < len(on) - 40
    key = torch.stack([pix, z.view(torch.int32).long()], 1)[inside]
    assert len(torch.unique(key, dim=0)) < len(key) - 10
    _, _, z, inside = look("behind_and_outside")
    assert int((~inside).sum()) > 50 and int((z < 0).sum()) > 50
    params, pix, z, inside = look("opaque_pixels")
    _, _, _, _, final_t, _ = splat.render(params, LIVE, cam, 32, 16, budget)
    alpha = 1.0 - final_t[:H, :W].reshape(-1)
    assert int((alpha[pix[inside]] >= plain_extend.ALPHA_LIMIT).sum()) > 5
