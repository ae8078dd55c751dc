"""Port parity: multi-GPU training and rendering (gaussian_lic_tpu_torch/parallel/)
on 2 and 4 gloo ranks on the CPU, against the JAX package's sharded functions
on 2- and 4-device CPU meshes and against the port's own single-device path.

The JAX side is the `parallel` golden (tools/make_torch_goldens.py --only
parallel; `live` reruns it, minutes): the setup scene of
tests/test_parallel.py (128x64 in 8x128 tiles, 512 Gaussians), its tied-depth
scene, and two sharded train steps; and the `sharded_bundle` golden (`--only
sharded_bundle`): a 3-step make_sharded_train_bundle on that scene and its 3
steps one by one. The port's side runs in one `parallel.spawn` per world
size that does every case and returns numpy results. Tolerances are those of
tests/test_parallel.py:
  * binning: the sorted lists, tile ranges and counters exactly;
  * render: image and final_T atol 1e-5; on tied depths 2e-6 (a tie-order
    swap shows as ~1e-2);
  * train step: loss within 1e-6, pre-Adam gradients rtol 3e-4 / atol 3e-7,
    updated params within 2e-5 on the gradient-carrying lanes (lanes whose
    gradient is float noise, < 3e-6 in both runs, take sparse Adam's
    sign-like first step: they are held to 10 lr);
  * the bundle: against k calls of the port's own sharded step exactly;
    against JAX's steps by the train step's rule for the two steps that
    rule was set for, and its result against JAX's bundle by
    tests/test_torch_bundle.py's rule (loss rel 1e-4, the ten-step rule
    for the map, the counters and visible_sum exactly).
"""

import contextlib
import io
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401 (cuda_device: a fixture)
    GOLDEN_SOURCES, cuda_device, frames_from, load_golden,
)

from gaussian_lic_tpu_torch.camera import Intrinsics
from gaussian_lic_tpu_torch.config import Params
from gaussian_lic_tpu_torch.engine.dataset import KeyframeBuffer, build_camera
from gaussian_lic_tpu_torch import parallel
from gaussian_lic_tpu_torch.engine.trainer import (
    PARAM_GROUPS, MappingEngine, _bundle_metrics, train_step,
)
from gaussian_lic_tpu_torch.models.gaussians import GaussianMap, LearningRates
from gaussian_lic_tpu_torch.ops.adam import AdamState
from gaussian_lic_tpu_torch.ops.rasterize import render_map
from gaussian_lic_tpu_torch.parallel import (
    bin_gaussians_sharded, gather_state, make_mesh, make_sharded_render,
    make_sharded_train_bundle, make_sharded_train_step, shard_state, spawn,
)
from gaussian_lic_tpu_torch.parallel.collectives import all_gather, halo_exchange
from gaussian_lic_tpu_torch.parallel.sharded import _band_geometry
from gaussian_lic_tpu_torch.ops import tiles as ttiles

MESHES = (2, 4)
SPAWN_TIMEOUT = 600   # seconds; a hung collective fails the test, not the suite
MAP_FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit")
BUNDLE_METRICS = ("loss", "n_visible", "visible_sum", "budget_lost", "truncated", "overflow")
BUNDLE_IDS = (0, 1, 0)     # the sharded_bundle golden's keyframes, from exposure step 1
BIN_FIELDS = ("sorted_gauss", "tile_starts", "tile_lens", "cnt", "num_valid",
              "budget_lost", "truncated")
RIG = dict(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0)
CFG = dict(RIG, skybox_points_num=0, initial_capacity=512, max_tiles_per_gaussian=16,
           max_train_keyframes=4, tile_h=8, tile_w=128)


# ----------------------------------------------------------------- scenes

def golden_map(d, prefix, sh_degree=3):
    count = int(d[f"{prefix}_count"])
    gm = GaussianMap.empty(d[f"{prefix}_xyz"].shape[0], sh_degree)
    gm = gm.replace(**{f: torch.tensor(d[f"{prefix}_{f}"]) for f in MAP_FIELDS},
                    count=torch.tensor(count, dtype=torch.int32))
    return gm


def golden_keyframes(d, prefix, intr, capacity, height=None):
    frames = frames_from({k[len(prefix) + 1:]: v for k, v in d.items()
                          if k.startswith(prefix + "_")})
    kf = KeyframeBuffer.empty(capacity, intr)
    for i, f in enumerate(frames):
        kf.set_frame(i, build_camera(intr, f), f.image_u8()[:height])
    return kf


def zero_moments(gm):
    return {k: AdamState.zeros_like(v) for k, v in gm.trainable().items()}


def setup_scene(d, height=64, **cfg_kw):
    """(intr, cfg, gm, kf) of the golden's setup scene; `height` < 64 crops
    the rig and the keyframes (the padded grid then has rows past the image)."""
    intr = Intrinsics(**dict(RIG, height=height))
    cfg = Params(**dict(CFG, height=height, **cfg_kw))
    return intr, cfg, golden_map(d, "map"), golden_keyframes(d, "frames", intr, 4, height)


def overflow_scene():
    """tests/test_parallel.py:315-343's bucket-overflow scene, built with the
    port's own synthetic world: 256x128, huge splats, splat budget 0.5 per
    Gaussian, so a source shard sends more into one band than its bucket."""
    from gaussian_lic_tpu_torch.models.gaussians import initialize_map
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    rig = dict(width=256, height=128, fx=60.0, fy=60.0, cx=128.0, cy=64.0)
    intr = Intrinsics(**rig)
    cfg = Params(**rig, skybox_points_num=0, initial_capacity=512, max_train_keyframes=2,
                 tile_h=32, tile_w=32, scaling_scale=60.0, splat_budget_factor=0.5)
    rng = np.random.default_rng(23)
    frames = make_sequence(make_world(rng, n_points=220, intr=intr), n_frames=2,
                           points_per_frame=150, rng=rng)
    pts = np.concatenate([f.points for f in frames])
    cols = np.concatenate([f.colors for f in frames])
    cam0 = build_camera(intr, frames[0])
    z = (pts @ cam0.pose.R_cw.numpy().T + cam0.pose.t_cw.numpy())[:, 2]
    keep = z > 0
    gm = initialize_map(pts[keep], cols[keep], z[keep].astype(np.float32), focal=intr.fx,
                        scaling_scale=60.0, sh_degree=3, capacity=512, device="cpu")
    kf = KeyframeBuffer.empty(2, intr)
    for i, f in enumerate(frames):
        kf.set_frame(i, build_camera(intr, f), f.image_u8())
    return intr, cfg, gm, kf


def two_steps(step, gm, opt, kf, mesh=None, n_steps=2):
    """[(loss, n_visible, grads, params, overflow)] of n steps on keyframes
    0, 1, ...; with a mesh, `step` is the sharded step on this rank's shard
    and params are gathered whole."""
    if mesh is not None:
        gm, opt = shard_state(gm, opt, mesh)
    out = []
    for i in range(n_steps):
        gm, opt, m = step(gm, opt, kf, i % 2, i + 1)
        whole = gather_state(gm, opt, mesh)[0] if mesh is not None else gm
        out.append(dict(loss=float(m["loss"]), n_visible=int(m["n_visible"]),
                        grads={k: v.detach().numpy() for k, v in m["grads"].items()},
                        params={f: getattr(whole, f).detach().numpy() for f in MAP_FIELDS},
                        budget_lost=int(m["budget_lost"]), overflow=int(m["overflow"])))
    return out


def numpy_state(gm, opt, mesh):
    """The gathered map fields, exposure and Adam moments as numpy."""
    gm, opt = gather_state(gm, opt, mesh)
    out = {f: getattr(gm, f).detach().numpy() for f in MAP_FIELDS + ("exposure",)}
    out.update({f"{c}_{k}": getattr(st, a).numpy() for k, st in opt.items()
                for c, a in (("m", "exp_avg"), ("v", "exp_avg_sq"))})
    return out


def bundle_vs_steps(intr, cfg, gm, opt, kf, mesh):
    """A 3-step make_sharded_train_bundle on BUNDLE_IDS from exposure step 1
    and the same 3 make_sharded_train_step calls (with_grads: the gradients
    tell the noise lanes; the update is the plain step's): (the bundle's
    state and metrics, the steps' records, their final state)."""
    gs, os_ = shard_state(gm, opt, mesh)
    gb, ob, mb = make_sharded_train_bundle(intr, cfg, mesh, len(BUNDLE_IDS))(
        gs, os_, kf, torch.tensor(BUNDLE_IDS), 1)
    step = make_sharded_train_step(intr, cfg, mesh, with_grads=True)
    steps, metrics = [], []
    for i, idx in enumerate(BUNDLE_IDS):
        gs, os_, m = step(gs, os_, kf, idx, i + 1)
        metrics.append(m)
        steps.append(dict(loss=float(m["loss"]), n_visible=int(m["n_visible"]),
                          grads={k: v.numpy() for k, v in m["grads"].items()},
                          params={f: getattr(gather_state(gs, os_, mesh)[0], f).numpy()
                                  for f in MAP_FIELDS}))
    want = _bundle_metrics(metrics)
    return dict(state=numpy_state(gb, ob, mesh), steps_state=numpy_state(gs, os_, mesh),
                metrics={k: mb[k].numpy() for k in BUNDLE_METRICS},
                steps_metrics={k: want[k].numpy() for k in BUNDLE_METRICS}, steps=steps)


# ------------------------------------------------------- the ranks' work

def rank_cases(mesh, d):
    """Every sharded case on this rank; returns numpy results."""
    D, r = mesh.size, mesh.rank
    out = {}
    intr, cfg, gm, kf = setup_scene(d)

    # distributed binning of the golden's projected inputs
    grid, band_n_ty = _band_geometry(intr, cfg, D)
    names = ("xy", "depth", "conic", "opacity", "radius", "active")
    res = bin_gaussians_sharded(
        *(torch.tensor(d[f"bin_in_{k}"]) for k in names), grid, mesh=mesh,
        band_n_ty=band_n_ty, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        m_pair=int(d[f"bin{D}_m_pair"]), align=256)
    out["bin"] = {f: x.numpy() for f, x in zip(BIN_FIELDS, res)}

    img, ft = make_sharded_render(intr, cfg, mesh)(gm, kf, 0)
    out["render"] = (img.numpy(), ft.numpy())
    tintr = Intrinsics(**RIG)
    tcfg = Params(**dict(CFG, initial_capacity=64))
    tgm = golden_map(d, "tied", sh_degree=0)
    img, ft = make_sharded_render(tintr, tcfg, mesh)(
        tgm, golden_keyframes(d, "tied_frames", tintr, 2), 0)
    out["tied"] = (img.numpy(), ft.numpy())

    step = make_sharded_train_step(intr, cfg, mesh, with_grads=True)
    out["steps"] = two_steps(step, gm, zero_moments(gm), kf, mesh)

    # the replicated-loss path (image rows past the padded grid's) and exposure
    intr60, cfg60, gm60, kf60 = setup_scene(d, height=60)
    out["steps60"] = two_steps(make_sharded_train_step(intr60, cfg60, mesh, with_grads=True),
                               gm60, zero_moments(gm60), kf60, mesh)
    intr_e, cfg_e, gm_e, kf_e = setup_scene(d, apply_exposure=True)
    gm_e = gm_e.replace(exposure=exposure_matrix())
    opt_e = dict(zero_moments(gm_e), exposure=AdamState.zeros_like(gm_e.exposure))
    s_e = make_sharded_train_step(intr_e, cfg_e, mesh, with_grads=True)
    gs, os_ = shard_state(gm_e, opt_e, mesh)
    _, os_, m = s_e(gs, os_, kf_e, 0, 1)
    out["exposure"] = dict(loss=float(m["loss"]), exp_avg=os_["exposure"].exp_avg.numpy(),
                           grads={k: v.numpy() for k, v in m["grads"].items()})

    # the bundle, from zero moments, on the band loss and with exposure
    out["bundle"] = bundle_vs_steps(intr, cfg, gm, zero_moments(gm), kf, mesh)
    out["bundle_exposure"] = bundle_vs_steps(intr_e, cfg_e, gm_e, opt_e, kf_e, mesh)
    # a map on the card reaching the bundle of a gloo group (no card here:
    # the bundle reads only the map's device before it refuses)
    try:
        make_sharded_train_bundle(intr, cfg, mesh, 1)(OnTheCard(), {}, kf, [0], 1)
        out["gloo_on_the_card"] = None
    except ValueError as e:
        out["gloo_on_the_card"] = str(e)

    intr_o, cfg_o, gm_o, kf_o = overflow_scene()
    _, _, m = make_sharded_train_step(intr_o, cfg_o, mesh)(
        *shard_state(gm_o, zero_moments(gm_o), mesh), kf_o, 0, 1)
    out["overflow"] = {k: float(m[k]) for k in ("budget_lost", "overflow", "loss")}

    # the collectives on their own: rank r's band is filled with r + 1
    band = torch.full((3, 8, 5), float(r + 1), requires_grad=True)
    up, dn = halo_exchange(band, 5, mesh)
    (g_band,) = torch.autograd.grad((up * 10.0 + dn * 100.0).sum(), band)
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    (g_x,) = torch.autograd.grad((all_gather(x, mesh) * torch.arange(1, 2 * D + 1.0)[:, None]).sum(), x)
    out["collectives"] = dict(up=up.detach().numpy(), dn=dn.detach().numpy(),
                              g_band=g_band.numpy(), g_x=g_x.numpy())
    return out


class OnTheCard:
    device = torch.device("cuda", 0)


def exposure_matrix():
    return torch.tensor([[0.9, 0.05, 0.0, 0.02], [0.0, 1.1, 0.0, -0.01],
                         [0.03, 0.0, 0.95, 0.0]], dtype=torch.float32)


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def golden(request):
    return load_golden("parallel", request.param)


@pytest.fixture(scope="module", params=MESHES, ids=lambda D: f"{D}ranks")
def ranks(request, golden):
    """(D, the golden, each rank's results): one spawn per world size."""
    D = request.param
    return D, golden, spawn(rank_cases, D, "cpu", args=(golden,), timeout=SPAWN_TIMEOUT)


# ----------------------------------------------------------------- checks

def assert_steps_match(got, want, lr_map):
    """tests/test_parallel.py:122-175's rule for two runs of steps."""
    noise = {}
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a["loss"] - b["loss"]) < 1e-6, f"step {i} loss {a['loss']} vs {b['loss']}"
        assert a["n_visible"] == b["n_visible"]
        for g, f in zip(PARAM_GROUPS, ("xyz", "dc", "sh_rest", "opa_logit", "log_scale",
                                       "quat")):
            ga, gb = a["grads"][g], b["grads"][g]
            np.testing.assert_allclose(ga, gb, rtol=3e-4, atol=3e-7,
                                       err_msg=f"step {i} grads {g}")
            noise[g] = noise.get(g, np.zeros(ga.shape, bool)) | (
                np.maximum(np.abs(ga), np.abs(gb)) < 3e-6)
            pa, pb = a["params"][f], b["params"][f]
            clean = ~noise[g]
            np.testing.assert_allclose(np.where(clean, pa, 0.0), np.where(clean, pb, 0.0),
                                       atol=2e-5, err_msg=f"step {i} params {f}")
            assert float(np.max(np.abs(pa - pb), initial=0.0, where=noise[g])) <= 10.0 * lr_map[g]


def lr_map_of(cfg):
    lrs = LearningRates.from_params(cfg)
    return dict(xyz=lrs.xyz, dc=lrs.dc, sh_rest=lrs.sh_rest, opacity=lrs.opacity,
                log_scale=lrs.log_scale, quat=lrs.quat)


def golden_steps(d, D):
    return [dict(loss=float(d[f"step{D}_{i}_loss"]), n_visible=int(d[f"step{D}_{i}_n_visible"]),
                 grads={g: d[f"step{D}_{i}_grad_{g}"] for g in PARAM_GROUPS},
                 params={f: d[f"step{D}_{i}_{f}"] for f in MAP_FIELDS}) for i in range(2)]


def single_device_steps(d, n_steps=2, height=64):
    intr, cfg, gm, kf = setup_scene(d, height=height)
    step = lambda g, o, k, i, e: train_step(g, o, k, i, e, intr=intr, cfg=cfg,  # noqa: E731
                                            with_grads=True)
    return two_steps(step, gm, zero_moments(gm), kf, n_steps=n_steps), cfg


class TestShardedBinning:
    def test_matches_jax(self, ranks):
        """Each rank's band list, tile ranges and counters equal JAX's
        bin_gaussians_sharded on the same device of a D-device mesh."""
        D, d, res = ranks
        for r, out in enumerate(res):
            for f in BIN_FIELDS:
                np.testing.assert_array_equal(out["bin"][f], d[f"bin{D}_{f}"][r],
                                              err_msg=f"rank {r} {f}")
        assert sum(int(o["bin"]["num_valid"]) for o in res) > 500

    def test_bands_hold_the_single_device_list(self, ranks):
        """The bands' lists, one after another, are the single-device list of
        the whole image (same tiles, same order)."""
        D, d, res = ranks
        names = ("xy", "depth", "conic", "opacity", "radius", "active")
        grid = ttiles.TileGrid(width=128, height=64, tile_w=128, tile_h=8)
        b = ttiles.bin_gaussians(*(torch.tensor(d[f"bin_in_{k}"]) for k in names), grid,
                                 max_tiles_per_gaussian=16, max_total_splats=1 << 13)
        whole = [int(g) for s, n_ in zip(b.tile_starts.tolist(), b.tile_lens.tolist())
                 for g in b.sorted_gauss[s:s + n_]]
        bands = [int(o["bin"]["sorted_gauss"][s + k]) for o in res
                 for s, n_ in zip(o["bin"]["tile_starts"], o["bin"]["tile_lens"]) for k in range(n_)]
        assert bands == whole


class TestShardedRender:
    def test_matches_jax(self, ranks):
        D, d, res = ranks
        for out in res:   # every rank holds the stitched image
            np.testing.assert_allclose(out["render"][0], d[f"render{D}_image"], atol=1e-5)
            np.testing.assert_allclose(out["render"][1], d[f"render{D}_final_t"], atol=1e-5)

    def test_matches_single_device(self, ranks):
        D, d, res = ranks
        intr, cfg, gm, kf = setup_scene(d)
        ref = render_map(gm, kf.camera(intr, 0), tile_h=8, tile_w=128,
                         max_total_splats=1 << 12)
        np.testing.assert_allclose(res[0]["render"][0], ref.image.numpy(), atol=1e-5)
        np.testing.assert_allclose(res[0]["render"][1], ref.final_T.numpy(), atol=1e-5)

    def test_tied_depths(self, ranks):
        """64 Gaussians of one depth: the blend order within a tile is the
        k-major slot order, which the (key, slot) merge must keep."""
        D, d, res = ranks
        intr = Intrinsics(**RIG)
        ref = render_map(golden_map(d, "tied", sh_degree=0),
                         golden_keyframes(d, "tied_frames", intr, 2).camera(intr, 0),
                         tile_h=8, tile_w=128, max_tiles_per_gaussian=16,
                         max_total_splats=1 << 12)
        assert int(ref.n_contrib.max()) > 8
        img, ft = res[0]["tied"]
        for want_img, want_ft in ((d[f"tied{D}_image"], d[f"tied{D}_final_t"]),
                                  (ref.image.numpy(), ref.final_T.numpy())):
            np.testing.assert_allclose(img, want_img, atol=2e-6)
            np.testing.assert_allclose(ft, want_ft, atol=2e-6)


@pytest.mark.parametrize("lambda_erank", [0.0, 0.1], ids=["no_erank", "erank"])
def test_one_rank_sharded_step_equals_train_step(lambda_erank):
    """The sharded step at D = 1 (a one-rank gloo group in this process)
    against train_step, two steps by tests/test_parallel.py's rule: both
    hand the stored log_scale, quat and opa_logit to the preprocess (the
    activations inside it), with erank's own exp where lambda_erank > 0."""
    import torch.distributed as dist

    d = load_golden("parallel", "file")
    intr, cfg, gm, kf = setup_scene(d, lambda_erank=lambda_erank)
    mesh = make_mesh(1, device="cpu")
    try:
        got = two_steps(make_sharded_train_step(intr, cfg, mesh, with_grads=True), gm,
                        zero_moments(gm), kf, mesh)
    finally:
        dist.destroy_process_group()
    step = lambda g, o, k, i, e: train_step(g, o, k, i, e, intr=intr, cfg=cfg,  # noqa: E731
                                            with_grads=True)
    want = two_steps(step, gm, zero_moments(gm), kf)
    assert_steps_match(got, want, lr_map_of(cfg))
    assert all(np.abs(s["grads"]["opacity"]).max() > 0 for s in got)


class TestShardedTrainStep:
    def test_two_steps_match_jax(self, ranks):
        D, d, res = ranks
        _, cfg, _, _ = setup_scene(d)
        for out in res:
            assert_steps_match(out["steps"], golden_steps(d, D), lr_map_of(cfg))

    def test_two_steps_match_single_device(self, ranks):
        D, d, res = ranks
        ref, cfg = single_device_steps(d)
        assert_steps_match(res[0]["steps"], ref, lr_map_of(cfg))

    def test_replicated_loss_path(self, ranks):
        """A 60-row image in 8-row tiles: the last band holds rows past the
        image, so the step gathers the image and takes the loss / D."""
        D, d, res = ranks
        ref, cfg = single_device_steps(d, height=60)
        assert_steps_match(res[0]["steps60"], ref, lr_map_of(cfg))

    def test_exposure(self, ranks):
        """apply_exposure on the band loss: the exposure gradient is summed
        over the ranks before the dense Adam step."""
        D, d, res = ranks
        intr, cfg, gm, kf = setup_scene(d, apply_exposure=True)
        gm = gm.replace(exposure=exposure_matrix())
        opt = dict(zero_moments(gm), exposure=AdamState.zeros_like(gm.exposure))
        _, opt2, m = train_step(gm, opt, kf, 0, 1, intr=intr, cfg=cfg, with_grads=True)
        got = res[0]["exposure"]
        assert abs(got["loss"] - float(m["loss"])) < 1e-6
        np.testing.assert_allclose(got["exp_avg"], opt2["exposure"].exp_avg.numpy(),
                                   rtol=3e-4, atol=3e-8)
        assert np.abs(got["exp_avg"]).max() > 0
        for g in PARAM_GROUPS:
            np.testing.assert_allclose(got["grads"][g], m["grads"][g].numpy(), rtol=3e-4,
                                       atol=3e-7, err_msg=g)

    def test_bucket_overflow_reaches_the_metrics(self, ranks):
        D, _, res = ranks
        m = res[0]["overflow"]
        assert m["budget_lost"] > 0 and m["overflow"] >= m["budget_lost"]
        assert np.isfinite(m["loss"])
        assert all(o["overflow"] == m for o in res)   # summed over the ranks


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def bundle_golden(request):
    return load_golden("sharded_bundle", request.param)


def golden_bundle_steps(g, D):
    """JAX's 3 sharded steps of the sharded_bundle golden, as records."""
    return [dict(loss=float(g[f"step{D}_{i}_loss"]), n_visible=int(g[f"step{D}_{i}_n_visible"]),
                 grads={k: g[f"step{D}_{i}_grad_{k}"] for k in PARAM_GROUPS},
                 params={f: g[f"step{D}_{i}_{f}"] for f in MAP_FIELDS})
            for i in range(len(BUNDLE_IDS))]


class TestShardedTrainBundle:
    @pytest.mark.parametrize("case", ["bundle", "bundle_exposure"])
    def test_equals_the_steps(self, ranks, case):
        """make_sharded_train_bundle(k=3) on keyframes (0, 1, 0) is three
        calls of make_sharded_train_step, bit for bit: the map, the exposure,
        every Adam moment and every aggregated metric."""
        D, _, res = ranks
        for r, out in enumerate(res):
            b = out[case]
            assert set(b["state"]) == set(b["steps_state"]) and "m_xyz" in b["state"]
            for k, v in b["steps_state"].items():
                np.testing.assert_array_equal(b["state"][k], v, err_msg=f"rank {r} {k}")
            for k in BUNDLE_METRICS:
                np.testing.assert_array_equal(b["metrics"][k], b["steps_metrics"][k],
                                              err_msg=f"rank {r} {k}")
            assert int(b["metrics"]["visible_sum"]) > int(b["metrics"]["n_visible"]) > 0
        if case == "bundle_exposure":
            assert np.abs(res[0][case]["state"]["m_exposure"]).max() > 0

    def test_matches_jax(self, ranks, bundle_golden):
        """Against JAX's make_sharded_train_bundle(intr, cfg, make_mesh(D), 3)
        and its 3 steps one by one. The first two steps by the sharded step's
        rule (assert_steps_match, the two steps tests/test_parallel.py holds);
        from the third on, sparse Adam's sign-like first moves on the
        float-noise lanes differ across the packages (JAX's loss is 1.36e-6
        off at step 3, 1.5e-5 relative, as the single-device port's is), so
        the bundle's result is held by the rule of a bundle against JAX's
        (tests/test_torch_bundle.py): loss rel 1e-4, the map by the ten-step
        rule, n_visible, visible_sum and the overflow counters exactly."""
        from test_torch_bundle import assert_params_close

        D, d, res = ranks
        g = bundle_golden
        assert int(g["map_count"]) == int(d["map_count"])
        assert tuple(g["idxs"]) == BUNDLE_IDS
        _, cfg, _, _ = setup_scene(d)
        want = golden_bundle_steps(g, D)
        for out in res:
            b = out["bundle"]
            assert_steps_match(b["steps"][:2], want[:2], lr_map_of(cfg))
            assert float(b["metrics"]["loss"]) == pytest.approx(
                float(g[f"bundle{D}_m_loss"]), rel=1e-4)
            for k in ("n_visible", "visible_sum", "budget_lost", "truncated", "overflow"):
                assert int(b["metrics"][k]) == int(g[f"bundle{D}_m_{k}"]), k
            assert_params_close(SimpleNamespace(**b["state"]),
                                {f: g[f"bundle{D}_{f}"] for f in MAP_FIELDS},
                                int(d["map_count"]))

    def test_steps_match_single_device(self, ranks):
        """The bundle's 3 sharded steps against 3 single-device train steps
        of the port, by the sharded step's rule at every step."""
        D, d, res = ranks
        ref, cfg = single_device_steps(d, n_steps=len(BUNDLE_IDS))
        for out in res:
            assert_steps_match(out["bundle"]["steps"], ref, lr_map_of(cfg))


    def test_cuda_map_on_gloo_raises(self, ranks):
        """A graph cannot capture gloo's collectives: a CUDA map reaching the
        bundle of a gloo group raises, naming the backend, and does not run
        the eager steps instead."""
        _, _, res = ranks
        for out in res:
            assert out["gloo_on_the_card"] is not None and "gloo" in out["gloo_on_the_card"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("apply_exposure", [False, True], ids=["plain", "exposure"])
def test_sharded_graph_bundle_on_the_card(cuda_device, apply_exposure):
    """make_sharded_train_bundle on a one-rank NCCL mesh, one CUDA graph of 4
    sharded steps and their collectives, against the 4 eager sharded steps
    on the card from a seeded 2,000-Gaussian bench state at 64x64: the loss
    and map by tests/test_torch_bundle.py's rules (K2's atomics sum in
    another order each run), the exposure and its moments likewise, the
    eager steps' K1/K2 launches counted at the replay; the next bundle takes
    the returned state with nothing copied; a gloo group on the card raises."""
    import dataclasses

    import torch.distributed as dist
    from test_torch_bundle import assert_params_close

    from gaussian_lic_tpu_torch.engine.trainer import BundleGraphs
    from gaussian_lic_tpu_torch.ops import blend
    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

    cfg = Params(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0, skybox_points_num=0,
                 initial_capacity=2048, max_tiles_per_gaussian=16, apply_exposure=apply_exposure)
    intr, gm0, kf, opt0 = make_bench_state(cfg, 2000, cuda_device)
    if apply_exposure:
        gm0 = gm0.replace(exposure=exposure_matrix().to(cuda_device))
        opt0 = dict(opt0, exposure=AdamState.zeros_like(gm0.exposure))
    mesh = make_mesh(1, device=cuda_device)
    try:
        gs0, os0 = shard_state(gm0, opt0, mesh)
        idxs = torch.tensor([2, 0, 1, 1], device=cuda_device)
        step = make_sharded_train_step(intr, cfg, mesh)
        blend.reset_launches()

        def inputs():
            return [t.clone() for t in list(gs0.trainable().values()) + [gs0.exposure]
                    + [x for st in os0.values() for x in st]]

        before = inputs()
        g, o = gs0, os0
        for i in range(4):
            g, o, m = step(g, o, kf, int(idxs[i]), 1 + i)
        eager = dict(blend.LAUNCHES)
        # the sharded step stays out of place: it writes none of its inputs
        assert all(torch.equal(a, b) for a, b in zip(before, inputs()))
        graphs = BundleGraphs()
        bundle = make_sharded_train_bundle(intr, cfg, mesh, 4, graphs)
        blend.reset_launches()
        gb, ob, mb = bundle(gs0, os0, kf, idxs, 1)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(before, inputs()))
        assert blend.LAUNCHES == eager == {"forward": 4, "forward_no_color": 0, "backward": 4}
        assert graphs.warmup_launches["forward"] == 1 and len(graphs.captures) == 1
        assert float(mb["loss"]) == pytest.approx(float(m["loss"]), rel=1e-4)
        assert int(mb["n_visible"]) == int(m["n_visible"])
        assert_params_close(gb, {f: getattr(g, f).cpu().numpy() for f in MAP_FIELDS}, 2000)
        if apply_exposure:
            torch.testing.assert_close(gb.exposure, g.exposure, rtol=1e-4, atol=1e-6)
            torch.testing.assert_close(ob["exposure"].exp_avg, o["exposure"].exp_avg,
                                       rtol=1e-3, atol=1e-8)
            assert not torch.equal(gb.exposure, gm0.exposure)
        gc_, _, _ = bundle(gb, ob, kf, idxs, 5)
        assert gc_.xyz is gb.xyz and len(graphs.captures) == 1
        assert blend.LAUNCHES["backward"] == 8

        gloo = dataclasses.replace(mesh, group=dist.new_group(backend="gloo"))
        with pytest.raises(ValueError, match="gloo"):
            make_sharded_train_bundle(intr, cfg, gloo, 4)(gs0, os0, kf, idxs, 1)
    finally:
        dist.destroy_process_group()


class TestCollectives:
    def test_halo_exchange_and_all_gather(self, ranks):
        D, _, res = ranks
        for r, out in enumerate(res):
            c = out["collectives"]
            np.testing.assert_array_equal(c["up"], np.full((3, 5, 5), float(r) if r > 0 else 0.0))
            np.testing.assert_array_equal(c["dn"], np.full((3, 5, 5), float(r + 2) if r < D - 1
                                                           else 0.0))
            # rows 0-4 went up (x100 at rank - 1), rows 3-7 down (x10 at rank + 1)
            want = np.zeros((3, 8, 5))
            if r > 0:
                want[:, :5] += 100.0
            if r < D - 1:
                want[:, 3:] += 10.0
            np.testing.assert_array_equal(c["g_band"], want)
            # the reduce-scatter sums every rank's cotangent of rank r's rows
            np.testing.assert_array_equal(c["g_x"], D * np.array([[2 * r + 1.0] * 3,
                                                                  [2 * r + 2.0] * 3]))


class TestBandsOnOneDevice:
    @pytest.mark.parametrize("n_bands", [2, 4, 8])
    @pytest.mark.parametrize("scene", ["setup", "tied"])
    def test_stitched_bands_are_the_full_render(self, n_bands, scene):
        """render_band without a mesh, band by band (band binning with the
        whole grid's depth bits), stitched: the single-device render, ties
        and all (chip_smoke.py phase 6b runs this at 1M Gaussians)."""
        from gaussian_lic_tpu_torch.parallel.sharded import render_band

        d = load_golden("parallel", "file")
        intr = Intrinsics(**RIG)
        if scene == "setup":
            gm, kf = golden_map(d, "map"), golden_keyframes(d, "frames", intr, 4)
        else:
            gm = golden_map(d, "tied", sh_degree=0)
            kf = golden_keyframes(d, "tied_frames", intr, 2)
        cam = kf.camera(intr, 0)
        kw = dict(tile_h=8, tile_w=128, max_tiles_per_gaussian=16, max_total_splats=1 << 12)
        full = render_map(gm, cam, **kw)
        band_n_ty = 8 // n_bands
        with torch.no_grad():
            parts = [render_band(gm.xyz, gm.log_scale, gm.quat, gm.opa_logit, cam, dc=gm.dc,
                                 sh_rest=gm.sh_rest, sh_degree=gm.sh_degree,
                                 active=gm.active_mask(), band_ty0=b * band_n_ty,
                                 band_n_ty=band_n_ty, **kw) for b in range(n_bands)]
        np.testing.assert_allclose(torch.cat([p[0] for p in parts], 1).numpy(),
                                   full.image.numpy(), atol=1e-5)
        np.testing.assert_allclose(torch.cat([p[1] for p in parts], 0).numpy(),
                                   full.final_T.numpy(), atol=1e-5)
        assert sum(int(p[4]) for p in parts) == int(full.truncated)


class TestBandGeometry:
    def test_fallbacks(self):
        """The configured tile, then (16,64), then (8,128)."""
        cfg = Params(**dict(CFG, tile_h=32, tile_w=32))
        intr = Intrinsics(**RIG)
        for n_dev, tile, band in ((2, (32, 32), 1), (4, (16, 64), 1), (8, (8, 128), 1)):
            grid, band_n_ty = _band_geometry(intr, cfg, n_dev)
            assert (grid.tile_h, grid.tile_w, band_n_ty) == tile + (band,)
        mcd = Intrinsics(width=640, height=480, fx=385.5, fy=385.7, cx=328.3, cy=243.5)
        grid, band_n_ty = _band_geometry(mcd, cfg.replace(width=640, height=480), 4)
        assert (grid.tile_h, grid.tile_w, band_n_ty) == (8, 128, 15)
        with pytest.raises(ValueError, match="pad the image height"):
            _band_geometry(intr, cfg, 16)

    def test_mesh_needs_a_group_for_more_ranks(self):
        with pytest.raises(ValueError, match="requested 2 devices"):
            make_mesh(2, device="cpu")


def raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


def hang_on_rank_1(mesh):
    if mesh.rank == 1:
        time.sleep(600)
    return mesh.rank


def test_spawn_fails_loudly():
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn(raise_on_rank_1, 2, "cpu", timeout=SPAWN_TIMEOUT)
    with pytest.raises(TimeoutError, match="past 5"):
        spawn(hang_on_rank_1, 2, "cpu", timeout=5)


# ----------------------------------------------------------------- engine

ENGINE_CFG = dict(RIG, skybox_points_num=0, initial_capacity=2048, densify_budget=512,
                  max_train_keyframes=8, max_iters_per_keyframe=6, tile_h=8, tile_w=128)


def engine_frames():
    """tests/test_parallel.py:346-373's 10-frame stream, with the port's
    synthetic world."""
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    rng = np.random.default_rng(11)
    return make_sequence(make_world(rng, n_points=250), n_frames=10, points_per_frame=100,
                         rng=rng)


def run_engine(cfg, mesh=None, result_path=None):
    """(finalize's results, the Gaussian count, timers.compiles, the engine)."""
    eng = MappingEngine(cfg, device="cpu", mesh=mesh, result_path=result_path)
    for f in engine_frames():
        eng.add_frame(f)
    return eng.finalize(), int(eng.gm.count), eng.timers.compiles, eng


def engine_rank(mesh, tmp):
    """run_engine on this rank, recording the bundles the engine asks of
    parallel.make_sharded_train_bundle: (results, count, compiles, the
    bundle sizes made, whether the engine's bundle cache holds those, and
    measure_phase_split's result and printed text on the final map)."""
    made = {}
    make = parallel.make_sharded_train_bundle

    def recording(intr, cfg, mesh_, k, graphs=None):
        made[k] = make(intr, cfg, mesh_, k, graphs)
        return made[k]

    parallel.make_sharded_train_bundle = recording
    try:
        res, n, compiles, eng = run_engine(Params(**ENGINE_CFG), mesh,
                                           os.path.join(tmp, f"rank{mesh.rank}"))
    finally:
        parallel.make_sharded_train_bundle = make
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        split = eng.measure_phase_split()
    return (res, n, compiles, sorted(made), all(eng._bundles[k] is made[k] for k in eng._bundles),
            (split, printed.getvalue()))


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """(tmp, each rank's engine_rank, the single-device run_engine): one
    spawn of 2 gloo ranks for the class."""
    tmp = tmp_path_factory.mktemp("engine")
    ranks_ = spawn(engine_rank, 2, "cpu", args=(str(tmp),), timeout=SPAWN_TIMEOUT)
    return tmp, ranks_, run_engine(Params(**ENGINE_CFG))


class TestEngineWithMesh:
    def test_streaming_engine_sharded(self, engine_runs):
        """MappingEngine over 2 gloo ranks: the train PSNR within 0.1 dB of
        the single-device engine's, the same Gaussian count, and only rank 0
        writes its result path."""
        tmp_path, ((r0, n0, *_), (r1, n1, *_)), (ref, n_ref, _, _) = engine_runs
        assert n0 == n1 == n_ref
        assert abs(r0["train_psnr"] - ref["train_psnr"]) < 0.1
        assert r0["train_psnr"] > 14.0 and r0 == r1
        assert os.path.exists(tmp_path / "rank0" / "point_cloud.ply")
        assert not os.path.exists(tmp_path / "rank1")

    def test_bundles_are_sharded_bundles(self, engine_runs):
        """The mesh engine's bundles come from make_sharded_train_bundle (its
        bundle cache holds them), and it counts the single-device engine's
        compiles on the same stream."""
        _, ranks_, (_, _, compiles_ref, _) = engine_runs
        for _, _, compiles, made, cached, _ in ranks_:
            assert made and cached
            assert compiles == compiles_ref

    def test_phase_split_is_whole_step_only(self, engine_runs):
        """measure_phase_split on the mesh engine returns {} and says why, as
        the JAX engine does with a mesh (gaussian_lic_tpu/engine/trainer.py):
        the sharded step's phases overlap its collectives, and timing the
        single-device train_step would report a step the run does not train
        with."""
        for *_, (split, printed) in engine_runs[1]:
            assert split == {}
            assert "[phase-split] sharded step: phases overlap with collectives" in printed


class TestCli:
    def test_mesh_devices_two_gloo_ranks(self, tmp_path, capfd):
        from gaussian_lic_tpu_torch import run
        from gaussian_lic_tpu_torch.io import checkpoint, ply

        out, ckpt = tmp_path / "out", tmp_path / "ckpt.npz"
        assert run.main(["--demo", "--device", "cpu", "--mesh-devices", "2", "--demo-frames",
                         "6", "--max-iters", "2", "--result-path", str(out),
                         "--checkpoint", str(ckpt)]) == 0
        text = capfd.readouterr().out
        assert text.count("===== quality") == 1 and "mesh of 2 rank(s)" in text
        gm, _, _ = checkpoint.load_checkpoint(str(ckpt), device="cpu")
        assert ply.load_ply(str(out / "point_cloud.ply"))["xyz"].shape[0] == int(gm.count) > 0
