"""Port parity: the dense reference renderer (`ops/rasterize_ref.py`) against
the JAX package's oracle, and the port's tiled rasterizer against it.

Scenes are tests/test_rasterize_tiled.py's recipe (a frontal camera at
256x64, Gaussians 3-10 units ahead), drawn with numpy from a seed and handed
to both packages. Tolerances:
  * forward against JAX: image, final_T and radii within 1e-5 (absolute;
    the arithmetic is the same, XLA's and PyTorch's exp differ in the last
    ulp), n_contrib and visible exactly;
  * gradients of mean((image - target)^2) against jax.grad of JAX's oracle:
    within 1e-4 of each column's largest magnitude, all six groups;
  * the tiled rasterizer (plain blend on the CPU) against the oracle:
    tests/test_rasterize_tiled.py's bounds (image max 0.02 and mean 1e-4,
    visible equal, radii close, final_T 0.03; gradients 1e-4 of each
    column's max, measured 7.5e-7): the tiled path restricts each Gaussian
    to its footprint;
  * chunked evaluation against one chunk: bit for bit (each pixel's walk
    is independent of the others).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from gaussian_lic_tpu import camera as jcam
from gaussian_lic_tpu.ops import rasterize_ref as jref
from gaussian_lic_tpu_torch import camera as tcam
from gaussian_lic_tpu_torch.ops import blend
from gaussian_lic_tpu_torch.ops import rasterize_ref as tref
from gaussian_lic_tpu_torch.ops.rasterize import render_tiled

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
RIG = dict(width=256, height=64, fx=80.0, fy=80.0, cx=128.0, cy=32.0)


def cameras():
    R_wc, t_wc = jcam.look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    return (jcam.make_camera(jcam.Intrinsics(**RIG), R_wc, t_wc),
            tcam.make_camera(tcam.Intrinsics(**RIG), R_wc, t_wc))


def random_scene(rng, m, opa_range=(0.2, 0.9), tied=False):
    """tests/test_rasterize_tiled.py's random_scene, as numpy arrays; with
    `tied`, depths come from 5 values, so many Gaussians share a depth."""
    z = (rng.choice([4.0, 5.5, 6.0, 7.25, 9.0], m) if tied else rng.uniform(3, 10, m))
    xyz = np.stack([rng.uniform(-6, 6, m), rng.uniform(-1, 1, m), z], 1).astype(np.float32)
    scale = (np.abs(rng.normal(size=(m, 3))) * 0.08 + 0.03).astype(np.float32)
    quat = rng.normal(size=(m, 4)).astype(np.float32)
    opacity = rng.uniform(*opa_range, m).astype(np.float32)
    dc = (rng.normal(size=(m, 3)) * 0.4).astype(np.float32)
    shr = (rng.normal(size=(m, 15, 3)) * 0.05).astype(np.float32)
    return dict(xyz=xyz, scale=scale, quat=quat, opacity=opacity, dc=dc, sh_rest=shr)


GEOM = ("xyz", "scale", "quat", "opacity")
MODES = {
    "sh": dict(),
    "colors": dict(colors=True),
    "no_color": dict(no_color=True),
    "box_cull": dict(box_cull=True),
    "tied_depths": dict(tied=True),
}


class TestForwardAgainstJax:
    @pytest.mark.parametrize("mode", list(MODES))
    def test_outputs(self, rng, mode):
        opts = dict(MODES[mode])
        sc = random_scene(rng, 200, tied=opts.pop("tied", False))
        kw = {}
        if opts.pop("colors", False):
            kw["colors"] = rng.uniform(0, 1, (200, 3)).astype(np.float32)
        elif not opts.get("no_color"):
            kw.update(dc=sc["dc"], sh_rest=sc["sh_rest"])
        jc, tc = cameras()
        ja = jref.render_dense(*(jnp.asarray(sc[k]) for k in GEOM), jc,
                               **{k: jnp.asarray(v) for k, v in kw.items()}, **opts)
        ta = tref.render_dense(*(t(sc[k]) for k in GEOM), tc,
                               **{k: t(v) for k, v in kw.items()}, **opts)
        for f in ("image", "final_T", "radii"):
            np.testing.assert_allclose(n(getattr(ta, f)), n(getattr(ja, f)), rtol=0,
                                       atol=FWD_ATOL, err_msg=f)
        for f in ("n_contrib", "visible"):
            np.testing.assert_array_equal(n(getattr(ta, f)), n(getattr(ja, f)), err_msg=f)
        assert ta.n_contrib.dtype == torch.int32
        if mode == "no_color":
            assert float(ta.image.abs().max()) == 0.0
        else:
            assert int(ta.n_contrib.max()) > 1 and float(ta.image.abs().max()) > 0.1
        if mode == "tied_depths":   # the case is live: visible Gaussians share a depth
            z = sc["xyz"][n(ta.visible), 2]
            assert len(np.unique(z)) < len(z)

    def test_constants_have_one_definition(self):
        assert tref.ALPHA_CAP is blend.ALPHA_CAP and tref.T_EPS is blend.T_EPS
        assert (tref.ALPHA_CAP, tref.T_EPS) == (jref.ALPHA_CAP, jref.T_EPS)


def grad_params(rng, m=60):
    sc = random_scene(rng, m, opa_range=(0.2, 0.8))
    params = dict(xyz=sc["xyz"], log_scale=np.log(sc["scale"]), quat=sc["quat"],
                  opa_logit=np.log(sc["opacity"] / (1 - sc["opacity"])), dc=sc["dc"],
                  sh_rest=sc["sh_rest"])
    target = rng.uniform(size=(3, RIG["height"], RIG["width"])).astype(np.float32)
    return params, target


def torch_grads(params, target, cam, renderer):
    p = {k: t(v).requires_grad_(True) for k, v in params.items()}
    out = renderer(p["xyz"], torch.exp(p["log_scale"]), p["quat"], torch.sigmoid(p["opa_logit"]),
                   cam, dc=p["dc"], sh_rest=p["sh_rest"], sh_degree=3)
    loss = torch.mean((out.image - t(target)) ** 2)
    return dict(zip(p, (n(g) for g in torch.autograd.grad(loss, list(p.values())))))


def column_rel(a, b) -> float:
    """max over columns of max|a - b| / max|b| (the last axis; a vector is one column)."""
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return float((np.abs(a2 - b2).max(0) / (np.abs(b2).max(0) + 1e-12)).max())


class TestGradients:
    def test_autograd_against_jax_grad(self, rng):
        params, target = grad_params(rng)
        jc, tc = cameras()

        def jloss(p):
            out = jref.render_dense(p["xyz"], jnp.exp(p["log_scale"]), p["quat"],
                                    jax.nn.sigmoid(p["opa_logit"]), jc, dc=p["dc"],
                                    sh_rest=p["sh_rest"], sh_degree=3)
            return jnp.mean((out.image - jnp.asarray(target)) ** 2)

        gj = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
        gt = torch_grads(params, target, tc, tref.render_dense)
        for k in params:
            assert np.abs(np.asarray(gj[k])).max() > 0, k
            assert column_rel(gt[k], np.asarray(gj[k])) < GRAD_RTOL, k


class TestTiledAgainstOracle:
    """tests/test_rasterize_tiled.py's dense-parity tests, on the port alone."""

    def test_forward(self, rng):
        sc = random_scene(rng, 200)
        _, tc = cameras()
        args = [t(sc[k]) for k in GEOM] + [tc]
        kw = dict(dc=t(sc["dc"]), sh_rest=t(sc["sh_rest"]))
        dense = tref.render_dense(*args, **kw)
        tiled = render_tiled(*args, **kw, max_total_splats=1 << 14)
        assert int(tiled.overflow) == 0
        d = np.abs(n(dense.image) - n(tiled.image))
        assert d.max() < 0.02 and d.mean() < 1e-4
        np.testing.assert_array_equal(n(dense.visible), n(tiled.visible))
        np.testing.assert_allclose(n(dense.radii), n(tiled.radii))
        assert np.abs(n(dense.final_T) - n(tiled.final_T)).max() < 0.03

    def test_no_color(self, rng):
        sc = random_scene(rng, 100)
        _, tc = cameras()
        args = [t(sc[k]) for k in GEOM] + [tc]
        tiled = render_tiled(*args, no_color=True, max_total_splats=1 << 14)
        dense = tref.render_dense(*args, no_color=True)
        assert float(tiled.image.abs().max()) == 0.0
        assert np.abs(n(tiled.final_T) - n(dense.final_T)).max() < 0.03

    def test_gradients(self, rng):
        params, target = grad_params(rng)
        _, tc = cameras()
        gd = torch_grads(params, target, tc, tref.render_dense)
        gt = torch_grads(params, target, tc,
                         lambda *a, **k: render_tiled(*a, **k, max_total_splats=1 << 14))
        for k in params:
            assert column_rel(gt[k], gd[k]) < GRAD_RTOL, k


class TestChunks:
    @pytest.mark.parametrize("no_color", [False, True])
    def test_chunked_equals_one_chunk(self, rng, no_color, monkeypatch):
        sc = random_scene(rng, 150)
        _, tc = cameras()
        args = [t(sc[k]) for k in GEOM] + [tc]
        kw = {} if no_color else dict(dc=t(sc["dc"]), sh_rest=t(sc["sh_rest"]))
        assert 150 * RIG["width"] * RIG["height"] <= tref.CHUNK_ELEMS
        one = tref.render_dense(*args, **kw, no_color=no_color)
        # 150 Gaussians x 1000 pixels a chunk: 17 chunks, the last one short
        monkeypatch.setattr(tref, "CHUNK_ELEMS", 150 * 1000)
        many = tref.render_dense(*args, **kw, no_color=no_color)
        assert RIG["width"] * RIG["height"] > 16 * 1000
        for a, b in zip(many, one):
            assert torch.equal(a, b)
