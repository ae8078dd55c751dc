"""Port parity: the blend kernels K1/K2 and the tiled renderer.

(a) The plain K1/K2 against the JAX package's Pallas kernels on the golden
    splat list (tests/torch_goldens/blend.npz; `live` re-runs the JAX side in
    interpret mode). Image and final_T atol 1e-5 (float32 sums taken in a
    different order); n_contrib exact; per-entry gradients 1e-4 relative to
    the max (PARITY.md C12).
(b) The port's render_tiled against the JAX dense oracle `render_dense`, with
    the tolerances the JAX package holds its own tiled path to
    (tests/test_rasterize_tiled.py:136-149): the tiled path restricts each
    Gaussian to its culled tiles, the oracle does not.
(c) Gradients of all six parameter groups through render_tiled against JAX
    AD of the dense oracle, <= 1e-4 relative (test_rasterize_tiled.py:199-233).
(d) The CUDA kernels against their plain versions, on the card only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import GOLDEN_SOURCES, cuda_device, load_golden, n, rel_max, t

from gaussian_lic_tpu import camera as jcam
from gaussian_lic_tpu.ops.rasterize_ref import render_dense
from gaussian_lic_tpu_torch import camera as tcam
from gaussian_lic_tpu_torch.ops import blend
from gaussian_lic_tpu_torch.ops.rasterize import render_tiled

IMG_ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def golden(request):
    return load_golden("blend", request.param)


def golden_args(d, device="cpu"):
    n_tx, n_ty, th, tw = (int(v) for v in d["grid"])
    args = (t(d["splats"]).to(device), t(d["tile_starts"]).to(device),
            t(d["tile_lens"]).to(device))
    return args, dict(n_tx=n_tx, n_ty=n_ty, tile_h=th, tile_w=tw)


# --------------------------------------------------------------------- (a)

class TestPlainAgainstPallas:
    def test_forward(self, golden):
        args, kw = golden_args(golden)
        color, final_t, n_contrib = blend.blend_forward_plain(*args, **kw)
        assert (golden["final_t"] < 1e-3).sum() > 0, "golden scene has no terminated pixel"
        np.testing.assert_allclose(n(color), golden["color"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(n(final_t), golden["final_t"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_array_equal(n(n_contrib), golden["n_contrib"])

    def test_forward_no_color(self, golden):
        args, kw = golden_args(golden)
        color, final_t, n_contrib = blend.blend_forward_plain(*args, no_color=True, **kw)
        np.testing.assert_allclose(n(final_t), golden["final_t_no_color"], atol=IMG_ATOL,
                                   rtol=0)
        assert float(color.abs().max()) == 0.0 and int(n_contrib.abs().max()) == 0

    def test_backward(self, golden):
        args, kw = golden_args(golden)
        grads = blend.blend_backward_plain(
            *args, t(golden["dl_dcolor"]), t(golden["final_t"]), t(golden["n_contrib"]), **kw
        )
        ref = golden["entry_grads"]
        assert rel_max(n(grads), ref) < GRAD_RTOL
        for i in range(blend.N_ATTR):
            assert rel_max(n(grads)[:, i], ref[:, i]) < GRAD_RTOL, i


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        d = load_golden("blend", "file")
        args, kw = golden_args(d)
        before = dict(blend.LAUNCHES)
        out = blend.blend_forward(*args, **kw)
        ref = blend.blend_forward_plain(*args, **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        g = blend.blend_backward(*args, t(d["dl_dcolor"]), out[1], out[2], **kw)
        assert torch.equal(g, blend.blend_backward_plain(*args, t(d["dl_dcolor"]), out[1],
                                                         out[2], **kw))
        assert blend.LAUNCHES == before   # the plain version is not a launch

    @pytest.mark.parametrize("bad", ["dtype", "width", "tiles", "tile_shape", "strided"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        d = load_golden("blend", "file")
        (sp, st, ln), kw = golden_args(d)
        if bad == "dtype":
            sp = sp.double()
        elif bad == "width":
            sp = sp[:, :9]
        elif bad == "tiles":
            st = st[:-1]
        elif bad == "strided":
            ln = torch.stack([ln, ln], 1)[:, 0]
        else:
            kw = dict(kw, tile_h=16)
        with pytest.raises(ValueError):
            blend.blend_forward(sp, st, ln, **kw)


# --------------------------------------------------------------------- (b), (c)

W, H = 256, 64
J_INTR = jcam.Intrinsics(width=W, height=H, fx=80.0, fy=80.0, cx=128.0, cy=32.0)
T_INTR = tcam.Intrinsics(width=W, height=H, fx=80.0, fy=80.0, cx=128.0, cy=32.0)


def cams():
    R_wc, t_wc = jcam.look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    return jcam.make_camera(J_INTR, R_wc, t_wc), tcam.make_camera(T_INTR, R_wc, t_wc)


def random_scene(rng, m, opa_range=(0.2, 0.9)):
    """The scene recipe of tests/test_rasterize_tiled.py, as numpy."""
    xyz = np.concatenate([rng.uniform(-6, 6, (m, 1)), rng.uniform(-1, 1, (m, 1)),
                          rng.uniform(3, 10, (m, 1))], axis=1).astype(np.float32)
    scale = (np.abs(rng.normal(size=(m, 3))) * 0.08 + 0.03).astype(np.float32)
    quat = rng.normal(size=(m, 4)).astype(np.float32)
    opacity = rng.uniform(*opa_range, m).astype(np.float32)
    dc = (rng.normal(size=(m, 3)) * 0.4).astype(np.float32)
    shr = (rng.normal(size=(m, 15, 3)) * 0.05).astype(np.float32)
    return xyz, scale, quat, opacity, dc, shr


def render_both(scene, **kw):
    jc, tc = cams()
    xyz, scale, quat, opacity, dc, shr = scene
    dense = render_dense(*(jnp.asarray(a) for a in (xyz, scale, quat, opacity)), jc,
                         dc=jnp.asarray(dc), sh_rest=jnp.asarray(shr), **kw)
    tiled = render_tiled(t(xyz), t(scale), t(quat), t(opacity), tc, dc=t(dc),
                         sh_rest=t(shr), max_total_splats=1 << 14, **kw)
    return dense, tiled


class TestRenderAgainstDense:
    def test_matches_dense(self, rng):
        dense, tiled = render_both(random_scene(rng, 200))
        assert int(tiled.overflow) == 0
        di, ti = n(dense.image), n(tiled.image)
        assert np.abs(di - ti).max() < 0.02
        assert np.abs(di - ti).mean() < 1e-4
        np.testing.assert_array_equal(n(dense.visible), n(tiled.visible))
        np.testing.assert_allclose(n(dense.radii), n(tiled.radii))
        assert np.abs(n(dense.final_T) - n(tiled.final_T)).max() < 0.03

    def test_no_color_alpha_only(self, rng):
        dense, tiled = render_both(random_scene(rng, 100), no_color=True)
        assert float(tiled.image.abs().max()) == 0.0
        assert np.abs(n(dense.final_T) - n(tiled.final_T)).max() < 0.03

    def test_active_mask_and_exposure(self, rng):
        xyz, scale, quat, opacity, dc, shr = (t(a) for a in random_scene(rng, 50))
        _, tc = cams()
        kw = dict(dc=dc, sh_rest=shr, max_total_splats=1 << 14)
        out = render_tiled(xyz, scale, quat, opacity, tc, active=torch.arange(50) < 25, **kw)
        ref = render_tiled(xyz[:25], scale[:25], quat[:25], opacity[:25], tc,
                           dc=dc[:25], sh_rest=shr[:25], max_total_splats=1 << 14)
        np.testing.assert_allclose(n(out.image), n(ref.image), atol=1e-5)
        assert not bool(out.visible[25:].any())
        exposure = torch.tensor(np.concatenate([np.diag([0.5, 1.0, 2.0]),
                                                np.full((3, 1), 0.1)], 1), dtype=torch.float32)
        base = render_tiled(xyz, scale, quat, opacity, tc, **kw)
        exposed = render_tiled(xyz, scale, quat, opacity, tc, exposure=exposure,
                               apply_exposure=True, **kw)
        expect = n(base.image) * np.array([0.5, 1.0, 2.0])[:, None, None] + 0.1
        np.testing.assert_allclose(n(exposed.image), expect, atol=1e-5)


class TestGradientsAgainstDense:
    def test_grad_parity_with_dense_ad(self, rng):
        xyz, scale, quat, opacity, dc, shr = random_scene(rng, 60, opa_range=(0.2, 0.8))
        params = dict(xyz=xyz, log_scale=np.log(scale), quat=quat,
                      opa_logit=np.log(opacity / (1 - opacity)), dc=dc, sh_rest=shr)
        target = rng.uniform(size=(3, H, W)).astype(np.float32)
        jc, tc = cams()

        def jloss(p):
            out = render_dense(p["xyz"], jnp.exp(p["log_scale"]), p["quat"],
                               jax.nn.sigmoid(p["opa_logit"]), jc, dc=p["dc"],
                               sh_rest=p["sh_rest"], sh_degree=3)
            return jnp.mean((out.image - jnp.asarray(target)) ** 2)

        g_dense = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
        tp = {k: t(v).requires_grad_() for k, v in params.items()}
        out = render_tiled(tp["xyz"], torch.exp(tp["log_scale"]), tp["quat"],
                           torch.sigmoid(tp["opa_logit"]), tc, dc=tp["dc"],
                           sh_rest=tp["sh_rest"], sh_degree=3, max_total_splats=1 << 14)
        loss = ((out.image - t(target)) ** 2).mean()
        g_tiled = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
        for k in params:
            assert rel_max(n(g_tiled[k]), n(g_dense[k])) < GRAD_RTOL, k


# --------------------------------------------------------------------- (d)

@pytest.mark.requires_cuda
class TestKernelsOnTheCard:
    """K1/K2 on the card against their plain versions on the same card."""

    def test_forward_kernels(self, cuda_device):
        d = load_golden("blend", "file")
        args, kw = golden_args(d, cuda_device)
        before = dict(blend.LAUNCHES)
        for no_color in (False, True):
            out = blend.blend_forward(*args, no_color=no_color, **kw)
            ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(n(out[0]), n(ref[0]), atol=IMG_ATOL, rtol=0)
            np.testing.assert_allclose(n(out[1]), n(ref[1]), atol=IMG_ATOL, rtol=0)
            np.testing.assert_array_equal(n(out[2]), n(ref[2]))
        assert blend.LAUNCHES["forward"] == before["forward"] + 1
        assert blend.LAUNCHES["forward_no_color"] == before["forward_no_color"] + 1

    def test_backward_kernel(self, cuda_device):
        d = load_golden("blend", "file")
        args, kw = golden_args(d, cuda_device)
        pix = [t(d[k]).to(cuda_device) for k in ("dl_dcolor", "final_t", "n_contrib")]
        g = blend.blend_backward(*args, *pix, **kw)
        ref = blend.blend_backward_plain(*args, *pix, **kw)
        torch.cuda.synchronize()
        assert rel_max(n(g), n(ref)) < GRAD_RTOL
        assert rel_max(n(g), d["entry_grads"]) < GRAD_RTOL
