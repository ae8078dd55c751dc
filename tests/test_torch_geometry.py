"""Port parity: config, camera, SH and projection against the JAX package,
values and vector-Jacobian products (jax.vjp vs torch.autograd).

Tolerance: rtol 1e-5, with an absolute floor of 1e-5 x max|reference| for
entries that cancel to near zero. Both packages compute in float32 with the
same operation order; what remains is the last-ulp difference of XLA's and
PyTorch's CPU kernels (exp, sqrt, division), a few 1e-7 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ROOT, n, t

from gaussian_lic_tpu import camera as jcam
from gaussian_lic_tpu import config as jconfig
from gaussian_lic_tpu.ops import projection as jproj
from gaussian_lic_tpu.ops import sh as jsh
from gaussian_lic_tpu_torch import camera as tcam
from gaussian_lic_tpu_torch import config as tconfig
from gaussian_lic_tpu_torch.ops import projection as tproj
from gaussian_lic_tpu_torch.ops import sh as tsh

RTOL = 1e-5


def close(a, b, rtol=RTOL):
    a, b = n(a), n(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30))


J_INTR = jcam.Intrinsics(width=64, height=48, fx=50.0, fy=52.0, cx=33.0, cy=23.0)
T_INTR = tcam.Intrinsics(width=64, height=48, fx=50.0, fy=52.0, cx=33.0, cy=23.0)


def cameras(eye=(1.0, -2.0, 0.5), target=(3.0, 1.0, 1.0)):
    R_wc, t_wc = jcam.look_at(np.array(eye), np.array(target))
    return jcam.make_camera(J_INTR, R_wc, t_wc), tcam.make_camera(T_INTR, R_wc, t_wc)


def gaussians(rng, m):
    xyz = np.stack([rng.uniform(-3, 3, m), rng.uniform(-2, 2, m),
                    rng.uniform(-1, 8, m)], 1).astype(np.float32)
    scale = (np.abs(rng.normal(size=(m, 3))) * 0.2 + 0.02).astype(np.float32)
    quat = rng.normal(size=(m, 4)).astype(np.float32)
    return xyz, scale, quat


class TestConfig:
    @pytest.mark.parametrize("name", ["fastlivo", "r3live", "mcd"])
    def test_yaml_loads_like_jax(self, name):
        path = os.path.join(ROOT, "config", f"{name}.yaml")
        a = dataclasses.asdict(tconfig.load_params(path, skybox_points_num=0))
        b = dataclasses.asdict(jconfig.load_params(path, skybox_points_num=0))
        assert a == b

    def test_presets_and_unknown_keys(self):
        assert tconfig.PRESETS == jconfig.PRESETS
        assert tconfig.load_params(preset="mcd") == tconfig.Params(**jconfig.PRESETS["mcd"])
        with pytest.raises(KeyError):
            tconfig.load_params(no_such_key=1)


class TestCamera:
    def test_intrinsics(self):
        for prop in ("fov_x", "fov_y", "tan_fov_x", "tan_fov_y", "limx_neg",
                     "limx_pos", "limy_neg", "limy_pos"):
            assert getattr(T_INTR, prop) == getattr(J_INTR, prop)
        np.testing.assert_array_equal(T_INTR.projection_matrix(), J_INTR.projection_matrix())

    def test_look_at_and_make_camera(self):
        jc, tc = cameras()
        close(tc.pose.R_cw, jc.pose.R_cw)
        close(tc.pose.t_cw, jc.pose.t_cw)
        close(tc.full_proj, jc.full_proj)
        close(tc.cam_center, jc.cam_center)
        close(tc.pose.view_matrix(), jc.pose.view_matrix())

    def test_batched_poses(self, rng):
        R = np.stack([jcam.look_at(rng.normal(size=3), np.zeros(3))[0] for _ in range(3)])
        tw = rng.normal(size=(3, 3)).astype(np.float32)
        jc = jcam.make_camera(J_INTR, R, tw)
        tc = tcam.make_camera(T_INTR, R, tw)
        close(tc.full_proj, jc.full_proj)
        close(tc.cam_center, jc.cam_center)


class TestSH:
    def test_rgb_sh_roundtrip(self, rng):
        rgb = rng.uniform(size=(7, 3)).astype(np.float32)
        close(tsh.rgb_to_sh(t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
        close(tsh.sh_to_rgb(t(rgb)), jsh.sh_to_rgb(jnp.asarray(rgb)))

    @pytest.mark.parametrize("deg", [0, 1, 2, 3])
    def test_eval_value_and_vjp(self, rng, deg):
        m = 40
        dc = rng.normal(size=(m, 3)).astype(np.float32) * 0.5
        rest = rng.normal(size=(m, 15, 3)).astype(np.float32) * 0.2
        dirs = rng.normal(size=(m, 3)).astype(np.float32)
        ct = rng.normal(size=(m, 3)).astype(np.float32)
        out_j, vjp = jax.vjp(lambda a, b, c: jsh.eval_sh_color(deg, a, b, c),
                             jnp.asarray(dc), jnp.asarray(rest), jnp.asarray(dirs))
        gj = vjp(jnp.asarray(ct))
        ins = [t(dc).requires_grad_(), t(rest).requires_grad_(), t(dirs).requires_grad_()]
        out_t = tsh.eval_sh_color(deg, *ins)
        gt = torch.autograd.grad(out_t, ins, t(ct), allow_unused=True)
        close(out_t, out_j)
        for x, a, b in zip(ins, gt, gj):
            close(torch.zeros_like(x) if a is None else a, b)


class TestProjection:
    def test_rotmat_and_cov3d(self, rng):
        _, scale, quat = gaussians(rng, 30)
        close(tproj.quat_to_rotmat(t(quat)), jproj.quat_to_rotmat(jnp.asarray(quat)))
        close(tproj.build_cov3d(t(scale), t(quat)),
              jproj.build_cov3d(jnp.asarray(scale), jnp.asarray(quat)))

    def test_project_values(self, rng):
        xyz, scale, quat = gaussians(rng, 200)
        jc, tc = cameras()
        pj = jproj.project_gaussians(jnp.asarray(xyz), jnp.asarray(scale), jnp.asarray(quat), jc)
        pt = tproj.project_gaussians(t(xyz), t(scale), t(quat), tc)
        np.testing.assert_array_equal(n(pt.in_front), n(pj.in_front))
        np.testing.assert_array_equal(n(pt.det_valid), n(pj.det_valid))
        for f in ("depth", "xy", "cov2d", "conic"):
            m = n(pj.in_front)
            close(n(getattr(pt, f))[m], n(getattr(pj, f))[m])
        np.testing.assert_array_equal(n(pt.radius), n(pj.radius))

    def test_project_vjp(self, rng):
        """Cotangents on depth, xy, cov2d and conic of the Gaussians in front."""
        m = 120
        xyz, scale, quat = gaussians(rng, m)
        xyz[:, 2] = np.abs(xyz[:, 2]) + 1.0
        jc, tc = cameras()
        cts = [rng.normal(size=s).astype(np.float32) for s in ((m,), (m, 2), (m, 3), (m, 3))]

        def jf(a, b, c):
            p = jproj.project_gaussians(a, b, c, jc)
            return p.depth, p.xy, p.cov2d, p.conic

        _, vjp = jax.vjp(jf, jnp.asarray(xyz), jnp.asarray(scale), jnp.asarray(quat))
        gj = vjp(tuple(jnp.asarray(c) for c in cts))
        ins = [t(xyz).requires_grad_(), t(scale).requires_grad_(), t(quat).requires_grad_()]
        p = tproj.project_gaussians(*ins, tc)
        gt = torch.autograd.grad((p.depth, p.xy, p.cov2d, p.conic), ins,
                                 [t(c) for c in cts])
        for a, b in zip(gt, gj):
            close(a, b)

    def test_max_contrib_power_rect(self, rng):
        m = 64
        conic = np.stack([rng.uniform(0.01, 0.5, m), rng.uniform(-0.05, 0.05, m),
                          rng.uniform(0.01, 0.5, m)], 1).astype(np.float32)
        xy = rng.uniform(-20, 80, (m, 2)).astype(np.float32)
        rmin = np.floor(rng.uniform(0, 60, (m, 2)) / 32).astype(np.float32) * 32
        rmax = rmin + 31
        a = tproj.max_contrib_power_rect(t(conic), t(xy), t(rmin), t(rmax))
        b = jproj.max_contrib_power_rect(*(jnp.asarray(v) for v in (conic, xy, rmin, rmax)))
        close(a, b)
