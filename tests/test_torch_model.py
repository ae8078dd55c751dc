"""Port parity: GaussianMap init, point attributes, masked append, capacity
growth, and the numpy interop round trip, against the JAX package.

Tolerance: rtol 1e-6 on values (the same float32 formulas: log, division,
(c - 0.5)/C0); layout, counts and masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, rel_max, t

from gaussian_lic_tpu.models import gaussians as jg
from gaussian_lic_tpu.ops.adam import AdamState as JAdamState
from gaussian_lic_tpu_torch import interop
from gaussian_lic_tpu_torch.models import gaussians as tg

FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit", "count", "exposure")


def make_points(rng, m):
    return (rng.uniform(-5, 5, (m, 3)).astype(np.float32),
            rng.uniform(size=(m, 3)).astype(np.float32),
            rng.uniform(1, 10, m).astype(np.float32))


def assert_maps_equal(tm, jm, rtol=1e-6):
    assert tm.capacity == jm.capacity and tm.sh_degree == jm.sh_degree
    assert tm.skybox_count == jm.skybox_count
    for f in FIELDS:
        np.testing.assert_allclose(n(getattr(tm, f)), np.asarray(getattr(jm, f)),
                                   rtol=rtol, atol=1e-7, err_msg=f)


class TestInit:
    @pytest.mark.parametrize("capacity,scaling", [(256, 1.0), (128, 2.0)])
    def test_initialize_map(self, rng, capacity, scaling):
        pts, cols, depths = make_points(rng, 200)
        kw = dict(focal=450.0, scaling_scale=scaling, sh_degree=3, capacity=capacity,
                  skybox_points_num=0)
        tm = tg.initialize_map(pts, cols, depths, **kw)
        jm = jg.initialize_map(pts, cols, depths, **kw)
        assert tm.capacity == 256 and int(tm.count) == 200
        assert_maps_equal(tm, jm)
        for a in ("scaling", "rotation", "opacity"):
            np.testing.assert_allclose(n(getattr(tm, a)), np.asarray(getattr(jm, a)),
                                       rtol=1e-6, err_msg=a)
        np.testing.assert_array_equal(n(tm.active_mask()), np.asarray(jm.active_mask()))

    def test_skybox_not_ported_yet(self, rng, monkeypatch):
        """The skybox branch: skybox rows first, then the LiDAR rows, equal
        to JAX's map given JAX's uniforms (1e-6 relative to each array's
        largest entry: cos/sin/acos may differ in the last bit)."""
        k1, k2 = jax.random.split(jax.random.PRNGKey(5))
        draws = (t(jax.random.uniform(k1, (120,))), t(jax.random.uniform(k2, (120,))))
        monkeypatch.setattr(tg, "skybox_uniforms", lambda num, gen: draws)
        pts, cols, depths = make_points(rng, 150)
        kw = dict(focal=450.0, sh_degree=3, capacity=256, skybox_points_num=120,
                  skybox_radius=50.0, seed=5)
        tm = tg.initialize_map(pts, cols, depths, **kw)
        jm = jg.initialize_map(pts, cols, depths, **kw)
        assert tm.capacity == jm.capacity == 512     # 270 rows outgrow 256
        assert tm.skybox_count == jm.skybox_count == 120
        assert int(tm.count) == int(jm.count) == 270
        for f in FIELDS:
            assert rel_max(n(getattr(tm, f)), np.asarray(getattr(jm, f))) <= 1e-6, f
        np.testing.assert_array_equal(n(tm.xyz[120:270]), pts)

    def test_point_attributes(self, rng):
        pts, cols, depths = make_points(rng, 30)
        depths[0] = 0.0   # clamped to 1e-10 before the log
        a = tg.point_attributes(t(pts), t(cols), t(depths), 431.0, 1.5, 15)
        b = jg.point_attributes(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(depths),
                                431.0, 1.5, 15)
        for x, y in zip(a, b):
            np.testing.assert_allclose(n(x), np.asarray(y), rtol=1e-6)


class TestAppendAndGrow:
    @pytest.mark.parametrize("capacity", [256, 210])
    def test_append(self, rng, capacity):
        """210: the map fills up and the overflow is dropped, as in JAX."""
        pts, cols, depths = make_points(rng, 180)
        kw = dict(focal=450.0, capacity=capacity, skybox_points_num=0)
        tm = tg.initialize_map(pts, cols, depths, **kw)
        jm = jg.initialize_map(pts, cols, depths, **kw)
        m = 64
        new = make_points(rng, m)
        valid = rng.uniform(size=m) < 0.7
        ta = tg.point_attributes(t(new[0]), t(new[1]), t(new[2]), 450.0, 1.0, 15)
        ja = jg.point_attributes(*(jnp.asarray(v) for v in new), 450.0, 1.0, 15)
        tm2 = tg.append_gaussians(tm, ta[0], ta[1], ta[3], ta[5], t(valid))
        jm2 = jg.append_gaussians(jm, ja[0], ja[1], ja[3], ja[5], jnp.asarray(valid))
        assert int(tm2.count) == min(180 + int(valid.sum()), capacity)
        assert_maps_equal(tm2, jm2)
        assert int(tm.count) == 180   # the input map is left as it was

    def test_grow(self, rng):
        pts, cols, depths = make_points(rng, 100)
        kw = dict(focal=450.0, capacity=128, skybox_points_num=0)
        tm = tg.initialize_map(pts, cols, depths, **kw).grow(512)
        jm = jg.initialize_map(pts, cols, depths, **kw).grow(512)
        assert_maps_equal(tm, jm)
        with pytest.raises(ValueError):
            tm.grow(64)

    def test_empty(self):
        assert_maps_equal(tg.GaussianMap.empty(64, 2), jg.GaussianMap.empty(64, 2))


class TestInterop:
    def test_round_trip_from_jax(self, rng):
        pts, cols, depths = make_points(rng, 90)
        jm = jg.initialize_map(pts, cols, depths, focal=450.0, capacity=128,
                               skybox_points_num=0)
        arrays = {f: np.asarray(getattr(jm, f)) for f in FIELDS}
        tm = interop.gaussian_map_from_numpy(arrays, sh_degree=3, skybox_count=0,
                                             device="cpu")
        assert_maps_equal(tm, jm, rtol=0)
        back = interop.to_numpy(tm)
        for f in FIELDS:
            np.testing.assert_array_equal(back[f], arrays[f])
        with pytest.raises(KeyError):
            interop.gaussian_map_from_numpy({"xyz": arrays["xyz"]}, sh_degree=3,
                                            skybox_count=0, device="cpu")

    def test_adam_state_round_trip(self, rng):
        st = {"xyz": JAdamState(jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
                                jnp.asarray(rng.uniform(size=(5, 3)), jnp.float32))}
        arrays = {k: {"exp_avg": np.asarray(v.exp_avg), "exp_avg_sq": np.asarray(v.exp_avg_sq)}
                  for k, v in st.items()}
        ts = interop.adam_state_from_numpy(arrays, device="cpu")
        assert isinstance(ts["xyz"].exp_avg, torch.Tensor)
        back = interop.to_numpy(ts)
        np.testing.assert_array_equal(back["xyz"]["exp_avg"], arrays["xyz"]["exp_avg"])
        np.testing.assert_array_equal(back["xyz"]["exp_avg_sq"], arrays["xyz"]["exp_avg_sq"])
