"""Port parity: the kNN mean distance (ops/knn.py) and the skybox
(models/gaussians.make_skybox) against the JAX package; initialize_map's
skybox branch is in test_torch_model.py.

Tolerances: kNN within 1e-6 relative (the same float32 differences and sums;
the candidate windows are identical, since both argsorts are stable);
skybox attributes within 1e-6 relative to each array's largest entry, from
JAX's own uniforms (theta, phi go through cos/sin/acos, whose float32
implementations may differ in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, rel_max, t

from gaussian_lic_tpu.models import gaussians as jg
from gaussian_lic_tpu.ops import knn as jknn
from gaussian_lic_tpu_torch.models import gaussians as tg
from gaussian_lic_tpu_torch.ops import knn as tknn


def knn_points(rng, num, ties):
    """Points in a box; with `ties`, snapped to a coarse grid with repeats,
    so that many Morton codes tie (and some points coincide)."""
    pts = rng.uniform(-3, 7, (num, 3)).astype(np.float32)
    if ties:
        pts = np.round(pts * 2.0) / 2.0
        pts[num // 2:] = pts[: num - num // 2]
    return pts


class TestKnn:
    @pytest.mark.parametrize("ties", [False, True])
    @pytest.mark.parametrize("num", [300, 5000])
    def test_bruteforce_and_sorted(self, rng, num, ties):
        pts = knn_points(rng, num, ties)
        for tf, jf in ((tknn.mean_knn_dist2_bruteforce, jknn.mean_knn_dist2_bruteforce),
                       (tknn.mean_knn_dist2_sorted, jknn.mean_knn_dist2_sorted)):
            a, b = n(tf(t(pts))), np.asarray(jf(jnp.asarray(pts)))
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=tf.__name__)

    def test_morton_codes(self, rng):
        pts01 = rng.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
        np.testing.assert_array_equal(n(tknn._morton_10bit(t(pts01))),
                                      np.asarray(jknn._morton_10bit(jnp.asarray(pts01))))

    @pytest.mark.parametrize("num", [2048, 2049])
    def test_dispatch_at_2048(self, rng, num):
        pts = knn_points(rng, num, ties=False)
        np.testing.assert_allclose(n(tknn.mean_knn_dist2(t(pts))),
                                   np.asarray(jknn.mean_knn_dist2(jnp.asarray(pts))),
                                   rtol=1e-6)


def jax_uniforms(num, seed):
    """The draws of the JAX package's make_skybox."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.uniform(k1, (num,))),
            np.asarray(jax.random.uniform(k2, (num,))))


class TestSkybox:
    @pytest.mark.parametrize("num,seed", [(200, 0), (3000, 7)])
    def test_make_skybox(self, monkeypatch, num, seed):
        monkeypatch.setattr(tg, "skybox_uniforms",
                            lambda k, gen: tuple(t(u) for u in jax_uniforms(k, seed)))
        got = tg.make_skybox(num, 1000.0, seed)
        want = jg.make_skybox(num, 1000.0, seed)
        for name, a, b in zip(("xyz", "dc", "log_scale", "quat", "opa"), got, want):
            assert rel_max(n(a), np.asarray(b)) <= 1e-6, name

    def test_uniforms_from_a_seeded_cpu_generator(self):
        a = tg.skybox_uniforms(1000, torch.Generator().manual_seed(3))
        b = tg.skybox_uniforms(1000, torch.Generator().manual_seed(3))
        c = tg.skybox_uniforms(1000, torch.Generator().manual_seed(4))
        for x in a:
            assert x.dtype == torch.float32 and x.device.type == "cpu"
            assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])

    def test_skybox_on_the_hemisphere(self):
        xyz, dc, log_scale, quat, opa = tg.make_skybox(500, 100.0, seed=1)
        r = n(xyz.norm(dim=1))
        np.testing.assert_allclose(r, 1000.0, rtol=1e-5)
        assert float(xyz[:, 2].min()) >= -0.4 * 1000.0 * (1 + 1e-5)   # phi <= acos(-0.4)
        np.testing.assert_allclose(n(torch.sigmoid(opa)), 0.7, rtol=1e-6)
        assert bool((log_scale[:, 0] == log_scale[:, 2]).all())
