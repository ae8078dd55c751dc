"""Port parity: L1, PSNR, SSIM, the training loss (values and gradients) and
the sparse / dense Adam updates, against the JAX package.

Tolerances: losses and updates rtol 1e-5 (float32, same operation order;
the means reduce in a different order); gradients 1e-5 relative to their max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, rel_max, t

from gaussian_lic_tpu.ops import adam as jadam
from gaussian_lic_tpu.ops import losses as jl
from gaussian_lic_tpu_torch.ops import adam as tadam
from gaussian_lic_tpu_torch.ops import losses as tl

RTOL = 1e-5


def images(rng, shape=(3, 24, 40)):
    a = rng.uniform(size=shape).astype(np.float32)
    # a smooth-ish second image, where SSIM's blur(x^2) - mu^2 cancels
    b = np.clip(a * 0.7 + 0.2 + rng.normal(size=shape).astype(np.float32) * 0.02, 0, 1)
    return a, b.astype(np.float32)


class TestLosses:
    @pytest.mark.parametrize("name", ["l1_loss", "psnr", "ssim", "training_loss"])
    def test_value_and_grad(self, rng, name):
        a, b = images(rng)
        jv, jg = jax.value_and_grad(getattr(jl, name))(jnp.asarray(a), jnp.asarray(b))
        ta = t(a).requires_grad_()
        tv = getattr(tl, name)(ta, t(b))
        (tg,) = torch.autograd.grad(tv, ta)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
        assert rel_max(n(tg), n(jg)) < RTOL

    def test_ssim_map(self, rng):
        a, b = images(rng)
        ref = np.asarray(jl.ssim_map(jnp.asarray(a), jnp.asarray(b)))
        got = n(tl.ssim_map(t(a), t(b)))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL)
        assert float(tl.ssim(t(a), t(a))) == pytest.approx(1.0, abs=1e-6)

    def test_lambda_dssim(self, rng):
        a, b = images(rng)
        for lam in (0.0, 0.5):
            np.testing.assert_allclose(
                float(tl.training_loss(t(a), t(b), lam)),
                float(jl.training_loss(jnp.asarray(a), jnp.asarray(b), lam)), rtol=RTOL)


class TestAdam:
    def test_sparse_update(self, rng):
        p, g, m, v = (rng.normal(size=(50, 3)).astype(np.float32) for _ in range(4))
        v = np.abs(v)
        g[3] = 0.0   # zero gradient, visible: moments decay, param moves by m
        vis = rng.uniform(size=50) < 0.6
        jp, js = jadam.sparse_adam_update(jnp.asarray(p), jnp.asarray(g),
                                          jadam.AdamState(jnp.asarray(m), jnp.asarray(v)),
                                          jnp.asarray(vis), 0.01)
        tp, ts = tadam.sparse_adam_update(t(p), t(g), tadam.AdamState(t(m), t(v)),
                                          t(vis), 0.01)
        for a, b in ((tp, jp), (ts.exp_avg, js.exp_avg), (ts.exp_avg_sq, js.exp_avg_sq)):
            np.testing.assert_allclose(n(a), n(b), rtol=RTOL, atol=1e-7)
        # invisible rows are untouched
        np.testing.assert_array_equal(n(tp)[~vis], p[~vis])
        np.testing.assert_array_equal(n(ts.exp_avg)[~vis], m[~vis])

    def test_first_step_is_sign_like(self):
        """No bias correction: the first step is -lr * 0.1 g / (sqrt(0.001) |g|)."""
        g = torch.tensor([[1e-6], [-3.0]])
        p, _ = tadam.sparse_adam_update(torch.zeros(2, 1), g,
                                        tadam.AdamState.zeros_like(g),
                                        torch.tensor([True, True]), 1.0)
        np.testing.assert_allclose(n(p)[:, 0], [-0.1 / np.sqrt(0.001), 0.1 / np.sqrt(0.001)],
                                   rtol=1e-5)

    @pytest.mark.parametrize("step", [None, 1, 7])
    def test_dense_update(self, rng, step):
        p, g, m = (rng.normal(size=(3, 4)).astype(np.float32) for _ in range(3))
        v = np.abs(rng.normal(size=(3, 4))).astype(np.float32)
        jp, js = jadam.dense_adam_update(
            jnp.asarray(p), jnp.asarray(g), jadam.AdamState(jnp.asarray(m), jnp.asarray(v)),
            lr=0.001, step_count=None if step is None else jnp.asarray(step, jnp.int32))
        tp, ts = tadam.dense_adam_update(t(p), t(g), tadam.AdamState(t(m), t(v)),
                                         lr=0.001, step_count=step)
        np.testing.assert_allclose(n(tp), n(jp), rtol=RTOL)
        np.testing.assert_allclose(n(ts.exp_avg), n(js.exp_avg), rtol=RTOL)
        np.testing.assert_allclose(n(ts.exp_avg_sq), n(js.exp_avg_sq), rtol=RTOL)
