"""Port parity: the erank regularizer (ops/erank.py) against the JAX
package's custom VJP (`jax.vjp` of `erank_regularizer`).

Scales are drawn from numpy and grouped by where their erank puts them
against the gate 0 < erank - 1 + 1e-5 < 1 (decided in float64 here):

  * closed, just below the lower edge and just above the upper edge: the
    gradient is the unconditional +1 on z alone, exactly equal;
  * open, away from the lower edge (arg > 0.25) and just inside the upper
    edge: within 1e-6 relative to the batch's largest entry;
  * open, just inside the lower edge (0.005 < arg < 0.05): within 1e-4
    relative to the batch's largest entry. There the factor
    erank / (erank - 1 + 1e-5) is 20-200 and magnifies a one-ulp
    difference in erank: about 10% of XLA's float32 log/exp results on the
    CPU are not correctly rounded (torch's: 0.04% of log, 1% of exp).
    Measured: 2.3e-5.

lambda = 0 leaves only the +1 on z; lambda > 0 scales the gated term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, rel_max, t

from gaussian_lic_tpu.ops.erank import erank_regularizer as jax_erank
from gaussian_lic_tpu_torch.ops.erank import erank_regularizer

WINDOWS = {   # (low, high) of erank - 1 + 1e-5
    "below_lower_edge": (-0.02, -0.0005),
    "inside_lower_edge": (0.005, 0.05),
    "interior": (0.25, 0.95),
    "inside_upper_edge": (0.95, 0.9995),
    "above_upper_edge": (1.0005, 1.05),
    "far_closed": (-2.0, -0.1),
}
TOL = {"below_lower_edge": 0.0, "above_upper_edge": 0.0, "far_closed": 0.0,
       "interior": 1e-6, "inside_upper_edge": 1e-6, "inside_lower_edge": 1e-4}


def gate_arg64(s):
    s = s.astype(np.float64)
    q = s / (s * s).sum(1, keepdims=True)
    return np.exp(-(q * np.log(q)).sum(1)) - 1.0 + 1e-5


@pytest.fixture(scope="module")
def scales_by_window():
    rng = np.random.default_rng(11)
    s = np.exp(rng.uniform(-4.0, 1.0, (200000, 3))).astype(np.float32)
    arg = gate_arg64(s)
    return {w: s[(arg > lo) & (arg < hi)][:256] for w, (lo, hi) in WINDOWS.items()}


def port_vjp(scale, lam):
    x = t(scale).requires_grad_(True)
    y = erank_regularizer(x, lam)
    assert float(y.detach()) == 0.0 and y.shape == ()
    y.backward()
    return n(x.grad)


def jax_vjp(scale, lam):
    _, pull = jax.vjp(lambda s: jax_erank(s, lam), jnp.asarray(scale))
    return np.asarray(pull(jnp.float32(1.0))[0])


def formula64(scale, lam):
    """The reference formula (backward.cu:355-376) in float64."""
    s = scale.astype(np.float64)
    s2 = s * s
    S = s2.sum(1, keepdims=True)
    q = s / S
    erank = np.exp(-(q * np.log(q)).sum(1, keepdims=True))
    arg = erank - 1.0 + 1e-5
    dq = erank / arg * (-np.log(q) - 1.0)
    tot = s2.sum(1, keepdims=True)
    g = lam * 2.0 / S ** 2 * s * (dq * (tot - s2) - ((dq * s2).sum(1, keepdims=True) - dq * s2))
    g = np.where((arg > 0) & (arg < 1), g, 0.0)
    g[:, 2] += 1.0
    return g


class TestErankVjp:
    @pytest.mark.parametrize("lam", [0.0, 0.7])
    @pytest.mark.parametrize("window", list(WINDOWS))
    def test_against_jax_vjp(self, scales_by_window, window, lam):
        s = scales_by_window[window]
        assert len(s) >= 64, window
        got, want = port_vjp(s, lam), jax_vjp(s, lam)
        if lam == 0.0 or TOL[window] == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            assert rel_max(got, want) <= TOL[window]

    def test_closed_gate_is_z_only(self, scales_by_window):
        for w in ("below_lower_edge", "above_upper_edge", "far_closed"):
            g = port_vjp(scales_by_window[w], 0.7)
            np.testing.assert_array_equal(g[:, :2], 0.0)
            np.testing.assert_array_equal(g[:, 2], 1.0)

    def test_cotangent_scales_the_gradient(self, scales_by_window):
        s = t(scales_by_window["interior"]).requires_grad_(True)
        (3.0 * erank_regularizer(s, 0.7)).backward()
        np.testing.assert_allclose(n(s.grad), 3.0 * port_vjp(scales_by_window["interior"], 0.7),
                                   rtol=1e-6)

    def test_formula64_agrees_in_the_interior(self, scales_by_window):
        """The float64 oracle is the same formula: 1e-5 of the batch max."""
        s = scales_by_window["interior"]
        assert rel_max(port_vjp(s, 0.7), formula64(s, 0.7)) <= 1e-5
