"""Port parity: the JAX package's public helpers that the port gained late,
on seeded inputs: `GaussianMap.covariance`, `inverse_sigmoid`
(models/gaussians.py) and `compute_slot_tiles` (ops/tiles.py).

Tolerances: covariance and inverse_sigmoid within rtol 1e-5 (an absolute
floor of 1e-5 x the largest entry for entries that cancel; JAX contracts R S
on a matmul at HIGHEST precision, the port writes the sum out); the slot
tiles exactly (integer bookkeeping and one float compare of the same
arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from test_torch_tiles import binning_inputs

from gaussian_lic_tpu.models import gaussians as jg
from gaussian_lic_tpu.ops import tiles as jtiles
from gaussian_lic_tpu_torch.models import gaussians as tg
from gaussian_lic_tpu_torch.ops import tiles as ttiles

RTOL = 1e-5


def close(a, b):
    a, b = n(a), n(b)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())


@pytest.mark.parametrize("modifier", [1.0, 0.5])
def test_covariance(rng, modifier):
    cap = 64
    log_scale = rng.normal(-2.0, 0.7, (cap, 3)).astype(np.float32)
    quat = rng.normal(size=(cap, 4)).astype(np.float32)
    jm = jg.GaussianMap.empty(cap).replace(log_scale=jnp.asarray(log_scale),
                                            quat=jnp.asarray(quat))
    tm = tg.GaussianMap.empty(cap).replace(log_scale=t(log_scale), quat=t(quat))
    got = tm.covariance(modifier)
    assert got.shape == (cap, 3, 3)
    close(got, jm.covariance(modifier))
    torch.testing.assert_close(got, got.transpose(1, 2))


def test_inverse_sigmoid(rng):
    x = rng.uniform(0.01, 0.99, 257).astype(np.float32)
    got = tg.inverse_sigmoid(t(x))
    close(got, jg.inverse_sigmoid(jnp.asarray(x)))
    close(torch.sigmoid(got), x)


@pytest.mark.parametrize("grid", [(256, 64, 32, 32), (256, 64, 128, 8)])
def test_compute_slot_tiles(rng, grid):
    inp = binning_inputs(rng, 300)
    names = ("xy", "conic", "opacity", "radius")
    live = inp["active"] & (inp["radius"] > 0)
    j = jtiles.compute_slot_tiles(*(jnp.asarray(inp[k]) for k in names), jnp.asarray(live),
                                  jtiles.TileGrid(*grid), 16)
    p = ttiles.compute_slot_tiles(*(t(inp[k]) for k in names), t(live),
                                  ttiles.TileGrid(*grid), 16)
    flat = lambda out: list(out[:4]) + list(out[4])   # noqa: E731
    for a, b in zip(flat(p), flat(j)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(n(a).astype(np.int64), n(b).astype(np.int64))
    # the case is live: slots are kept, culled inside the rect, and cut at K
    valid, in_rect = n(p[2]), n(p[3])
    assert valid.sum() > 200 and (in_rect & ~valid & live[:, None]).any()
    # the k-major binning keeps exactly these slots
    _, touched, _ = ttiles.compute_slot_keys_kmajor(
        t(inp["xy"]), torch.zeros(300, dtype=torch.int64), t(inp["conic"]), t(inp["opacity"]),
        t(inp["radius"]), t(live), ttiles.TileGrid(*grid), 16, 8)
    np.testing.assert_array_equal(n(touched), valid.sum(1))
