"""The sparse Adam of all six parameter groups in one call
(`ops/adam.py:sparse_adam_update_groups`, kernel K7 on the card).

  * on CPU tensors it equals six `sparse_adam_update` calls bit for bit,
    with rows masked (invisible), visible and inactive (masked, with a
    zero gradient), and a zero gradient on a visible row;
  * it matches the JAX package's `sparse_adam_update` within
    tests/test_torch_losses_optim.py's tolerance (rtol 1e-5, atol 1e-7);
  * `requires_cuda`: K7 against the plain loop on the card, bit for bit
    (the same float32 operations in order, each rounded once), in one
    launch, writing none of its inputs.

JAX is imported inside the test that uses it, so the card test collects
without it.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device, n  # noqa: F401 (a fixture)

from gaussian_lic_tpu_torch.ops import adam as tadam

P = 97
# PARAM_GROUPS' shapes: xyz, dc, sh_rest, opacity, log_scale, quat
SHAPES = {"xyz": (3,), "dc": (3,), "sh_rest": (15, 3), "opacity": (), "log_scale": (3,),
          "quat": (4,)}
LRS = {"xyz": 1.6e-4, "dc": 2.5e-3, "sh_rest": 1.25e-4, "opacity": 0.05, "log_scale": 5e-3,
       "quat": 1e-3}
RTOL, ATOL = 1e-5, 1e-7   # test_torch_losses_optim.py's


def groups(seed=5):
    """numpy (params, grads, m, v) of the six groups and the visible mask:
    a third of the rows invisible, two inactive rows (invisible, zero
    gradient), one visible row with a zero gradient."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        out.append({k: rng.normal(size=(P,) + s).astype(np.float32) for k, s in SHAPES.items()})
    p, g, m, v = out
    v = {k: np.abs(a) for k, a in v.items()}
    visible = rng.uniform(size=P) < 0.66
    visible[[P - 1, P - 2]] = False
    visible[3] = True
    for k in SHAPES:
        g[k][[P - 1, P - 2, 3]] = 0.0
    return p, g, m, v, visible


def torch_groups(device="cpu"):
    p, g, m, v, visible = groups()
    dev = dict(device=device)
    return ({k: torch.as_tensor(a, **dev) for k, a in p.items()},
            {k: torch.as_tensor(a, **dev) for k, a in g.items()},
            {k: tadam.AdamState(torch.as_tensor(m[k], **dev), torch.as_tensor(v[k], **dev))
             for k in SHAPES},
            torch.as_tensor(visible, **dev))


def per_group(params, grads, states, visible):
    out = {k: tadam.sparse_adam_update(params[k], grads[k], states[k], visible, LRS[k])
           for k in SHAPES}
    return {k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()}


def assert_same(a, b):
    for k in SHAPES:
        assert torch.equal(a[0][k], b[0][k]), k
        assert torch.equal(a[1][k].exp_avg, b[1][k].exp_avg), k
        assert torch.equal(a[1][k].exp_avg_sq, b[1][k].exp_avg_sq), k


def test_groups_equal_per_group_calls():
    params, grads, states, visible = torch_groups()
    got = tadam.sparse_adam_update_groups(params, grads, states, visible, LRS)
    assert_same(got, per_group(params, grads, states, visible))
    assert list(got[0]) == list(SHAPES) == list(got[1])
    # masked rows keep their values; the visible zero-gradient row moves
    hidden = ~visible
    for k in SHAPES:
        assert torch.equal(got[0][k][hidden], params[k][hidden])
        assert torch.equal(got[1][k].exp_avg[hidden], states[k].exp_avg[hidden])
        assert not torch.equal(got[0][k][3], params[k][3])


def test_against_jax():
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops import adam as jadam

    p, g, m, v, visible = groups()
    params, grads, states, vis = torch_groups()
    got_p, got_s = tadam.sparse_adam_update_groups(params, grads, states, vis, LRS)
    for k in SHAPES:
        jp, js = jadam.sparse_adam_update(jnp.asarray(p[k]), jnp.asarray(g[k]),
                                          jadam.AdamState(jnp.asarray(m[k]), jnp.asarray(v[k])),
                                          jnp.asarray(visible), LRS[k])
        for a, b in ((got_p[k], jp), (got_s[k].exp_avg, js.exp_avg),
                     (got_s[k].exp_avg_sq, js.exp_avg_sq)):
            np.testing.assert_allclose(n(a), n(b), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.requires_cuda
def test_k7_on_the_card(cuda_device):
    params, grads, states, visible = torch_groups(cuda_device)
    inputs = [t.clone() for d in (params, grads) for t in d.values()]
    inputs += [t.clone() for st in states.values() for t in st]
    before = tadam.LAUNCHES["sparse_adam"]
    got = tadam.sparse_adam_update_groups(params, grads, states, visible, LRS)
    assert tadam.LAUNCHES["sparse_adam"] == before + 1
    assert_same(got, per_group(params, grads, states, visible))
    now = [t for d in (params, grads) for t in d.values()]
    now += [t for st in states.values() for t in st]
    assert all(torch.equal(a, b) for a, b in zip(inputs, now))
