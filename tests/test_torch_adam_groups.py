"""The sparse Adam of all six parameter groups in one call
(`ops/adam.py:sparse_adam_update_groups`, kernel K7 on the card).

  * on CPU tensors it equals six `sparse_adam_update` calls bit for bit,
    with rows masked (invisible), visible and inactive (masked, with a
    zero gradient), and a zero gradient on a visible row;
  * it matches the JAX package's `sparse_adam_update` within
    tests/test_torch_losses_optim.py's tolerance (rtol 1e-5, atol 1e-7);
  * the in-place form (`sparse_adam_update_groups_`) on CPU tensors gives
    the visible rows those floats bit for bit and leaves every other row,
    NaN and inf included, and the rows past `count` as they were, in the
    tensors passed in, which it returns;
  * `requires_cuda`: K7 against the plain loop on the card, bit for bit
    (the same float32 operations in order, each rounded once), in one
    launch, writing none of its inputs; its in-place form bit for bit
    against the out-of-place form and the plain loop at the benchmark
    cells' shapes, on unaligned groups and short chunks, leaving the other
    rows' bits.

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


def bits(t):
    """The float32 tensor's bit patterns (NaN payloads compare)."""
    return t.contiguous().view(torch.int32)


def same_bits(a, b) -> bool:
    return torch.equal(bits(a), bits(b))


def clone_state(params, states):
    return ({k: t.clone() for k, t in params.items()},
            {k: tadam.AdamState(st.exp_avg.clone(), st.exp_avg_sq.clone())
             for k, st in states.items()})


def poison(params, grads, states, rows):
    """NaN and inf in every float of `rows` of every group: the in-place form
    must neither use nor rewrite them."""
    for k in SHAPES:
        for t, val in ((params[k], float("nan")), (grads[k], float("inf")),
                       (states[k].exp_avg, float("-inf")), (states[k].exp_avg_sq, float("nan"))):
            t[rows] = val


def assert_in_place(params, grads, states, visible, count=None):
    """`sparse_adam_update_groups_` on (params, states) against the
    out-of-place form and the per-group loop on copies: the visible rows'
    floats bit for bit, every other row's bits unchanged, the same objects
    returned."""
    want = tadam.sparse_adam_update_groups(params, grads, states, visible, LRS)
    plain = per_group(params, grads, states, visible)
    before = clone_state(params, states)
    ids = ({k: id(t) for k, t in params.items()},
           {k: (id(st), id(st.exp_avg), id(st.exp_avg_sq)) for k, st in states.items()})
    got = tadam.sparse_adam_update_groups_(params, grads, states, visible, LRS, count=count)
    assert got[0] is params and got[1] is states
    assert ids == ({k: id(t) for k, t in params.items()},
                   {k: (id(st), id(st.exp_avg), id(st.exp_avg_sq)) for k, st in states.items()})
    for k in SHAPES:
        for now, was, w, pl in ((params[k], before[0][k], want[0][k], plain[0][k]),
                                (states[k].exp_avg, before[1][k].exp_avg, want[1][k].exp_avg,
                                 plain[1][k].exp_avg),
                                (states[k].exp_avg_sq, before[1][k].exp_avg_sq,
                                 want[1][k].exp_avg_sq, plain[1][k].exp_avg_sq)):
            assert same_bits(now[visible], w[visible]), k
            assert same_bits(now[visible], pl[visible]), k
            assert same_bits(now[~visible], was[~visible]), k


@pytest.mark.parametrize("rows", [1, 31, 33, 97])
def test_in_place_equals_per_group_calls(rows):
    """Every group width (3, 3, 45, 1, 3, 4) at row counts around a warp's
    32-row chunk, a third of the rows invisible, the last rows inactive."""
    params, grads, states, visible = torch_groups()
    params = {k: t[:rows].clone() for k, t in params.items()}
    grads = {k: t[:rows].clone() for k, t in grads.items()}
    states = {k: tadam.AdamState(st.exp_avg[:rows].clone(), st.exp_avg_sq[:rows].clone())
              for k, st in states.items()}
    visible = visible[:rows].clone()
    visible[0] = True
    assert_in_place(params, grads, states, visible)


def test_in_place_leaves_nan_rows_and_rows_past_count():
    """Invisible rows hold NaN and inf parameters, gradients and moments;
    rows at or past `count` are invisible too: all keep their bits, the
    visible rows get the plain floats."""
    params, grads, states, visible = torch_groups()
    count = P - 20
    visible[count:] = False
    hidden = (~visible).nonzero().squeeze(1)
    poison(params, grads, states, hidden[::2])
    assert_in_place(params, grads, states, visible, count=torch.tensor(count, dtype=torch.int32))
    for k in SHAPES:
        assert torch.isfinite(params[k][visible]).all(), k
        assert torch.isnan(params[k][hidden[::2]]).all(), k


def test_in_place_count_bounds_the_rows():
    """A row at or past `count` is left as it is even where `visible` marks
    it (the walk stops at the count, as K7's does)."""
    params, grads, states, visible = torch_groups()
    visible[:] = True
    before = clone_state(params, states)
    tadam.sparse_adam_update_groups_(params, grads, states, visible, LRS,
                                     count=torch.tensor(40, dtype=torch.int32))
    for k in SHAPES:
        assert same_bits(params[k][40:], before[0][k][40:]), k
        assert same_bits(states[k].exp_avg[40:], before[1][k].exp_avg[40:]), k
        assert not torch.equal(params[k][:40], before[0][k][:40]), k


def cell_groups(device, rows, live, seed=3):
    """The six groups at a benchmark cell's shape on `device`: seeded
    parameters, gradients and moments, `live` rows below the count, of which
    runs of 1-4096 rows are visible or not (a view sees the map in runs of
    its insertion order), NaN and inf in a sample of the invisible rows."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    params = {k: normal((rows,) + s) for k, s in SHAPES.items()}
    grads = {k: normal((rows,) + s, 1e-3) for k, s in SHAPES.items()}
    states = {k: tadam.AdamState(normal((rows,) + s, 1e-4), normal((rows,) + s, 1e-6).abs())
              for k, s in SHAPES.items()}
    runs = torch.randint(1, 4097, (2 * rows // 2048 + 2,), generator=gen, device=device)
    flags = torch.arange(runs.numel(), device=device) % 2 == 0
    visible = torch.repeat_interleave(flags, runs)[:rows]
    visible = torch.cat([visible, visible.new_zeros(rows - visible.numel())])
    visible[live:] = False
    hidden = (~visible).nonzero().squeeze(1)
    poison(params, grads, states, hidden[::7])
    return params, grads, states, visible


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,live", [(1 << 20, 1 << 20), (2_097_152, 1_572_864),
                                       (2_097_152, 1_100_000)],
                         ids=["fastlivo", "r3live_indoor", "stream"])
def test_k7_in_place_at_the_cells_shapes(cuda_device, rows, live):
    """The in-place K7 (count on the device) bit for bit against the
    out-of-place K7 and the plain loop on the visible rows, every other
    row's bits kept, at fastlivo's 2^20 rows all live, r3live_indoor's
    1,572,864 live in 2,097,152 rows and the stream's 1.1M live there."""
    params, grads, states, visible = cell_groups(cuda_device, rows, live)
    before = tadam.LAUNCHES["sparse_adam"]
    assert_in_place(params, grads, states, visible,
                    count=torch.tensor(live, dtype=torch.int32, device=cuda_device))
    assert tadam.LAUNCHES["sparse_adam"] == before + 2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows", [1, 31, 97, 4099])
def test_k7_in_place_unaligned_and_short_chunks(cuda_device, rows):
    """Groups that start 4 bytes past a 16-byte boundary (K7's word a lane)
    beside aligned ones, and row counts that end inside a 32-row chunk."""
    params, grads, states, visible = cell_groups(cuda_device, rows, rows - rows // 3, seed=rows)
    visible[0] = True

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device)[1:]
        return buf.view(t.shape).copy_(t)

    for k in ("xyz", "sh_rest", "quat"):
        params[k], grads[k] = shifted(params[k]), shifted(grads[k])
        states[k] = tadam.AdamState(shifted(states[k].exp_avg), shifted(states[k].exp_avg_sq))
        assert params[k].data_ptr() % 16 == 4
    assert_in_place(params, grads, states, visible)


@pytest.mark.requires_cuda
def test_k7_refuses_a_partly_aliased_table(cuda_device):
    """In place is every group's outputs being its inputs; a mix is refused."""
    params, grads, states, visible = torch_groups(cuda_device)
    outs = {k: (params[k] if k == "xyz" else torch.empty_like(params[k])) for k in SHAPES}
    out_s = {k: (states[k] if k == "xyz" else tadam.AdamState(torch.empty_like(params[k]),
                                                               torch.empty_like(params[k])))
             for k in SHAPES}
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        tadam._k7(params, grads, states, visible, LRS, outs, out_s, None, tadam.BETA1,
                  tadam.BETA2, tadam.EPS)
