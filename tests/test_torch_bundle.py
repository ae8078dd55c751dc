"""Port parity: the k-step train bundles (`engine/trainer.py`) against the
JAX package's `_make_train_bundle`, `_decompose_bundles` and bundled
`MappingEngine.optimize` (golden: tools/make_torch_goldens.py `bundle`;
`live` re-runs the JAX side in interpret mode, minutes).

On the CPU a bundle is its k eager steps; on the card it is one CUDA graph
(the `requires_cuda` test). Tolerances:
  * `_decompose_bundles`: output for output.
  * the CPU bundle against k calls of `train_step`: bit for bit (the same
    operations in the same order).
  * the bundle against JAX's: tests/test_torch_train.py's, loss rel 1e-4
    (sparse Adam drifts on float-noise gradients), n_visible and the
    overflow counters exact, and its ten-step rule for the parameters.
  * the bundled engine: optimize lists, counts and `timers.compiles` exact,
    per-keyframe losses rel 1e-4 (test_torch_train.py's engine rule).
  * the card's graph against the eager steps on the card: the same rules as
    against JAX (K2's atomics sum in another order each run, so noise
    gradients flip as they do across the packages).

JAX is imported only inside the tests that use it, so the card test
collects on a machine without JAX.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_port_helpers import (  # noqa: F401 (cuda_device: a fixture)
    GOLDEN_SOURCES, cuda_device, frames_from, golden_tool, initial_state, load_golden, n,
    small_rig,
)

from gaussian_lic_tpu_torch.config import Params, load_params
from gaussian_lic_tpu_torch.engine import trainer
from gaussian_lic_tpu_torch.engine.dataset import KeyframeBuffer, build_camera
from gaussian_lic_tpu_torch.engine.trainer import (
    MappingEngine, _decompose_bundles, _make_train_bundle, train_step,
)
from gaussian_lic_tpu_torch.ops import adam, blend

MAP_FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit")
PARAM_MAX_GAP = dict(xyz=1e-4, dc=1e-2, sh_rest=5e-4, log_scale=6e-2, quat=1.2e-2,
                     opa_logit=1e-2)   # tests/test_torch_train.py's ten-step limits
METRICS = ("loss", "n_visible", "visible_sum", "budget_lost", "truncated", "overflow")


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def bundle_golden(request):
    return load_golden("bundle", request.param)


@pytest.fixture(scope="module")
def train_golden():
    return load_golden("train", "file")


def split(flat, lens):
    return np.split(np.asarray(flat), np.cumsum(lens)[:-1])


def assert_params_close(gm, want: dict, count: int) -> None:
    """tests/test_torch_train.py's ten-step rule, per map field: 80% within
    1e-4, median gap <= 1e-5, largest gap <= PARAM_MAX_GAP."""
    for f in MAP_FIELDS:
        diff = np.abs(n(getattr(gm, f))[:count] - want[f][:count])
        assert np.mean(diff <= 1e-4) >= 0.8, f
        assert np.median(diff) <= 1e-5, f
        assert diff.max() <= PARAM_MAX_GAP[f], f


class TestDecompose:
    @settings(max_examples=300, deadline=None)
    @given(st.integers(0, 500), st.lists(st.integers(1, 120), min_size=1, max_size=5))
    def test_matches_jax(self, count, sizes):
        from gaussian_lic_tpu.engine.trainer import _decompose_bundles as jax_decompose

        assert _decompose_bundles(count, tuple(sizes)) == jax_decompose(count, tuple(sizes))

    def test_golden_cases(self, bundle_golden):
        d = bundle_golden
        sizes = split(d["dec_sizes"], d["dec_sizes_len"])
        outs = split(d["dec_out"], d["dec_out_len"])
        for count, s, want in zip(d["dec_n"], sizes, outs):
            assert _decompose_bundles(int(count), tuple(int(v) for v in s)) == want.tolist()

    def test_shipped_sizes(self):
        """A full keyframe, 100 steps, is 64 + 16 + 16 + 4."""
        assert _decompose_bundles(100, Params().opt_bundle_sizes) == [64, 16, 16, 4]

    @pytest.mark.parametrize("sizes", [(0,), (64, 16, 0, 1), (4, -2), (2.5,)])
    def test_params_reject_nonpositive(self, sizes):
        """JAX's decomposition never ends on a size <= 0; the port's Params
        refuses such sizes, from a YAML list too."""
        with pytest.raises(ValueError, match="opt_bundle_sizes"):
            Params(opt_bundle_sizes=sizes)
        with pytest.raises(ValueError, match="opt_bundle_sizes"):
            load_params(opt_bundle_sizes=list(sizes))


class TestBundleOnTheCPU:
    def test_equals_eager_steps(self, train_golden, bundle_golden):
        """The CPU bundle is its k eager steps: map, moments and the
        aggregated metrics bit for bit."""
        intr, cfg, _, gm0, kf, opt0 = initial_state(train_golden)
        idxs = bundle_golden["bundle_idxs"]
        gm, opt, steps = gm0, opt0, []
        for i, idx in enumerate(idxs):
            gm, opt, m = train_step(gm, opt, kf, int(idx), 3 + i, intr=intr, cfg=cfg)
            steps.append(m)
        gm_b, opt_b, mb = _make_train_bundle(intr, cfg, len(idxs))(
            gm0, opt0, kf, torch.as_tensor(idxs), 3)
        for f in MAP_FIELDS + ("count",):
            assert torch.equal(getattr(gm_b, f), getattr(gm, f)), f
        for name in opt:
            assert torch.equal(opt_b[name].exp_avg, opt[name].exp_avg), name
            assert torch.equal(opt_b[name].exp_avg_sq, opt[name].exp_avg_sq), name
        assert torch.equal(mb["loss"], steps[-1]["loss"])
        assert int(mb["n_visible"]) == int(steps[-1]["n_visible"])
        assert int(mb["visible_sum"]) == sum(int(m["n_visible"]) for m in steps)
        assert mb["visible_sum"].dtype == torch.int32
        assert int(mb["overflow"]) == int(mb["budget_lost"]) + int(mb["truncated"]) == 0

    def test_against_jax(self, train_golden, bundle_golden):
        d = bundle_golden
        intr, cfg, count, gm0, kf, opt0 = initial_state(train_golden)
        gm, _, m = _make_train_bundle(intr, cfg, len(d["bundle_idxs"]))(
            gm0, opt0, kf, torch.as_tensor(d["bundle_idxs"]), 1)
        assert float(m["loss"]) == pytest.approx(float(d["bundle_m_loss"]), rel=1e-4)
        for k in METRICS[1:]:
            assert int(m[k]) == int(d[f"bundle_m_{k}"]), k
        assert_params_close(gm, {f: d[f"bundle_{f}"] for f in MAP_FIELDS}, count)

    def test_in_place_step_is_the_step(self, train_golden):
        """train_step with `in_place` (the step of the engine's CUDA graphs)
        gives the step's map, moments and metrics bit for bit, in the
        tensors it was given."""
        intr, cfg, _, gm0, kf, opt0 = initial_state(train_golden)
        gm1, opt1, m1 = train_step(gm0, opt0, kf, 1, 1, intr=intr, cfg=cfg)
        gm = gm0.replace(**{f: getattr(gm0, f).clone() for f in MAP_FIELDS})
        opt = {k: adam.AdamState(st.exp_avg.clone(), st.exp_avg_sq.clone())
               for k, st in opt0.items()}
        gm2, opt2, m2 = train_step(gm, opt, kf, 1, 1, intr=intr, cfg=cfg, in_place=True)
        for f in MAP_FIELDS + ("count",):
            assert getattr(gm2, f) is getattr(gm, f), f
            assert torch.equal(getattr(gm2, f), getattr(gm1, f)), f
        for name in opt:
            assert opt2[name].exp_avg is opt[name].exp_avg, name
            assert opt2[name].exp_avg_sq is opt[name].exp_avg_sq, name
            assert torch.equal(opt2[name].exp_avg, opt1[name].exp_avg), name
            assert torch.equal(opt2[name].exp_avg_sq, opt1[name].exp_avg_sq), name
        for k in ("loss", "n_visible", "budget_lost", "truncated"):
            assert torch.equal(m2[k], m1[k]), k
        assert not torch.equal(gm.xyz, gm0.xyz)

    def test_rejects_wrong_length(self, train_golden):
        intr, cfg, _, gm, kf, opt = initial_state(train_golden)
        with pytest.raises(ValueError, match="4-step bundle got 3"):
            _make_train_bundle(intr, cfg, 4)(gm, opt, kf, torch.tensor([0, 1, 2]), 1)

    def test_dense_adam_device_step(self):
        """dense_adam_update with a 0-d step tensor (what a graph's step
        passes) gives the int path's floats, and those of the earlier
        formula with a Python float divisor, bit for bit."""
        rng = np.random.default_rng(11)
        p, g, m, v = (torch.as_tensor(rng.normal(size=(3, 4)).astype(np.float32))
                      for _ in range(4))
        v = v.abs()
        state = adam.AdamState(m, v)
        for t in (1, 2, 7, 100, 1234, 99999):
            want, st_want = adam.dense_adam_update(p, g, state, lr=1e-3, step_count=t)
            m1 = adam.BETA1 * m + (1 - adam.BETA1) * g
            v1 = adam.BETA2 * v + (1 - adam.BETA2) * g * g
            before = p - 1e-3 * (m1 / (1 - adam.BETA1 ** float(t))) / (
                torch.sqrt(v1 / (1 - adam.BETA2 ** float(t))) + 1e-8)
            assert torch.equal(want, before), t
            for dtype in (torch.int64, torch.int32):
                got, st_got = adam.dense_adam_update(p, g, state, lr=1e-3,
                                                     step_count=torch.tensor(t, dtype=dtype))
                assert torch.equal(got, want), (t, dtype)
                assert torch.equal(st_got.exp_avg, st_want.exp_avg)
                assert torch.equal(st_got.exp_avg_sq, st_want.exp_avg_sq)

    def test_camera_tensor_index(self):
        """KeyframeBuffer.camera and .image take a 0-d tensor index (read on
        the device) and give what the int index gives."""
        intr, _ = small_rig()
        rng = np.random.default_rng(12)
        kf = KeyframeBuffer.empty(4, intr)
        for i in range(4):
            R_wc, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            fr = frames_from(dict(frame_R_wc=[R_wc.astype(np.float32)],
                                  frame_t_wc=[rng.normal(size=3).astype(np.float32)],
                                  frame_images=[rng.integers(0, 255, (64, 64, 3), np.uint8)],
                                  frame_points=[np.zeros((0, 3), np.float32)],
                                  frame_colors=[np.zeros((0, 3), np.float32)]))[0]
            kf.set_frame(i, build_camera(intr, fr), fr.image_u8())
        for i in range(4):
            for idx in (torch.tensor(i), torch.tensor(i, dtype=torch.int32)):
                a, b = kf.camera(intr, i), kf.camera(intr, idx)
                assert torch.equal(a.pose.R_cw, b.pose.R_cw)
                assert torch.equal(a.pose.t_cw, b.pose.t_cw)
                assert torch.equal(a.full_proj, b.full_proj)
                assert torch.equal(kf.image(idx), kf.images[i])

    def test_launches_apart(self):
        """Launches counted inside the block leave LAUNCHES and come out in
        the yielded dict (a graph's capture); those before and after stay."""
        blend.reset_launches()
        blend.LAUNCHES["forward"] += 2
        with blend.launches_apart() as apart:
            blend.LAUNCHES["forward"] += 3
            blend.LAUNCHES["backward"] += 1
        blend.LAUNCHES["backward"] += 5
        assert apart == {"forward": 3, "forward_no_color": 0, "backward": 1}
        assert blend.LAUNCHES == {"forward": 2, "forward_no_color": 0, "backward": 5}
        blend.reset_launches()


class TestBundledEngine:
    def run_engine(self, d, sizes=(4, 2)):
        _, cfg = small_rig()
        eng = MappingEngine(cfg.replace(opt_bundle_sizes=sizes), device="cpu")
        eng.rng = golden_tool()._RecordingRng(eng.rng)
        counts, losses = [], []
        for fr in frames_from(d):
            if eng.add_frame(fr):
                counts.append(int(eng.gm.count))
                losses.append(eng.last_metrics["loss"])
        return eng, counts, losses

    def test_against_jax(self, bundle_golden):
        """5 keyframes in bundles of 4 and 2 (lists of 3-5 steps split into
        several), with a keyframe-buffer growth at the 5th."""
        d = bundle_golden
        eng, counts, losses = self.run_engine(d)
        np.testing.assert_array_equal(np.concatenate(eng.rng.lists), d["opt_lists"])
        np.testing.assert_array_equal([len(x) for x in eng.rng.lists], d["opt_list_lens"])
        np.testing.assert_array_equal(counts, d["counts"])
        np.testing.assert_allclose(losses, d["losses"], rtol=1e-4)
        assert eng.timers.compiles == int(d["compiles"])
        assert eng.last_metrics["overflow"] == float(d["overflow"])
        assert sorted(eng._bundles) == [1, 2, 4]
        assert eng.exposure_steps == sum(d["opt_list_lens"])

    def test_mid_bundle_overflow_grows_the_budget(self, bundle_golden, monkeypatch):
        """A scripted `_bundles[3]` whose middle step loses 7 slots to the
        splat budget (its last step fits): the bundle's max reaches
        last_metrics, the budget grows and the bundle cache is dropped."""
        eng, _, _ = self.run_engine(
            {k: v[:6] if k.startswith("frame_") else v for k, v in bundle_golden.items()},
            sizes=(3,))
        assert eng.kf_count == 3 and sorted(eng._bundles) == [1, 3]
        calls = []

        def scripted(*a, **kw):
            gm, opt, m = train_step(*a, **kw)
            calls.append(len(calls))
            if len(calls) == 2:
                m = dict(m, budget_lost=torch.tensor(7, dtype=torch.int32))
            return gm, opt, m

        monkeypatch.setattr(trainer, "train_step", scripted)
        eng._bundles[3] = _make_train_bundle(eng.intr, eng.cfg, 3, eng.graphs)
        factor, compiles = eng.cfg.splat_budget_factor, eng.timers.compiles
        eng.optimize()
        assert len(calls) == 3
        assert eng.last_metrics["budget_lost"] == 7.0
        assert eng.last_metrics["overflow"] == 7.0 + eng.last_metrics["truncated"]
        assert eng.cfg.splat_budget_factor > factor
        assert eng.timers.compiles == compiles + 1
        assert eng._bundles == {}


@pytest.mark.requires_cuda
def test_graph_bundle_on_the_card(cuda_device):
    """A 4-step bundle as a CUDA graph against 4 eager steps on the card,
    from a seeded 2,000-Gaussian bench state at 64x64 (made without JAX):
    the same loss and parameters by test_torch_train.py's rules, the eager
    steps' K1/K2 launches counted at each replay and none at the capture;
    the state it returns is its static set, which the next call takes with
    nothing copied, and a state from elsewhere is copied in."""
    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

    cfg = Params(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0,
                 skybox_points_num=0, initial_capacity=2048, max_tiles_per_gaussian=16)
    intr, gm0, kf, opt0 = make_bench_state(cfg, 2000, cuda_device)
    idxs = torch.tensor([2, 0, 1, 1], device=cuda_device)
    blend.reset_launches()
    gm, opt = gm0, opt0
    for i in range(4):
        gm, opt, m = train_step(gm, opt, kf, int(idxs[i]), 1 + i, intr=intr, cfg=cfg)
    eager = dict(blend.LAUNCHES)
    graphs = trainer.BundleGraphs()
    bundle = _make_train_bundle(intr, cfg, 4, graphs)
    blend.reset_launches()
    gm_b, opt_b, mb = bundle(gm0, opt0, kf, idxs, 1)
    torch.cuda.synchronize()
    assert blend.LAUNCHES == eager == {"forward": 4, "forward_no_color": 0, "backward": 4}
    assert graphs.warmup_launches["forward"] == 1 and len(graphs.captures) == 1
    assert float(mb["loss"]) == pytest.approx(float(m["loss"]), rel=1e-4)
    assert_params_close(gm_b, {f: n(getattr(gm, f)) for f in MAP_FIELDS}, 2000)
    gm_c, _, _ = bundle(gm_b, opt_b, kf, idxs, 5)
    assert gm_c.xyz is gm_b.xyz and len(graphs.captures) == 1
    gm_d, _, md = bundle(gm0, opt0, kf, idxs, 1)       # copied in: the first bundle again
    assert float(md["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-4)
    assert gm_d.xyz is gm_b.xyz and len(graphs.captures) == 1
    assert blend.LAUNCHES["backward"] == 12


@pytest.mark.requires_cuda
def test_capture_survives_a_dead_cycle_of_graphs(cuda_device):
    """Destroying a CUDA graph while another is captured invalidates the
    capture, and the collector can reach a dead reference cycle that holds
    graphs at any allocation inside a capture (torch.cuda.graph no longer
    collects first). A set's second capture, with such a cycle alive and a
    step that collects as an automatic collection would, must still capture
    and replay: BundleGraphs collects before a capture."""
    import functools
    import gc
    import math

    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

    cfg = Params(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0,
                 skybox_points_num=0, initial_capacity=2048, max_tiles_per_gaussian=16)
    intr, gm0, kf, opt0 = make_bench_state(cfg, 2000, cuda_device)
    idxs = torch.tensor([2, 0, 1, 1], device=cuda_device)
    graphs = trainer.BundleGraphs()
    _make_train_bundle(intr, cfg, 4, graphs)(gm0, opt0, kf, idxs, 1)

    def collecting_step(*args, **kw):
        gc.collect()
        return train_step(*args, **kw)

    gc.disable()   # keeps the cycle below alive until a collection is asked for
    try:
        dead = trainer.BundleGraphs()
        _make_train_bundle(intr, cfg, 1, dead)(gm0, opt0, kf, idxs[:1], 1)
        dead.cycle = dead
        del dead
        bundle = trainer._bundle_of(functools.partial(collecting_step, intr=intr, cfg=cfg),
                                    cfg, 2, graphs)
        _, _, m = bundle(gm0, opt0, kf, idxs[:2], 1)
        torch.cuda.synchronize()
    finally:
        gc.enable()
    assert [k for k, _, _ in graphs.captures] == [4, 2] and math.isfinite(float(m["loss"]))


def _state_grads(loss, leaves, allow_unused=False):
    """Gradients made from the leaves alone: unlike K2's float atomics,
    whose sums change order run to run, they make a step a function of its
    state, so that a graph and eager steps compare bit for bit."""
    return tuple(torch.sin(3.0 * leaf.detach()) * 1e-3 for leaf in leaves)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.requires_cuda
def test_in_place_graph_is_the_eager_steps_bit_for_bit(cuda_device, monkeypatch):
    """With gradients that are a function of the state, a 4-step graph of
    the in-place step gives 4 eager out-of-place steps' map, moments and
    loss bit for bit. Its warm-up (on a clone) leaves the set's floats as
    they were, the graph ends with nothing to copy into the set (the last
    step's tensors are the set's), the state it returns is the set, and
    the caller's state, copied in, is never written."""
    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

    monkeypatch.setattr(torch.autograd, "grad", _state_grads)
    cfg = Params(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0,
                 skybox_points_num=0, initial_capacity=2048, max_tiles_per_gaussian=16)
    intr, gm0, kf, opt0 = make_bench_state(cfg, 2000, cuda_device)
    start = [_bits(getattr(gm0, f)).clone() for f in MAP_FIELDS]
    idxs = torch.tensor([2, 0, 1, 1], device=cuda_device)
    gm, opt = gm0, opt0
    for i in range(4):
        gm, opt, m = train_step(gm, opt, kf, int(idxs[i]), 1 + i, intr=intr, cfg=cfg)
    graphs = trainer.BundleGraphs()
    warm, stored = [], []
    real_warm_up, real_store = graphs._warm_up, graphs._store

    def warm_up(step, gm_s, opt_s, kf_, ids):
        before = [_bits(t).clone() for _, t in graphs._tensors(gm_s, opt_s)]
        real_warm_up(step, gm_s, opt_s, kf_, ids)
        torch.cuda.synchronize()
        warm.append(all(torch.equal(a, _bits(t))
                        for a, (_, t) in zip(before, graphs._tensors(gm_s, opt_s))))

    def store(gm_, opt_):
        stored.append([nm for nm, t in graphs._tensors(gm_, opt_) if t is not graphs.state[nm]])
        real_store(gm_, opt_)

    graphs._warm_up, graphs._store = warm_up, store
    bundle = _make_train_bundle(intr, cfg, 4, graphs)
    adam.reset_launches()
    gm_b, opt_b, mb = bundle(gm0, opt0, kf, idxs, 1)
    torch.cuda.synchronize()
    assert warm == [True] and graphs.warmup_launches["sparse_adam"] == 1
    assert stored == [[]] and adam.LAUNCHES["sparse_adam"] == 4

    def assert_is_eager(gm_x, opt_x, m_x):
        for f in MAP_FIELDS + ("count",):
            assert getattr(gm_x, f) is graphs.state[f], f
            assert torch.equal(_bits(getattr(gm_x, f)), _bits(getattr(gm, f))), f
        for name in opt:
            for c, a, b in (("m", opt_x[name].exp_avg, opt[name].exp_avg),
                            ("v", opt_x[name].exp_avg_sq, opt[name].exp_avg_sq)):
                assert a is graphs.state[f"{c}_{name}"], name
                assert torch.equal(_bits(a), _bits(b)), (c, name)
        assert torch.equal(m_x["loss"], m["loss"])
        assert int(m_x["n_visible"]) == int(m["n_visible"])

    assert_is_eager(gm_b, opt_b, mb)
    # the caller's state was copied in and never written: from it again,
    # the same 4 steps (the whole map copied in first)
    assert all(torch.equal(a, _bits(getattr(gm0, f))) for a, f in zip(start, MAP_FIELDS))
    gm_c, opt_c, mc = bundle(gm0, opt0, kf, idxs, 1)
    torch.cuda.synchronize()
    assert len(stored) == 2 and "xyz" in stored[1] and len(graphs.captures) == 1
    assert_is_eager(gm_c, opt_c, mc)
