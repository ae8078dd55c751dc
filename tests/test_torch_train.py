"""Port parity: the slice as a whole — train steps and the streaming engine —
against the JAX package (goldens from tools/make_torch_goldens.py; `live`
re-runs the JAX side in interpret mode, minutes).

Tolerances and why:
  * step 1: loss rel 1e-5; raw gradients 1e-4 relative to each group's max
    (PARITY.md C12); updated params rtol 1e-5. The two packages start from
    the same state, so only float32 summation order separates them.
  * steps 2-10 and the engine's per-keyframe losses: rel 1e-4. Sparse Adam
    without bias correction is sign-like where a gradient is float noise
    (its first step is -3.16 lr sign(g)), so last-ulp differences flip some
    updates and the runs drift apart slowly (measured: 2.8e-5 after 10 steps,
    4.2e-6 after the engine's 6).
  * params after 10 steps: at least 80% of each group within 1e-4, each
    group's median gap at most 1e-5, and its largest gap under PARAM_MAX_GAP.
    Measured on the committed golden (median / largest): xyz 0 / 6.5e-5,
    dc 2.4e-7 / 6.4e-3, sh_rest 1.2e-8 / 3.3e-4, log_scale 1.1e-6 / 4.2e-2,
    quat 2.7e-6 / 7.8e-3, opa_logit 2.9e-6 / 5.8e-3; the limits sit at
    about 1.5x the largest. The few large gaps are entries whose gradient is
    float noise, where one flipped sign moves the entry by ~lr per step.
  * keyframe order and Gaussian counts: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    GOLDEN_SOURCES, frames_from, golden_tool, initial_state, load_golden, n, rel_max, small_rig,
)

from gaussian_lic_tpu.ops import adam as jadam
from gaussian_lic_tpu.ops import erank as jerank
from gaussian_lic_tpu.ops import losses as jl
from gaussian_lic_tpu_torch.engine.trainer import (
    PARAM_GROUPS, MappingEngine, _render_kw, train_step,
)
from gaussian_lic_tpu_torch.ops.adam import AdamState
from gaussian_lic_tpu_torch.ops.rasterize import render_map

MAP_FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit")
PARAM_MAX_GAP = dict(xyz=1e-4, dc=1e-2, sh_rest=5e-4, log_scale=6e-2, quat=1.2e-2,
                     opa_logit=1e-2)


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def train_golden(request):
    return load_golden("train", request.param)


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def engine_golden(request):
    return load_golden("engine", request.param)


@pytest.fixture(scope="module")
def train_run(train_golden):
    """The port's 10 steps from the golden's initial state and keyframes."""
    d = train_golden
    intr, cfg, count, gm, kf, opt = initial_state(d)
    steps = []
    for s, idx in enumerate(d["idxs"]):
        gm, opt, m = train_step(gm, opt, kf, int(idx), s + 1, intr=intr, cfg=cfg,
                                with_grads=(s == 0))
        steps.append((gm, m))
    return d, count, cfg, steps


class TestTrainSteps:
    def test_first_step(self, train_run):
        d, count, _, steps = train_run
        gm, m = steps[0]
        assert float(m["loss"]) == pytest.approx(float(d["losses"][0]), rel=1e-5)
        assert int(m["n_visible"]) == int(d["n_visible"][0])
        for g in PARAM_GROUPS:
            assert rel_max(n(m["grads"][g])[:count], d[f"grad1_{g}"]) < 1e-4, g
        for f in MAP_FIELDS:
            np.testing.assert_allclose(n(getattr(gm, f))[:count], d[f"step1_{f}"],
                                       rtol=1e-5, atol=1e-6, err_msg=f)

    def test_ten_steps(self, train_run):
        d, count, _, steps = train_run
        losses = np.array([float(m["loss"]) for _, m in steps])
        np.testing.assert_allclose(losses, d["losses"], rtol=1e-4)
        assert losses[-1] < losses[0]
        np.testing.assert_array_equal([int(m["n_visible"]) for _, m in steps], d["n_visible"])
        assert all(int(m["overflow"]) == 0 for _, m in steps)
        gm = steps[-1][0]
        for f in MAP_FIELDS:
            diff = np.abs(n(getattr(gm, f))[:count] - d[f"final_{f}"])
            assert np.mean(diff <= 1e-4) >= 0.8, f
            assert np.median(diff) <= 1e-5, f
            assert diff.max() <= PARAM_MAX_GAP[f], f


class TestExposureAndErank:
    def test_exposure_step(self):
        """apply_exposure: the loss and the dense-Adam exposure update match
        JAX's, given the port's render before exposure (rtol 1e-5: the same
        float32 formulas; the exposure gradient sums all pixels)."""
        d = load_golden("train", "file")
        intr, cfg, _, gm, kf, opt = initial_state(d)
        cfg = cfg.replace(apply_exposure=True)
        e0 = np.array([[0.9, 0.05, 0.0, 0.02], [0.0, 1.0, 0.0, -0.01],
                       [0.02, 0.0, 1.1, 0.0]], np.float32)
        gm = gm.replace(exposure=torch.tensor(e0))
        opt["exposure"] = AdamState.zeros_like(gm.exposure)
        gm1, _, m = train_step(gm, opt, kf, 1, 1, intr=intr, cfg=cfg)
        with torch.no_grad():
            img = n(render_map(gm, kf.camera(intr, 1), **_render_kw(cfg, gm.capacity)).image)
        gt = n(kf.images[1]).astype(np.float32) / 255.0

        def jloss(e):
            flat = jnp.asarray(img).reshape(3, -1)
            out = (e[:, :3] @ flat + e[:, 3:]).reshape(img.shape)
            return jl.training_loss(out, jnp.asarray(gt), cfg.lambda_dssim)

        jv, jgrad = jax.value_and_grad(jloss)(jnp.asarray(e0))
        z = jnp.zeros_like(jgrad)
        e1, _ = jadam.dense_adam_update(jnp.asarray(e0), jgrad, jadam.AdamState(z, z),
                                        lr=cfg.exposure_lr, step_count=jnp.asarray(1))
        assert float(m["loss"]) == pytest.approx(float(jv), rel=1e-5)
        np.testing.assert_allclose(n(gm1.exposure), np.asarray(e1), rtol=1e-5, atol=1e-7)

    def test_erank_gradient_matches_jax(self):
        """lambda_erank > 0: the log-scale gradient of the step minus that of
        the lambda = 0 step equals JAX's erank VJP chained through exp, within
        1e-6 of its largest entry. The step takes K6's log-scale gradient (exp
        folded into the preprocess) and autograd's of the erank term through
        its own exp, summed; JAX chains the sum of the two scale gradients
        through one exp. Scales are drawn away from the gate's lower edge,
        where float32 log/exp differences are magnified
        (tests/test_torch_erank.py)."""
        d = load_golden("train", "file")
        intr, cfg, count, gm, kf, opt = initial_state(d)
        rng = np.random.default_rng(5)
        s = np.exp(rng.uniform(-4.0, 1.0, (8 * count, 3))).astype(np.float32)
        s64 = s.astype(np.float64)
        q = s64 / (s64 * s64).sum(1, keepdims=True)
        arg = np.exp(-(q * np.log(q)).sum(1)) - 1.0 + 1e-5
        s = s[(arg < -5e-4) | (arg > 0.25)][:count]
        assert len(s) == count and ((arg > 0.25) & (arg < 1.0)).sum() > 0
        log_scale = n(gm.log_scale).copy()
        log_scale[:count] = np.log(s)
        gm = gm.replace(log_scale=torch.tensor(log_scale))
        lam = 0.1
        grads = [train_step(gm, opt, kf, 0, 1, intr=intr, with_grads=True,
                            cfg=cfg.replace(lambda_erank=v))[2]["grads"]["log_scale"]
                 for v in (0.0, lam)]
        scale = np.exp(log_scale)
        _, pull = jax.vjp(lambda x: jerank.erank_regularizer(x, lam), jnp.asarray(scale))
        want = np.asarray(pull(jnp.float32(1.0))[0]) * scale
        assert rel_max(n(grads[1] - grads[0]), want) <= 1e-6
        assert np.abs(want[:count, :2]).max() > 0     # the gate is open somewhere


    @pytest.mark.parametrize("lam", [0.0, 0.1])
    def test_stored_parameter_gradients_match_jax(self, lam):
        """The step's gradients with respect to the stored parameters
        (log_scale, quat and opa_logit among them: the activations are
        folded into the preprocess) against JAX's first step, at lambda_erank
        0 and > 0, within the first step's 1e-4 of each group's max. JAX's
        gradient at lambda > 0 is its lambda = 0 gradient plus its erank VJP
        chained through exp (the term is linear in the cotangent)."""
        d = load_golden("train", "file")
        intr, cfg, count, gm, kf, opt = initial_state(d)
        grads = train_step(gm, opt, kf, int(d["idxs"][0]), 1, intr=intr, with_grads=True,
                           cfg=cfg.replace(lambda_erank=lam))[2]["grads"]
        want = {g: d[f"grad1_{g}"] for g in PARAM_GROUPS}
        if lam > 0:
            scale = np.exp(n(gm.log_scale)[:count])
            _, pull = jax.vjp(lambda x: jerank.erank_regularizer(x, lam), jnp.asarray(scale))
            want["log_scale"] = want["log_scale"] + np.asarray(pull(jnp.float32(1.0))[0]) * scale
        for g in PARAM_GROUPS:
            assert rel_max(n(grads[g])[:count], want[g]) < 1e-4, g
        assert n(grads["opacity"])[:count].any() and n(grads["log_scale"])[:count].any()


class TestEngine:
    def test_three_keyframes(self, engine_golden):
        d = engine_golden
        _, cfg = small_rig()
        eng = MappingEngine(cfg, device="cpu")
        eng.rng = golden_tool()._RecordingRng(eng.rng)   # the same recorder as the goldens'
        counts, losses = [], []
        for fr in frames_from(d):
            if eng.add_frame(fr):
                counts.append(int(eng.gm.count))
                losses.append(eng.last_metrics["loss"])
        assert eng.kf_count == 3 and len(eng.test_cameras) == 3
        np.testing.assert_array_equal(np.concatenate(eng.rng.lists), d["opt_lists"])
        np.testing.assert_array_equal([len(x) for x in eng.rng.lists], d["opt_list_lens"])
        np.testing.assert_array_equal(counts, d["counts"])
        np.testing.assert_allclose(losses, d["losses"], rtol=1e-4)
        assert eng.last_metrics["overflow"] == 0.0

    def test_not_ported_entry_points_raise(self):
        """finalize and measure_phase_split on an engine that has seen no
        keyframe return empty results, as the JAX engine's do."""
        _, cfg = small_rig()
        eng = MappingEngine(cfg, device="cpu")
        assert eng.finalize() == {}
        assert eng.measure_phase_split() == {}

    def test_defaults_to_the_card(self, monkeypatch):
        """Without CUDA the default device raises and names device="cpu";
        with device="cpu" the engine runs on the CPU."""
        _, cfg = small_rig()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            MappingEngine(cfg)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            MappingEngine(cfg, device="cuda:0")
        assert MappingEngine(cfg, device="cpu").device == torch.device("cpu")
