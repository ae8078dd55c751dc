"""Port parity: the train-step benchmark state.

`utils.synthetic.make_bench_state` (the port's recipe, which the 1M-Gaussian
train steps and the blend probes run on) against the JAX package's
`bench.build_bench_state`, at 4,096 Gaussians and 2 keyframes, from the same
numpy seed. Map fields and keyframe images exact where both sides copy numpy
draws; within 1e-6 where each package computes a float (the SH DC term, the
log scales, the camera matrices); the fastlivo preset sized as bench.py
sizes it.
"""

import importlib.util
import os

import numpy as np
import pytest

from torch_port_helpers import ROOT, n

from gaussian_lic_tpu.camera import Intrinsics as JIntrinsics
from gaussian_lic_tpu.config import load_params as jload_params
from gaussian_lic_tpu_torch.config import load_params
from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

N_GAUSS = 4096
N_KF = 2
FLOAT_ATOL = 1e-6

EXACT_MAP = ("xyz", "quat", "opa_logit", "count", "exposure", "sh_rest")
FLOAT_MAP = ("dc", "log_scale")
CAMERA = ("R_cw", "t_cw", "full_proj")


def jax_bench():
    """bench.py, loaded from the repo root."""
    spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def states():
    kw = dict(preset="fastlivo", initial_capacity=N_GAUSS, skybox_points_num=0)
    jcfg = jload_params(**kw)
    jintr = JIntrinsics(width=jcfg.width, height=jcfg.height, fx=jcfg.fx, fy=jcfg.fy,
                        cx=jcfg.cx, cy=jcfg.cy)
    jgm, jkf = jax_bench().build_bench_state(N_GAUSS, jcfg, jintr, n_kf=N_KF)
    intr, gm, kf, opt = make_bench_state(load_params(**kw), N_GAUSS, "cpu", n_kf=N_KF)
    return (jintr, jgm, jkf), (intr, gm, kf, opt)


def test_rig_and_capacity(states):
    (jintr, jgm, _), (intr, gm, _, _) = states
    fields = ("width", "height", "fx", "fy", "cx", "cy", "znear", "zfar")
    assert [getattr(intr, f) for f in fields] == [getattr(jintr, f) for f in fields]
    assert gm.capacity == jgm.capacity == N_GAUSS
    assert gm.sh_degree == jgm.sh_degree and gm.skybox_count == jgm.skybox_count == 0


@pytest.mark.parametrize("field", EXACT_MAP)
def test_map_fields_exact(states, field):
    (_, jgm, _), (_, gm, _, _) = states
    np.testing.assert_array_equal(n(getattr(gm, field)), n(getattr(jgm, field)))


@pytest.mark.parametrize("field", FLOAT_MAP)
def test_map_fields_float(states, field):
    (_, jgm, _), (_, gm, _, _) = states
    np.testing.assert_allclose(n(getattr(gm, field)), n(getattr(jgm, field)),
                               atol=FLOAT_ATOL, rtol=0)


def test_keyframe_images_exact(states):
    (_, _, jkf), (_, _, kf, _) = states
    np.testing.assert_array_equal(n(kf.images), n(jkf.images))
    assert int(n(kf.images).max()) > 0


@pytest.mark.parametrize("field", CAMERA)
def test_cameras(states, field):
    (_, _, jkf), (_, _, kf, _) = states
    np.testing.assert_allclose(n(getattr(kf, field)), n(getattr(jkf, field)),
                               atol=FLOAT_ATOL, rtol=FLOAT_ATOL)


def test_adam_moments_zero(states):
    _, (_, gm, _, opt) = states
    assert set(opt) == set(gm.trainable())
    for k, st in opt.items():
        assert st.exp_avg.shape == getattr(gm, k).shape, k
        assert float(st.exp_avg.abs().max()) == 0.0 == float(st.exp_avg_sq.abs().max()), k
