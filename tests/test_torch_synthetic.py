"""Port parity: the synthetic sequences (`utils/synthetic.py`) and the
`--demo` frames (`run._demo_frames`) against the JAX package's, on the same
seeds at the default 128x64 rig.

Worlds of at most 2048 points render their GT images through the dense
oracle in both packages. Tolerance: the uint8 images within 1 LSB on at most
0.1% of their values (float32 exp and summation order differ in the last
ulp, which can flip a rounding); rotations, LiDAR points and colours
exactly; the camera centre within 1 float32 ulp of its largest coordinate
(it is -R^T (-R t) in both packages: XLA contracts each 3-term dot with
fused multiply-adds, PyTorch rounds each product; measured 3.7e-9 against
an ulp of 4.8e-7 at 6.0).
Before the port rendered small worlds through its tiled rasterizer, the
400-point world differed by up to 5 LSB on 38-51 values a frame.
"""

import numpy as np
import pytest

from gaussian_lic_tpu import config as jconfig
from gaussian_lic_tpu import run as jrun
from gaussian_lic_tpu.utils import synthetic as jsyn
from gaussian_lic_tpu_torch import config as tconfig
from gaussian_lic_tpu_torch import run as trun
from gaussian_lic_tpu_torch.utils import synthetic as tsyn

MAX_LSB = 1
MAX_SHARE = 1e-3
POSE_ULP = 1


def assert_frames_match(tf, jf):
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        assert a.image.dtype == b.image.dtype == np.uint8 and a.image.shape == b.image.shape
        d = np.abs(a.image.astype(np.int32) - b.image.astype(np.int32))
        assert d.max() <= MAX_LSB and np.mean(d > 0) <= MAX_SHARE, (d.max(), int((d > 0).sum()))
        assert a.timestamp == b.timestamp
        for f in ("R_wc", "points", "colors"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                          err_msg=f)
        ta, tb = np.asarray(a.t_wc), np.asarray(b.t_wc)
        assert np.abs(ta - tb).max() <= POSE_ULP * np.spacing(np.abs(tb).max()), (ta, tb)


@pytest.mark.parametrize("n_points", [400, 600])
def test_make_sequence_matches_jax(n_points):
    tf = tsyn.make_sequence(tsyn.make_world(np.random.default_rng(0), n_points=n_points),
                            n_frames=4, rng=np.random.default_rng(0))
    jf = jsyn.make_sequence(jsyn.make_world(np.random.default_rng(0), n_points=n_points),
                            n_frames=4, rng=np.random.default_rng(0))
    assert_frames_match(tf, jf)


def test_demo_frames_match_jax():
    rig = dict(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0)
    assert_frames_match(trun._demo_frames(tconfig.Params(**rig), n_frames=5),
                        jrun._demo_frames(jconfig.Params(**rig), n_frames=5))


def test_large_worlds_render_tiled(monkeypatch):
    """Above DENSE_GT_MAX points the GT goes through the tiled rasterizer (the
    oracle is O(points x pixels)), at or below it through the oracle."""
    from gaussian_lic_tpu_torch.ops import rasterize, rasterize_ref

    called = []
    for mod, name in ((rasterize, "render_tiled"), (rasterize_ref, "render_dense")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: called.append(_n)
                            or _r(*a, **k))
    for n_points in (tsyn.DENSE_GT_MAX, tsyn.DENSE_GT_MAX + 1):
        world = tsyn.make_world(np.random.default_rng(1), n_points=n_points)
        img = world.render_gt(world.gt_camera(0.0))
        assert img.shape == (3, 64, 128) and 0.0 <= img.min() and img.max() <= 1.0
    assert called == ["render_dense", "render_tiled"]
