"""Port parity: PLY export/import (io/ply.py), checkpoints (io/checkpoint.py),
the native runtime's build (native/), and the eval dumps' PNG encoder,
against the JAX package (and PIL for the PNGs).

Tolerances: PLY bytes exact (the JAX writer with use_native=False against
the port's Python and native writers); checkpoint arrays and dtypes exact,
both ways; PNG pixels exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ROOT, n, t

from gaussian_lic_tpu.io import checkpoint as jckpt
from gaussian_lic_tpu.io import ply as jply
from gaussian_lic_tpu.models.gaussians import GaussianMap as JMap
from gaussian_lic_tpu.ops.adam import AdamState as JAdam
from gaussian_lic_tpu_torch import interop, native
from gaussian_lic_tpu_torch.engine.evaluate import png_bytes
from gaussian_lic_tpu_torch.io import checkpoint as tckpt
from gaussian_lic_tpu_torch.io import ply as tply
from gaussian_lic_tpu_torch.ops.adam import AdamState

PLY_KEYS = ("xyz", "dc", "sh_rest", "opa_logit", "log_scale", "quat")
MAP_FIELDS = ("xyz", "dc", "sh_rest", "log_scale", "quat", "opa_logit", "count", "exposure")


def ply_arrays(rng, num=200, S=15):
    return dict(
        xyz=rng.normal(size=(num, 3)).astype(np.float32),
        dc=rng.normal(size=(num, 3)).astype(np.float32),
        sh_rest=rng.normal(size=(num, S, 3)).astype(np.float32),
        opa_logit=rng.normal(size=(num,)).astype(np.float32),
        log_scale=rng.normal(size=(num, 3)).astype(np.float32),
        quat=rng.normal(size=(num, 4)).astype(np.float32),
    )


def map_arrays(rng, capacity=96, count=70, S=15):
    a = ply_arrays(rng, capacity, S)
    a["count"] = np.int32(count)
    a["exposure"] = rng.normal(size=(3, 4)).astype(np.float32)
    return a


class TestPly:
    @pytest.mark.parametrize("skybox", [0, 17])
    @pytest.mark.parametrize("use_native", [False, True])
    def test_bytes_equal_jax(self, tmp_path, rng, skybox, use_native):
        if use_native:
            assert native.available()
        arrs = ply_arrays(rng)
        jax_path, port_path = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
        jply.save_ply(jax_path, **arrs, skybox_count=skybox, use_native=False)
        tply.save_ply(port_path, **arrs, skybox_count=skybox, use_native=use_native)
        with open(jax_path, "rb") as f, open(port_path, "rb") as g:
            assert f.read() == g.read()
        back, jback = tply.load_ply(port_path), jply.load_ply(port_path)
        for k in PLY_KEYS:
            np.testing.assert_array_equal(back[k], arrs[k][skybox:], err_msg=k)
            np.testing.assert_array_equal(back[k], jback[k], err_msg=k)

    def test_save_map_ply_leaves_out_the_skybox(self, tmp_path, rng):
        a = map_arrays(rng)
        tm = interop.gaussian_map_from_numpy(a, sh_degree=3, skybox_count=20, device="cpu")
        jm = JMap(**{k: jnp.asarray(a[k]) for k in MAP_FIELDS}, sh_degree=3, skybox_count=20)
        tply.save_map_ply(str(tmp_path / "port.ply"), tm)
        jply.save_map_ply(str(tmp_path / "jax.ply"), jm)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
        assert tply.load_ply(str(tmp_path / "port.ply"))["xyz"].shape == (50, 3)

    def test_rejects_other_formats(self, tmp_path):
        p = tmp_path / "a.ply"
        p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 0\nend_header\n")
        with pytest.raises(ValueError):
            tply.load_ply(str(p))


class TestNative:
    def test_builds_into_the_port_build_dir(self):
        lib = native.get_lib()
        assert lib is not None
        assert os.path.dirname(lib._name) == os.path.join(ROOT, "gaussian_lic_tpu_torch", "build")

    def test_disable_switch(self, monkeypatch):
        monkeypatch.setenv("GLIC_DISABLE_NATIVE", "1")
        assert native.get_lib() is None and not native.available()


def port_state(rng):
    a = map_arrays(rng)
    gm = interop.gaussian_map_from_numpy(a, sh_degree=3, skybox_count=11, device="cpu")
    opt = {k: AdamState(t(rng.normal(size=v.shape).astype(np.float32)),
                        t(rng.uniform(size=v.shape).astype(np.float32)))
           for k, v in gm.trainable().items()}
    return gm, opt


class TestCheckpoint:
    def test_port_written_jax_loads(self, tmp_path, rng):
        gm, opt = port_state(rng)
        path = str(tmp_path / "port.npz")
        tckpt.save_checkpoint(path, gm, opt, extra={"kf_count": 7})
        jm, jopt, extra = jckpt.load_checkpoint(path)
        assert (jm.sh_degree, jm.skybox_count, int(extra["kf_count"])) == (3, 11, 7)
        for f in MAP_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jm, f)), n(getattr(gm, f)), err_msg=f)
        assert sorted(jopt) == sorted(opt)
        for k in opt:
            np.testing.assert_array_equal(np.asarray(jopt[k].exp_avg), n(opt[k].exp_avg))
            np.testing.assert_array_equal(np.asarray(jopt[k].exp_avg_sq), n(opt[k].exp_avg_sq))

    def test_jax_written_port_loads(self, tmp_path, rng):
        a = map_arrays(rng)
        jm = JMap(**{k: jnp.asarray(a[k]) for k in MAP_FIELDS}, sh_degree=3, skybox_count=5)
        jopt = {"xyz": JAdam(jnp.asarray(a["xyz"]) * 2, jnp.asarray(a["xyz"]) ** 2)}
        path = str(tmp_path / "jax.npz")
        jckpt.save_checkpoint(path, jm, jopt, extra={"kf_count": 3})
        gm, opt, extra = tckpt.load_checkpoint(path)
        assert (gm.sh_degree, gm.skybox_count, int(extra["kf_count"])) == (3, 5, 3)
        assert gm.count.dtype == torch.int32
        for f in MAP_FIELDS:
            np.testing.assert_array_equal(n(getattr(gm, f)), np.asarray(getattr(jm, f)), err_msg=f)
        np.testing.assert_array_equal(n(opt["xyz"].exp_avg), np.asarray(jopt["xyz"].exp_avg))
        np.testing.assert_array_equal(n(opt["xyz"].exp_avg_sq), np.asarray(jopt["xyz"].exp_avg_sq))

    def test_same_keys_and_dtypes_as_jax(self, tmp_path, rng):
        gm, opt = port_state(rng)
        tckpt.save_checkpoint(str(tmp_path / "p.npz"), gm, opt, extra={"kf_count": 2})
        jm = JMap(**{f: jnp.asarray(n(getattr(gm, f))) for f in MAP_FIELDS}, sh_degree=3,
                  skybox_count=11)
        jopt = {k: JAdam(jnp.asarray(n(v.exp_avg)), jnp.asarray(n(v.exp_avg_sq)))
                for k, v in opt.items()}
        jckpt.save_checkpoint(str(tmp_path / "j.npz"), jm, jopt, extra={"kf_count": 2})
        with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
            assert sorted(p.files) == sorted(j.files)
            for k in j.files:
                assert p[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)

    def test_version_check(self, tmp_path, rng):
        gm, _ = port_state(rng)
        path = str(tmp_path / "c.npz")
        tckpt.save_checkpoint(path, gm)
        with np.load(path) as z:
            d = dict(z)
        d["format_version"] = np.asarray(2)
        np.savez(path, **d)
        with pytest.raises(ValueError):
            tckpt.load_checkpoint(path)

    def test_map_only_round_trip(self, tmp_path, rng):
        gm, _ = port_state(rng)
        path = str(tmp_path / "c.npz")
        tckpt.save_checkpoint(path, gm)
        back, opt, extra = tckpt.load_checkpoint(path)
        assert opt is None and extra == {}
        for f in MAP_FIELDS:
            assert torch.equal(getattr(back, f), getattr(gm, f)), f


class TestPng:
    @pytest.mark.parametrize("hw", [(1, 1), (7, 13), (64, 128)])
    def test_against_pil(self, tmp_path, rng, hw):
        from PIL import Image

        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        path = tmp_path / "a.png"
        path.write_bytes(png_bytes(img))
        with Image.open(path) as im:
            assert im.mode == "RGB" and im.size == (hw[1], hw[0])
            np.testing.assert_array_equal(np.asarray(im), img)
        Image.fromarray(img).save(tmp_path / "pil.png")
        with Image.open(tmp_path / "pil.png") as im:
            np.testing.assert_array_equal(np.asarray(im), img)
