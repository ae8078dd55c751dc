"""Port parity: AlexNet-LPIPS (ops/lpips.py) against the JAX package's
`lpips_distance`, for the randinit and random_lpips_params weights, and the
three weight loaders (.npz, torch state_dict .pth, torchscript .pt) reading
the same files in both packages.

Tolerances: loaded parameters exact; distances within 1e-5 relative (five
float32 convolutions whose sums XLA and oneDNN order differently).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from gaussian_lic_tpu.ops import lpips as jl
from gaussian_lic_tpu_torch import interop
from gaussian_lic_tpu_torch.engine import evaluate
from gaussian_lic_tpu_torch.ops import lpips as tl


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def jax_distance(params, a, b):
    return np.asarray(jl.lpips_distance({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(a), jnp.asarray(b)))


def port_distance(params, a, b):
    return n(tl.LPIPS(params)(t(a), t(b)))


def assert_params_equal(tp, jp):
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(n(tp[k]), np.asarray(jp[k]), err_msg=k)


class _Alex(torch.nn.Module):
    """A torch export of the LPIPS weights, named as torchvision's AlexNet
    `features` and lpips' lin heads."""

    def __init__(self, params):
        super().__init__()
        self.features = torch.nn.ModuleDict()
        for i, idx in enumerate((0, 3, 6, 8, 10)):
            w = torch.tensor(np.asarray(params[f"conv{i}_w"]))
            conv = torch.nn.Conv2d(w.shape[1], w.shape[0], w.shape[2])
            conv.weight.data, conv.bias.data = w, torch.tensor(np.asarray(params[f"conv{i}_b"]))
            self.features[str(idx)] = conv
        self.lins = torch.nn.ModuleList()
        for i in range(5):
            w = torch.tensor(np.asarray(params[f"lin{i}_w"]))
            lin = torch.nn.Conv2d(w.shape[1], 1, 1, bias=False)
            lin.weight.data = w
            self.lins.append(lin)

    def forward(self, x):
        return x


def write_artifact(path, params):
    if path.endswith(".npz"):
        np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    elif path.endswith(".pth"):
        torch.save(_Alex(params).state_dict(), path)
    else:
        torch.jit.save(torch.jit.script(_Alex(params)), path)


class TestLpips:
    @pytest.mark.parametrize("kind", ["randinit", "random"])
    def test_distance(self, images, kind):
        tp = tl.randinit_lpips_params(0) if kind == "randinit" else tl.random_lpips_params(3)
        jp = jl.randinit_lpips_params(0) if kind == "randinit" else jl.random_lpips_params(3)
        assert_params_equal(tp, jp)
        a, b = images
        got, want = port_distance(tp, a, b), jax_distance(jp, a, b)
        assert got.shape == (2,) and np.all(got > 0)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(port_distance(tp, a, a), 0.0, atol=1e-7)

    @pytest.mark.parametrize("suffix", [".npz", ".pth", ".pt"])
    def test_loaders(self, tmp_path, images, suffix):
        src = {k: np.asarray(v) for k, v in jl.random_lpips_params(4).items()}
        path = str(tmp_path / f"lpips_alex{suffix}")
        write_artifact(path, src)
        tp, jp = tl.load_lpips_params(path), jl.load_lpips_params(path)
        assert_params_equal(tp, jp)
        assert_params_equal(tp, src)
        a, b = images
        np.testing.assert_allclose(port_distance(tp, a, b), jax_distance(jp, a, b), rtol=1e-5)
        # a directory holding the artifact
        assert_params_equal(tl.load_lpips_params(str(tmp_path)), src)

    def test_randinit_sentinel(self, capsys):
        assert_params_equal(tl.load_lpips_params("randinit:2"), jl.randinit_lpips_params(2))
        assert "RANDOM-INIT" in capsys.readouterr().out

    def test_interop_from_jax_params(self, images):
        jp = jl.randinit_lpips_params(1)
        net = interop.lpips_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
        a, b = images
        np.testing.assert_allclose(n(net(t(a), t(b))), jax_distance(jp, a, b), rtol=1e-5)

    def test_missing_artifact_reports_none(self, tmp_path, capsys):
        assert evaluate._lpips_or_none(str(tmp_path / "nothing"), "cpu") is None
        assert "LPIPS unavailable" in capsys.readouterr().out
        assert evaluate._lpips_or_none(None, "cpu") is None
        assert "LPIPS skipped" in capsys.readouterr().out
        os.makedirs(tmp_path / "empty")
        with pytest.raises(FileNotFoundError):
            tl.load_lpips_params(str(tmp_path / "empty"))
