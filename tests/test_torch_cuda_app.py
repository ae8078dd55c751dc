"""The application's device code on the card against the same code on the
CPU: the skybox's kNN, the erank gradient and LPIPS. Each test needs a CUDA
device and skips without one; on the machine with the card run

    GLIC_TEST_TPU=1 python -m pytest tests/test_torch_cuda_app.py -m requires_cuda -q

(GLIC_TEST_TPU=1 keeps tests/conftest.py from importing JAX, which that
machine does not have; this file imports no JAX).

Tolerances: kNN and erank within 1e-6 relative; LPIPS within 1e-5 relative
with TF32 allowed for cuDNN outside the module, which must switch it off
for its convolutions (a TF32 convolution drifts by ~1e-3).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device, n, rel_max  # noqa: F401  (fixture)

from gaussian_lic_tpu_torch.ops import erank, knn, lpips
from gaussian_lic_tpu_torch.models import gaussians

pytestmark = pytest.mark.requires_cuda


def test_skybox_on_the_card(cuda_device):
    cpu = gaussians.make_skybox(100000, 1000.0, seed=0)
    card = gaussians.make_skybox(100000, 1000.0, seed=0, device=cuda_device)
    for name, a, b in zip(("xyz", "dc", "log_scale", "quat", "opa"), card, cpu):
        assert a.device.type == "cuda"
        assert rel_max(n(a), n(b)) <= 1e-6, name
    np.testing.assert_allclose(n(knn.mean_knn_dist2(card[0])), n(knn.mean_knn_dist2(cpu[0])),
                               rtol=1e-6)


def test_erank_on_the_card(cuda_device):
    s = np.exp(np.random.default_rng(2).uniform(-4.0, 1.0, (4096, 3))).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        x = torch.tensor(s, device=dev, requires_grad=True)
        erank.erank_regularizer(x, 0.7).backward()
        grads.append(n(x.grad))
    assert rel_max(grads[1], grads[0]) <= 1e-6


def test_lpips_convolutions_skip_tf32(cuda_device):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (1, 3, 512, 640)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    params = lpips.randinit_lpips_params(0)
    want = n(lpips.LPIPS(params)(torch.tensor(a), torch.tensor(b)))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        net = lpips.LPIPS(params, device=cuda_device)
        got = n(net(torch.tensor(a, device=cuda_device), torch.tensor(b, device=cuda_device)))
        assert torch.backends.cudnn.allow_tf32   # restored after the module's convolutions
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    np.testing.assert_allclose(got, want, rtol=1e-5)
