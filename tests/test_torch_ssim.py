"""The training loss's kernels K11 (`ssim_forward`) and K12 (`ssim_backward`)
of ops/losses.py, and the autograd Function `SSIMLoss` that joins them.

CPU: against the plain chains and the JAX package (`gaussian_lic_tpu.ops.
losses`, `jax.grad` for the gradients), at 3x24x40, 3x37x53, 3x1x40 (a
1-row image), 3x7x9 (every tap reaches the padding) and bands with their
halo rows at D = 2 and 4. Inputs are made with numpy from a seed.
  * `SSIMLoss`'s CPU path (through `training_loss`, `training_loss_band_part`
    and `ssim`) gives the plain chains' value and autograd gradient bit for
    bit.
  * `ssim_backward_plain`, K12's closed form over the partial maps of
    `ssim_forward_plain`, is within GRAD_RTOL of `jax.grad` of
    `training_loss` and of `training_loss_band_part` (halo rows included) at
    lambda = 0, 0.2 and 1. Found on these inputs: at most 2.5e-6 of the
    gradient's max against float32 autograd, 2.0e-6 against float64
    autograd, as float32 autograd itself.
  * The partial maps are the map's derivatives by mu1 (blur(x^2), blur(xy)
    held), sigma1^2 and sigma12: float64 autograd of the map's formula.
  * `ssim`, `training_loss` and `training_loss_band_part` still match JAX's
    values; a meta tensor raises; the module imports no JAX.

CPU, K11's and K12's geometry: each variant's tile in ops/losses.py is the
kernel's, and its launch grid; the variants on CPU tensors.

Card (`requires_cuda`): K11's sums and partial maps and K12's gradient
against their plain versions on the card (the partial maps and the
gradient bit for bit, the sums within SUM_RTOL), at the CPU tests' shapes,
bands and a strided view; the loss and gradient through `SSIMLoss` against
autograd of the plain chain; a gt that needs a gradient raises; a train
loss and its backward captured in a CUDA graph and replayed on new inputs.
K11's tile: tiles cut by the image's edges (W not a multiple of 4, C = 1,
W below a tile), windows that start and end inside a tile, the sums of two
eager runs and of graph replays bit for bit, every variant that claims
K11's outputs against the plain version; K12 against its plain version,
every K12 variant that claims K12's d at 3x512x640, (1, 33, 65), (1, 5,
12) and bands 0 and 7 of D = 8, and K12 in a CUDA graph replayed twice.

JAX is imported inside the tests that use it, so the card tests collect on
a machine without it.
"""

import ast
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import ROOT, cuda_device, n, rel_max, t  # noqa: F401

from gaussian_lic_tpu_torch.ops import losses as tl

SHAPES = [(3, 24, 40), (3, 37, 53), (3, 1, 40), (3, 7, 9)]
LAMBDAS = [0.0, 0.2, 1.0]
BANDS = [(2, b) for b in range(2)] + [(4, b) for b in range(4)]
BAND_IMAGE = (3, 48, 40)
GRAD_RTOL = 1e-5     # a gradient against another, of the gradient's max
VALUE_RTOL = 1e-5    # losses against JAX's (the sums reduce in another order)
SUM_RTOL = 1e-6      # K11's sums against the plain chain's, on the card


def images(shape, seed=0):
    """A uniform image and a smooth-ish target, where SSIM's
    blur(x^2) - mu^2 cancels (numpy float32)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a * 0.7 + 0.2 + rng.normal(size=shape).astype(np.float32) * 0.02, 0, 1)
    return a, b.astype(np.float32)


def band_ext(img, D, b):
    """Band b of D of `img` (numpy) with HALO rows each side, zeros past the
    image's edges: what the sharded step hands the band loss."""
    h, hb = tl.HALO, img.shape[1] // D
    pad = np.pad(img, ((0, 0), (h, h), (0, 0)))
    return np.ascontiguousarray(pad[:, b * hb:(b + 1) * hb + 2 * h])


def value_and_grad(fn, a, b, *args):
    """fn's value and its gradient by `a` (numpy arrays or tensors)."""
    a, b = (v if isinstance(v, torch.Tensor) else t(v) for v in (a, b))
    x = a.detach().clone().requires_grad_()
    v = fn(x, b, *args)
    (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


def jax_value_and_grad(name, a, b, *args):
    import jax
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops import losses as jl

    v, g = jax.value_and_grad(getattr(jl, name))(jnp.asarray(a), jnp.asarray(b), *args)
    return float(v), np.asarray(g)


def window_grad(npix, lam):
    """The gradients of `SSIMLoss`'s two sums in the loss of npix pixels."""
    return torch.tensor([-lam / npix, (1.0 - lam) / npix])


# ---------------------------------------------------------------------------
# CPU: SSIMLoss is the plain chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", LAMBDAS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cpu_training_loss_is_the_plain_chain(shape, lam):
    a, b = images(shape)
    got = value_and_grad(tl.training_loss, a, b, lam)
    want = value_and_grad(tl.training_loss_plain, a, b, lam)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cpu_ssim_is_the_plain_chain(shape):
    a, b = images(shape, seed=1)
    got, want = value_and_grad(tl.ssim, a, b), value_and_grad(tl.ssim_plain, a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with torch.no_grad():   # no gradient: the sums without the Function
        assert torch.equal(tl.ssim(t(a), t(b)), want[0])
        assert torch.equal(tl.training_loss(t(a), t(b)), tl.training_loss_plain(t(a), t(b)))


@pytest.mark.parametrize("lam", LAMBDAS)
@pytest.mark.parametrize("D,b", BANDS)
def test_cpu_band_part_is_the_plain_chain(D, b, lam):
    a, g = images(BAND_IMAGE, seed=2)
    ea, eg = band_ext(a, D, b), band_ext(g, D, b)
    got = value_and_grad(tl.training_loss_band_part, ea, eg, a.size, lam)
    want = value_and_grad(tl.training_loss_band_part_plain, ea, eg, a.size, lam)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_gt_gradient_is_autograds():
    """On the CPU a gt that needs a gradient gets autograd's."""
    a, b = images((3, 24, 40), seed=3)
    x, y = t(a).requires_grad_(), t(b).requires_grad_()
    got = torch.autograd.grad(tl.training_loss(x, y), (x, y))
    want = torch.autograd.grad(tl.training_loss_plain(x, y), (x, y))
    assert all(torch.equal(p, q) for p, q in zip(got, want))


def test_plain_versions_launch_nothing():
    a, b = images((3, 24, 40))
    before = dict(tl.LAUNCHES)
    value_and_grad(tl.training_loss, a, b)
    sums, maps = tl.ssim_forward(t(a), t(b))
    tl.ssim_backward(t(a), t(b), maps, torch.tensor([-1e-4, 1e-4]))
    assert tl.LAUNCHES == before


# ---------------------------------------------------------------------------
# CPU: K11's and K12's plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", LAMBDAS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_plain_against_jax(shape, lam):
    a, b = images(shape, seed=4)
    sums, maps = tl.ssim_forward_plain(t(a), t(b))
    d = tl.ssim_backward_plain(t(a), t(b), maps, window_grad(a.size, lam))
    _, jg = jax_value_and_grad("training_loss", a, b, lam)
    assert rel_max(n(d), jg) < GRAD_RTOL
    # and against autograd of the plain chain, float32 and float64
    _, g32 = value_and_grad(tl.training_loss_plain, a, b, lam)
    x64 = t(a).double().requires_grad_()
    (g64,) = torch.autograd.grad(tl.training_loss_plain(x64, t(b).double(), lam), x64)
    assert rel_max(n(d), n(g32)) < GRAD_RTOL and rel_max(n(d), n(g64)) < GRAD_RTOL


@pytest.mark.parametrize("lam", LAMBDAS)
@pytest.mark.parametrize("D,b", BANDS)
def test_backward_plain_band_against_jax(D, b, lam):
    """The band's window is its rows without the halo; the gradient covers
    the halo rows too."""
    a, g = images(BAND_IMAGE, seed=5)
    ea, eg = band_ext(a, D, b), band_ext(g, D, b)
    hb = ea.shape[1] - 2 * tl.HALO
    r0, r1 = tl.HALO, tl.HALO + hb
    sums, maps = tl.ssim_forward_plain(t(ea), t(eg), r0, r1)
    assert maps.shape == (3, 3, hb, ea.shape[2])
    d = tl.ssim_backward_plain(t(ea), t(eg), maps, window_grad(a.size, lam), r0, r1)
    _, jg = jax_value_and_grad("training_loss_band_part", ea, eg, a.size, lam)
    assert rel_max(n(d), jg) < GRAD_RTOL
    if lam > 0 and b > 0:   # the halo rows above the band carry SSIM's gradient
        assert np.abs(n(d)[:, :tl.HALO]).max() > 0


@pytest.mark.parametrize("shape", SHAPES + [BAND_IMAGE], ids=str)
def test_forward_plain_sums(shape):
    """The window's sums are the plain chain's, whole image and a window."""
    a, b = images(shape, seed=6)
    x, y = t(a), t(b)
    sums, maps = tl.ssim_forward_plain(x, y)
    assert torch.equal(sums[0], tl.ssim_map(x, y).sum())
    assert torch.equal(sums[1], (x - y).abs().sum())
    assert maps.shape == (3,) + shape
    r0, r1 = shape[1] // 3, shape[1] - shape[1] // 4
    sums, maps = tl.ssim_forward_plain(x, y, r0, r1, partials=False)
    assert maps is None
    assert torch.equal(sums[0], tl.ssim_map(x, y)[:, r0:r1].sum())


@pytest.mark.parametrize("shape", [(3, 24, 40), (3, 7, 9)], ids=str)
def test_partial_maps_are_the_maps_derivatives(shape):
    """P1 = dm/dmu1 with blur(x^2) and blur(xy) held (so it carries the
    -2 mu1 dm/dsigma1^2 and -mu2 dm/dsigma12 terms), P2 = dm/dsigma1^2,
    P3 = dm/dsigma12: float64 autograd of the map as a function of mu1,
    blur(x^2) and blur(xy), at the plain chain's values."""
    a, b = images(shape, seed=7)
    x, y = t(a).double(), t(b).double()
    mu1, mu2 = tl._blur(x), tl._blur(y)
    exx, eyy, exy = tl._blur(x * x), tl._blur(y * y), tl._blur(x * y)
    leaves = [v.clone().requires_grad_() for v in (mu1, exx, exy)]
    m1, e11, e12 = leaves
    s1, s2, s12 = e11 - m1 * m1, eyy - mu2 * mu2, e12 - m1 * mu2
    m = ((2 * m1 * mu2 + tl.C1) * (2 * s12 + tl.C2)) / (
        (m1 * m1 + mu2 * mu2 + tl.C1) * (s1 + s2 + tl.C2))
    want = torch.autograd.grad(m.sum(), leaves)
    # dm/dsigma1^2 = dm/dblur(x^2) and dm/dsigma12 = dm/dblur(xy)
    _, maps = tl.ssim_forward_plain(x, y)
    for got, w in zip(maps, want):
        assert rel_max(n(got), n(w)) < 1e-10


# ---------------------------------------------------------------------------
# CPU: values against JAX, device checks, imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", ["ssim", "training_loss"])
def test_values_against_jax(name, shape):
    a, b = images(shape, seed=8)
    jv, jg = jax_value_and_grad(name, a, b)
    v, g = value_and_grad(getattr(tl, name), a, b)
    np.testing.assert_allclose(float(v), jv, rtol=VALUE_RTOL)
    assert rel_max(n(g), jg) < GRAD_RTOL


@pytest.mark.parametrize("D,b", BANDS)
def test_band_values_against_jax(D, b):
    a, g = images(BAND_IMAGE, seed=9)
    ea, eg = band_ext(a, D, b), band_ext(g, D, b)
    jv, jg = jax_value_and_grad("training_loss_band_part", ea, eg, a.size, 0.2)
    v, grad = value_and_grad(tl.training_loss_band_part, ea, eg, a.size, 0.2)
    np.testing.assert_allclose(float(v), jv, rtol=VALUE_RTOL)
    assert rel_max(n(grad), jg) < GRAD_RTOL


@pytest.mark.parametrize("call", ["training_loss", "ssim", "band", "ssim_forward",
                                  "ssim_backward", "function"])
def test_meta_tensor_raises(call):
    x = torch.empty((3, 24, 40), device="meta")
    calls = {
        "training_loss": lambda: tl.training_loss(x, x),
        "ssim": lambda: tl.ssim(x, x),
        "band": lambda: tl.training_loss_band_part(x, x, 3 * 14 * 40),
        "ssim_forward": lambda: tl.ssim_forward(x, x),
        "ssim_backward": lambda: tl.ssim_backward(x, x, x, x),
        "function": lambda: tl.SSIMLoss.apply(x.requires_grad_(), x, 0, 24),
    }
    with pytest.raises(ValueError, match="CPU or CUDA"):
        calls[call]()


@pytest.mark.parametrize("r0,r1", [(5, 5), (-1, 3), (0, 25)])
def test_window_outside_the_image_raises(r0, r1):
    a, b = images((3, 24, 40))
    with pytest.raises(ValueError, match="window rows"):
        tl.ssim_sums(t(a), t(b), r0, r1)


def test_module_imports_no_jax():
    """The card's machine has no JAX: ops/losses.py imports neither it nor
    the JAX package."""
    with open(os.path.join(ROOT, "gaussian_lic_tpu_torch", "ops", "losses.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "gaussian_lic_tpu")]


def test_kernel_constants_are_pytorchs_floats():
    """The taps, C1 and C2 reach the kernels as the float32 values PyTorch
    uses for the Python scalars (the plain chain's)."""
    k = np.frombuffer(bytes(tl._konst()), np.float32)
    assert k.tolist() == [float(np.float32(v)) for v in tl._TAPS + [tl.C1, tl.C2]]
    assert np.array_equal(k[:11], tl._gaussian_window())


def test_k11_grid_is_the_kernels():
    """losses.K11_TILES holds each variant's tile as csrc/ssim_forward.cuh's
    kK11Shapes row of that variant (K11Variant's order), K11_FOLDS the
    variants whose kernel sums its blocks (kFolds), and k11_grid the launch
    grid launch_ssim_forward makes from the tile."""
    import re

    with open(os.path.join(ROOT, "gaussian_lic_tpu_torch", "csrc", "ssim_forward.cuh")) as f:
        src = f.read()
    enum = [int(v) for v in re.findall(r"^  kK11\w+ = (\d+),", src, re.M)]
    assert enum == list(range(len(tl.K11_VARIANTS)))
    rows = re.findall(r"^    \{(\d+), (\d+), (\d+), (\d+), \d+\},\s+// (\w+)$", src, re.M)
    assert [r[4] for r in rows] == list(tl.K11_VARIANTS)
    assert {r[4]: (int(r[0]), int(r[1])) for r in rows} == tl.K11_TILES
    first = tl.K11_VARIANTS.index("first")
    assert tl.K11_FOLDS == tuple(v for i, v in enumerate(tl.K11_VARIANTS)
                                 if i < first and v != "nofold")
    assert "(im.W + G::TW - 1) / G::TW, (im.r1 - im.r0 + G::TH - 1) / G::TH, C" in src
    assert tl.k11_grid(3, 512, 640) == (20, 16, 3)
    assert tl.k11_grid(3, 14, 640, "t32x16") == (20, 1, 3)
    assert tl.k11_grid(1, 33, 65, "t64x16") == (2, 3, 1)
    assert tl.k11_grid(3, 1, 40, "persist") == (2, 1, 3)


def test_k11_variants_on_the_cpu():
    """On CPU tensors the K11 variants that compute K11's outputs are its
    plain version; the timing-only ones raise."""
    a, b = images((3, 24, 40))
    want = tl.ssim_forward_plain(t(a), t(b), 2, 20)
    for v in tl.K11_VARIANTS:
        if v in tl.K11_TIMING_ONLY:
            with pytest.raises(ValueError, match="timing probe"):
                tl.ssim_forward_probe(v, t(a), t(b))
        else:
            got = tl.ssim_forward_probe(v, t(a), t(b), 2, 20)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="unknown K11 variant"):
        tl.ssim_forward_probe("fast", t(a), t(b))


def test_k12_grid_is_the_kernels():
    """losses.K12_TILES holds each variant's tile as csrc/ssim_backward.cuh's
    kK12Shapes row of that variant (K12Variant's order, the enum's names
    the variants'), each geometry is one the kernel's static checks take,
    and launch_ssim_backward's grid covers every row of the image from the
    tile."""
    import re

    with open(os.path.join(ROOT, "gaussian_lic_tpu_torch", "csrc", "ssim_backward.cuh")) as f:
        src = f.read()
    enum = re.findall(r"^  (kK12\w+) = (\d+),", src, re.M)
    assert [int(v) for _, v in enum] == list(range(len(tl.K12_VARIANTS)))
    camel = {"Base": "base", "T32x32": "t32x32", "A4": "a4", "Sync": "sync", "R8": "r8",
             "T32x16": "t32x16", "T32x24": "t32x24", "NoStage": "nostage", "NoVert": "novert",
             "NoHoriz": "nohoriz", "NoEpi": "noepi", "First": "first",
             "FirstNoVert": "first_novert", "FirstNoHoriz": "first_nohoriz",
             "FirstNoEpi": "first_noepi", "FirstLb5": "first_lb5"}
    assert [camel.get(name[4:], name) for name, _ in enum] == list(tl.K12_VARIANTS)
    rows = re.findall(r"^    \{(\d+), (\d+), (\d+), (\d+), (\d+)\},\s+// (\w+)$", src, re.M)
    assert [r[5] for r in rows] == list(tl.K12_VARIANTS)
    assert {r[5]: (int(r[0]), int(r[1])) for r in rows} == tl.K12_TILES
    for tw, th, threads, blocks, seg in (tuple(map(int, r[:5])) for r in rows):
        assert tw % 4 == 0 and th % seg == 0 and threads % 32 == 0 and blocks >= 4
    assert "(a.W + G::TW - 1) / G::TW, (a.H + G::TH - 1) / G::TH, a.C" in src
    assert set(tl.K12_TIMING_ONLY) < set(tl.K12_VARIANTS)
    assert tl.K12_VARIANTS[0] == "base" and "base" not in tl.K12_TIMING_ONLY


def test_k12_variants_on_the_cpu():
    """On CPU tensors the K12 variants that compute K12's d are its plain
    version, whole image and a window; the timing-only ones raise."""
    a, b = images((3, 24, 40))
    x, y = t(a), t(b)
    g = window_grad(x.numel(), 0.2)
    for r0, r1 in ((0, 24), (2, 20)):
        maps = tl.ssim_forward_plain(x, y, r0, r1)[1]
        want = tl.ssim_backward_plain(x, y, maps, g, r0, r1)
        for v in tl.K12_VARIANTS:
            if v in tl.K12_TIMING_ONLY:
                with pytest.raises(ValueError, match="timing probe"):
                    tl.ssim_backward_probe(v, x, y, maps, g, r0, r1)
            else:
                assert torch.equal(tl.ssim_backward_probe(v, x, y, maps, g, r0, r1), want)
    with pytest.raises(ValueError, match="unknown K12 variant"):
        tl.ssim_backward_probe("fast", x, y, maps, g)


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

def card_inputs(dev, shape, seed=0):
    a, b = images(shape, seed)
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def check_kernels(x, y, r0, r1, npix, lam=0.2):
    """K11 and K12 on (x, y) and window [r0, r1) against their plain
    versions: partial maps and gradient bit for bit, sums within SUM_RTOL."""
    sums, maps = tl.ssim_forward(x, y, r0, r1)
    p_sums, p_maps = tl.ssim_forward_plain(x, y, r0, r1)
    assert torch.equal(maps, p_maps)
    assert rel_max(n(sums), n(p_sums)) < SUM_RTOL
    nomaps = tl.ssim_forward(x, y, r0, r1, partials=False)
    assert nomaps[1] is None and torch.equal(nomaps[0], sums)
    g = window_grad(npix, lam).to(x.device)
    d = tl.ssim_backward(x, y, maps, g, r0, r1)
    assert torch.equal(d, tl.ssim_backward_plain(x, y, p_maps, g, r0, r1))
    return d


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", SHAPES + [(3, 512, 640), (1, 33, 65)], ids=str)
def test_card_kernels_against_plain(cuda_device, shape):
    x, y = card_inputs(cuda_device, shape)
    before = dict(tl.LAUNCHES)
    check_kernels(x, y, 0, shape[1], x.numel())
    assert tl.LAUNCHES["ssim_forward"] == before["ssim_forward"] + 2
    assert tl.LAUNCHES["ssim_backward"] == before["ssim_backward"] + 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D,b", BANDS + [(8, 0), (8, 7)])
def test_card_band_kernels_against_plain(cuda_device, D, b):
    a, g = images((3, 64, 40), seed=D + b)
    ea, eg = (torch.as_tensor(band_ext(v, D, b), device=cuda_device) for v in (a, g))
    hb = ea.shape[1] - 2 * tl.HALO
    check_kernels(ea, eg, tl.HALO, tl.HALO + hb, a.size)


@pytest.mark.requires_cuda
def test_card_strided_views(cuda_device):
    """The kernels read images with any channel and row strides (the
    sharded step's gt rows are a slice of a padded image)."""
    big_x, big_y = card_inputs(cuda_device, (3, 60, 80))
    x, y = big_x[:, 7:47, 3:63], big_y[:, 7:47, 3:63]
    d = check_kernels(x, y, 0, 40, x.numel())
    assert torch.equal(d, check_kernels(x.contiguous(), y.contiguous(), 0, 40, x.numel()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(3, 24, 40), (3, 512, 640)], ids=str)
def test_card_loss_and_grad_against_autograd(cuda_device, shape):
    a, b = images(shape, seed=11)
    x, y = torch.as_tensor(a, device=cuda_device), torch.as_tensor(b, device=cuda_device)
    got = value_and_grad(tl.training_loss, x, y)
    want = value_and_grad(tl.training_loss_plain, x, y)
    assert rel_max(n(got[0]), n(want[0])) < SUM_RTOL
    assert rel_max(n(got[1]), n(want[1])) < GRAD_RTOL
    s = tl.ssim(x, y)
    assert rel_max(n(s), n(tl.ssim_plain(x, y))) < SUM_RTOL


@pytest.mark.requires_cuda
def test_card_gt_needing_a_gradient_raises(cuda_device):
    x, y = card_inputs(cuda_device, (3, 24, 40))
    with pytest.raises(ValueError, match="gt"):
        tl.training_loss(x.requires_grad_(), y.requires_grad_())


@pytest.mark.requires_cuda
def test_card_graph_capture(cuda_device):
    """A train loss and its K12 backward captured in a CUDA graph, replayed
    on new inputs copied into its static tensors."""
    x, y = card_inputs(cuda_device, (3, 64, 80))
    sx, sy = x.clone().requires_grad_(), y.clone()

    def step():
        return torch.autograd.grad(tl.training_loss(sx, sy), sx)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    x2, y2 = card_inputs(cuda_device, (3, 64, 80), seed=12)
    with torch.no_grad():
        sx.copy_(x2)
        sy.copy_(y2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, value_and_grad(tl.training_loss, x2, y2)[1])


# the new tile's edges: W not a multiple of 4 (scalar partial-map stores),
# tiles cut by the image's right and bottom edges, C = 1, W below a tile
EDGE_SHAPES = [(3, 33, 65), (3, 40, 38), (1, 20, 20), (1, 5, 12), (3, 64, 68), (2, 47, 97)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_card_k11_tile_edges(cuda_device, shape):
    x, y = card_inputs(cuda_device, shape, seed=sum(shape))
    check_kernels(x, y, 0, shape[1], x.numel())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r0,r1", [(7, 29), (33, 38), (1, 2), (31, 33)])
def test_card_k11_windows_inside_tiles(cuda_device, r0, r1):
    """Windows that start and end inside a tile of the image (3, 40, 70)."""
    x, y = card_inputs(cuda_device, (3, 40, 70), seed=r0)
    check_kernels(x, y, r0, r1, x.numel())


@pytest.mark.requires_cuda
def test_card_k11_sums_repeat_bit_for_bit(cuda_device):
    """Two eager runs and a CUDA graph replay give the same sums, bit for
    bit: the blocks' sums reduce in a fixed order, and the last block's
    count starts from zero at every launch."""
    x, y = card_inputs(cuda_device, (3, 512, 640), seed=13)
    first = tl.ssim_forward(x, y)[0].clone()
    second = tl.ssim_forward(x, y)[0].clone()
    eval_sums = tl.ssim_forward(x, y, partials=False)[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tl.ssim_forward(x, y)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sums, _ = tl.ssim_forward(x, y)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(sums, first)
    assert torch.equal(first, second) and torch.equal(first, eval_sums)
    p_sums = tl.ssim_forward_plain(x, y)[0]
    assert rel_max(n(first), n(p_sums)) < SUM_RTOL


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(3, 24, 40), (3, 33, 65), (1, 5, 12)], ids=str)
def test_card_k12_unchanged(cuda_device, shape):
    """K12 (the listed design, ssim_backward.cuh) stays bit for bit with
    ssim_backward_plain on K11's partial maps, whole image and a window."""
    x, y = card_inputs(cuda_device, shape, seed=5)
    sums, maps = tl.ssim_forward(x, y)
    g = window_grad(x.numel(), 0.2).to(cuda_device)
    assert torch.equal(tl.ssim_backward(x, y, maps, g),
                       tl.ssim_backward_plain(x, y, maps, g))
    if shape[1] > 2:
        sums, maps = tl.ssim_forward(x, y, 1, shape[1] - 1)
        assert torch.equal(tl.ssim_backward(x, y, maps, g, 1, shape[1] - 1),
                           tl.ssim_backward_plain(x, y, maps, g, 1, shape[1] - 1))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", [v for v in tl.K11_VARIANTS if v not in tl.K11_TIMING_ONLY])
@pytest.mark.parametrize("shape", [(3, 37, 53), (1, 20, 20), (3, 512, 640)], ids=str)
def test_card_k11_variants_against_plain(cuda_device, variant, shape):
    """Every K11 variant that claims K11's outputs gives the plain version's
    partial maps bit for bit and its sums within SUM_RTOL, whole image and a
    window."""
    x, y = card_inputs(cuda_device, shape, seed=3)
    for r0, r1 in ((0, shape[1]), (shape[1] // 4, shape[1] - shape[1] // 3)):
        before = tl.PROBE_LAUNCHES[variant]
        sums, maps = tl.ssim_forward_probe(variant, x, y, r0, r1)
        p_sums, p_maps = tl.ssim_forward_plain(x, y, r0, r1)
        torch.cuda.synchronize()
        assert tl.PROBE_LAUNCHES[variant] == before + 1
        assert torch.equal(maps, p_maps)
        assert rel_max(n(sums), n(p_sums)) < SUM_RTOL


def k12_cases(dev):
    """(x, y, r0, r1, npix) of K12's variant tests: the 1M step's image
    size, W not a multiple of 4, an image below a tile, and the first and
    last band of D = 8 with their halo rows."""
    out = []
    for shape in ((3, 512, 640), (1, 33, 65), (1, 5, 12)):
        x, y = card_inputs(dev, shape, seed=sum(shape))
        out.append((x, y, 0, shape[1], x.numel()))
    a, g = images((3, 64, 40), seed=8)
    for b in (0, 7):
        ea, eg = (torch.as_tensor(band_ext(v, 8, b), device=dev) for v in (a, g))
        out.append((ea, eg, tl.HALO, ea.shape[1] - tl.HALO, a.size))
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", [v for v in tl.K12_VARIANTS if v not in tl.K12_TIMING_ONLY])
def test_card_k12_variants_against_plain(cuda_device, variant):
    """Every K12 variant that claims K12's d gives ssim_backward_plain's bit
    for bit (up to the sign of a zero) on K11's partial maps: at the 1M
    step's 3x512x640, at (1, 33, 65) and (1, 5, 12), and on bands 0 and 7 of
    D = 8 (windows that start and end inside a tile); one launch each."""
    for x, y, r0, r1, npix in k12_cases(cuda_device):
        maps = tl.ssim_forward(x, y, r0, r1)[1]
        g = window_grad(npix, 0.2).to(cuda_device)
        before = tl.K12_PROBE_LAUNCHES[variant]
        got = tl.ssim_backward_probe(variant, x, y, maps, g, r0, r1)
        torch.cuda.synchronize()
        assert tl.K12_PROBE_LAUNCHES[variant] == before + 1
        assert torch.equal(got, tl.ssim_backward_plain(x, y, maps, g, r0, r1))


@pytest.mark.requires_cuda
def test_card_k12_graph_replays(cuda_device):
    """K12 captured in a CUDA graph and replayed twice gives the eager
    kernel's d both times."""
    x, y = card_inputs(cuda_device, (3, 512, 640), seed=9)
    maps = tl.ssim_forward(x, y)[1]
    g = window_grad(x.numel(), 0.2).to(cuda_device)
    eager = tl.ssim_backward(x, y, maps, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tl.ssim_backward(x, y, maps, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d = tl.ssim_backward(x, y, maps, g)
    for _ in range(2):
        d.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(d, eager)
