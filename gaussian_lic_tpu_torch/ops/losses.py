"""Losses and image metrics: L1, PSNR, SSIM (separable blur), training loss;
kernels K11 (`ssim_forward`) and K12 (`ssim_backward`), joined by the
autograd Function `SSIMLoss`.

Parity targets (the JAX package's `ops/losses.py`):
  * l1_loss: mean |a-b|                      (loss_utils.h:30-33)
  * psnr:    10*log10(1/mse)                 (loss_utils.h:35-39)
  * ssim:    11-tap Gaussian window sigma=1.5, zero "same" padding,
             C1=0.01^2, C2=0.03^2            (loss_utils.h:51-128)
  * training loss: (1-l)*L1 + l*(1-SSIM), l=0.2 (gaussian.cpp:691)

The blur is 2x11 shifted multiply-adds, not a convolution: cuDNN runs float32
convolutions in TF32 by default, whose rounding breaks the
sigma^2 = blur(x^2) - mu^2 cancellation on smooth regions.

XLA fuses the SSIM program on the TPU; on the card it is two kernels, as the
reference's fused SSIM (SURVEY C14). For a window of rows [r0, r1) of a
(C, H, W) image and its target, K11 (csrc/ssim_forward.cu) writes the sums
of the SSIM map and of |img - gt| over the window and, when a gradient is
wanted, the partial maps dm/dmu1, dm/dsigma1^2 and dm/dsigma12; K12
(csrc/ssim_backward.cu) turns them into d loss / d img for every row,

    d = g_m (blur(w dm/dmu1) + 2 img blur(w dm/dsigma1^2) + gt blur(w dm/dsigma12))
        + g_d sgn(img - gt) w

with (g_m, g_d) the gradients of the two sums and w the window's rows. The
window is the whole image for `training_loss` and `ssim`, and the band
without its halo rows for `training_loss_band_part`.

Dispatch by the tensors' device, as `ops/blend.py`: CUDA tensors launch the
kernels or raise; CPU tensors take the plain chain (`ssim_map` and the sums,
recorded with autograd, whose backward is autograd's), so the CPU's floats
are those of the chains the port ran before the kernels (`*_plain` below).
`ssim_forward_plain` and `ssim_backward_plain` are K11's and K12's plain
versions, one rounded operation each in the kernels' order. `LAUNCHES`
counts kernel launches. Nothing here reads back to the host, so the train
step stays capturable in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01**2
C2 = 0.03**2
_WINDOW_SIZE = 11
_SIGMA = 1.5

_TILE = 32   # a K11 block's output tile, kTile x kTile (csrc/ssim_common.cuh)

# Launch counts of K11 and K12 (plain-version calls are not counted).
LAUNCHES = {"ssim_forward": 0, "ssim_backward": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse)


def _gaussian_window(window_size: int = _WINDOW_SIZE, sigma: float = _SIGMA) -> np.ndarray:
    """Normalized 1D Gaussian taps (loss_utils.h:51-65 uses x - ws//2)."""
    x = np.arange(window_size, dtype=np.float64) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


_TAPS = [float(v) for v in _gaussian_window()]


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable depthwise 11x11 Gaussian blur, zero 'same' padding, every tap
    in f32. img: (C, H, W)."""
    C, H, W = img.shape
    r = _WINDOW_SIZE // 2
    xp = F.pad(img, (0, 0, r, r))
    out = _TAPS[0] * xp[:, 0:H, :]
    for k in range(1, _WINDOW_SIZE):
        out = out + _TAPS[k] * xp[:, k:k + H, :]
    xp = F.pad(out, (r, r, 0, 0))
    out = _TAPS[0] * xp[:, :, 0:W]
    for k in range(1, _WINDOW_SIZE):
        out = out + _TAPS[k] * xp[:, :, k:k + W]
    return out


def _ssim_terms(img1: torch.Tensor, img2: torch.Tensor) -> dict:
    """The SSIM map and the terms K11's partial maps read: mu1, mu2, A =
    2 mu1 mu2 + C1, B = 2 sigma12 + C2, C = mu1^2 + mu2^2 + C1, D = sigma1^2
    + sigma2^2 + C2 and den = C D, the operations in the map's order (the
    order autograd's record takes too)."""
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1) - mu1_sq
    sigma2_sq = _blur(img2 * img2) - mu2_sq
    sigma12 = _blur(img1 * img2) - mu1_mu2
    a = 2.0 * mu1_mu2 + C1
    b = 2.0 * sigma12 + C2
    num = a * b
    c = mu1_sq + mu2_sq + C1
    d = sigma1_sq + sigma2_sq + C2
    den = c * d
    return dict(m=num / den, mu1=mu1, mu2=mu2, a=a, b=b, c=c, d=d, den=den)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map for (C, H, W) images in [0,1]."""
    return _ssim_terms(img1, img2)["m"]


# ---------------------------------------------------------------------------
# the plain chains the port ran before K11 and K12
# ---------------------------------------------------------------------------

def ssim_plain(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM, the plain chain."""
    return ssim_map(img1, img2).mean()


def training_loss_plain(rendered: torch.Tensor, gt: torch.Tensor,
                        lambda_dssim: float = 0.2) -> torch.Tensor:
    """`training_loss` as the plain chain."""
    return (1.0 - lambda_dssim) * l1_loss(rendered, gt) + lambda_dssim * (
        1.0 - ssim_plain(rendered, gt)
    )


def training_loss_band_part_plain(rendered_ext: torch.Tensor, gt_ext: torch.Tensor,
                                  n_pixels: int, lambda_dssim: float = 0.2) -> torch.Tensor:
    """`training_loss_band_part` as the plain chain."""
    hb = rendered_ext.shape[1] - 2 * HALO
    diff_sum = (rendered_ext[:, HALO:HALO + hb] - gt_ext[:, HALO:HALO + hb]).abs().sum()
    smap = ssim_map(rendered_ext, gt_ext)[:, HALO:HALO + hb]
    return ((1.0 - lambda_dssim) * diff_sum - lambda_dssim * smap.sum()) / n_pixels


def _window_sums(img: torch.Tensor, gt: torch.Tensor, r0: int, r1: int) -> tuple:
    """((sum of the map, sum of |img - gt|) over rows [r0, r1), the map's
    terms): the sums as the plain chains compute them, the L1 term first
    and the whole image unsliced, so that autograd's record of them is the
    chains' own."""
    whole = r0 == 0 and r1 == img.shape[1]
    if whole:
        d_sum = (img - gt).abs().sum()
    else:
        d_sum = (img[:, r0:r1] - gt[:, r0:r1]).abs().sum()
    t = _ssim_terms(img, gt)
    m = t["m"] if whole else t["m"][:, r0:r1]
    return (m.sum(), d_sum), t


# ---------------------------------------------------------------------------
# K11 and K12: plain versions and kernels
# ---------------------------------------------------------------------------

def ssim_forward_plain(img: torch.Tensor, gt: torch.Tensor, r0: int = 0, r1: int = None,
                       partials: bool = True):
    """K11's plain version: (sums (2,): the SSIM map's sum and |img - gt|'s
    over rows [r0, r1); the partial maps (3, C, r1 - r0, W) dm/dmu1 (blur(x^2)
    and blur(xy) held), dm/dsigma1^2, dm/dsigma12, or None)."""
    r1 = img.shape[1] if r1 is None else r1
    sums, t = _window_sums(img, gt, r0, r1)
    sums = torch.stack(sums)
    if not partials:
        return sums, None
    m, mu1, mu2, a, b, c, d, den = (t[k][:, r0:r1] for k in ("m", "mu1", "mu2", "a", "b", "c",
                                                              "d", "den"))
    dm_dmu1 = 2.0 * (mu2 * (b - a) + mu1 * m * (c - d)) / den
    return sums, torch.stack([dm_dmu1, -(m / d), (2.0 * a) / den])


def ssim_backward_plain(img: torch.Tensor, gt: torch.Tensor, partials: torch.Tensor,
                        grad: torch.Tensor, r0: int = 0, r1: int = None) -> torch.Tensor:
    """K12's plain version, the closed form: d (C, H, W) = g_m (blur(P1) +
    2 img blur(P2) + gt blur(P3)) + g_d sgn(img - gt) w for the partial maps
    P (3, C, r1 - r0, W) of `ssim_forward_plain`, zero outside the window,
    and grad (2,) = (g_m, g_d), the gradients of its two sums."""
    C, H, W = img.shape
    r1 = H if r1 is None else r1
    p = F.pad(partials, (0, 0, r0, H - r1))
    b = _blur(p.reshape(3 * C, H, W)).reshape(3, C, H, W)
    rows = torch.arange(H, device=img.device)
    w = ((rows >= r0) & (rows < r1)).to(img.dtype)[:, None]
    inner = b[0] + 2.0 * img * b[1] + gt * b[2]
    return grad[0] * inner + grad[1] * (torch.sign(img - gt) * w)


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSIM loss takes CPU or CUDA tensors, got {t.device}")
    return t.device.type


def _image(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    """`t` as the kernels read it: float32 (C, H, W) on `device`, unit column
    stride (any channel and row strides)."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be {tuple(shape)} float32, got {tuple(t.shape)} "
                         f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    return t if t.stride(2) == 1 else t.contiguous()


def _window(img: torch.Tensor, r0: int, r1: int) -> tuple:
    if img.dim() != 3:
        raise ValueError(f"the SSIM loss takes (C, H, W) images, got {tuple(img.shape)}")
    r1 = img.shape[1] if r1 is None else r1
    if not 0 <= r0 < r1 <= img.shape[1]:
        raise ValueError(f"window rows [{r0}, {r1}) outside an image of {img.shape[1]} rows")
    return r0, r1


def _konst():
    """The 11 taps, C1 and C2 as the kernels take them: host floats, each the
    float32 value PyTorch uses for the Python scalar."""
    return (ctypes.c_float * (_WINDOW_SIZE + 2))(*_TAPS, C1, C2)


def ssim_forward(img: torch.Tensor, gt: torch.Tensor, r0: int = 0, r1: int = None,
                 partials: bool = True):
    """K11: (sums (2,), partial maps (3, C, r1 - r0, W) or None), as
    `ssim_forward_plain` (CPU tensors: that function)."""
    if _device_kind(img) == "cpu":
        return ssim_forward_plain(img, gt, r0, r1, partials)
    from gaussian_lic_tpu_torch import _build
    from gaussian_lic_tpu_torch.ops.blend import _launch, _ptr, _stream

    r0, r1 = _window(img, r0, r1)
    dev = img.device
    img = _image("img", img, img.shape, dev)
    gt = _image("gt", gt, img.shape, dev)
    C, H, W = img.shape
    n_blocks = C * -(-(r1 - r0) // _TILE) * -(-W // _TILE)
    block_sums = torch.empty((n_blocks, 2), dtype=torch.float32, device=dev)
    maps = (torch.empty((3, C, r1 - r0, W), dtype=torch.float32, device=dev) if partials
            else None)
    _launch(_build.load().cdll.glic_ssim_forward, _ptr(img), img.stride(0), img.stride(1),
            _ptr(gt), gt.stride(0), gt.stride(1), C, H, W, r0, r1, _konst(),
            _ptr(maps) if partials else ctypes.c_void_p(None), _ptr(block_sums), _stream(dev))
    LAUNCHES["ssim_forward"] += 1
    return block_sums.sum(0), maps


def ssim_backward(img: torch.Tensor, gt: torch.Tensor, partials: torch.Tensor,
                  grad: torch.Tensor, r0: int = 0, r1: int = None) -> torch.Tensor:
    """K12: d (C, H, W), as `ssim_backward_plain` (CPU tensors: that
    function). `grad` (2,) stays on the device."""
    if _device_kind(img) == "cpu":
        return ssim_backward_plain(img, gt, partials, grad, r0, r1)
    from gaussian_lic_tpu_torch import _build
    from gaussian_lic_tpu_torch.ops.blend import _check, _launch, _ptr, _stream

    r0, r1 = _window(img, r0, r1)
    dev = img.device
    img = _image("img", img, img.shape, dev)
    gt = _image("gt", gt, img.shape, dev)
    C, H, W = img.shape
    _check("partials", partials, (3, C, r1 - r0, W), torch.float32, dev)
    grad = grad.to(torch.float32).contiguous()
    _check("grad", grad, (2,), torch.float32, dev)
    d = torch.empty((C, H, W), dtype=torch.float32, device=dev)
    _launch(_build.load().cdll.glic_ssim_backward, _ptr(img), img.stride(0), img.stride(1),
            _ptr(gt), gt.stride(0), gt.stride(1), C, H, W, r0, r1, _konst(), _ptr(partials),
            _ptr(grad), _ptr(d), _stream(dev))
    LAUNCHES["ssim_backward"] += 1
    return d


class SSIMLoss(torch.autograd.Function):
    """(img, gt, r0, r1) -> (2,): the sums of the SSIM map and of |img - gt|
    over rows [r0, r1), differentiable in img. On CUDA tensors the forward
    is K11 and the backward K12 (a gt that needs a gradient raises); on CPU
    tensors the forward is the plain chain, recorded on detached copies of
    the inputs, and the backward is autograd's over that record (the same
    floats as autograd of the chain itself)."""

    @staticmethod
    def forward(ctx, img, gt, r0, r1):
        ctx.window, ctx.record = (r0, r1), None
        if _device_kind(img) == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need)
                          for t, need in zip((img, gt), ctx.needs_input_grad)]
                sums = _window_sums(*leaves, r0, r1)[0]
            ctx.record = (sums, leaves)
            return torch.stack([s.detach() for s in sums])
        if ctx.needs_input_grad[1]:
            raise ValueError("K12 gives no gradient for gt: detach it")
        sums, maps = ssim_forward(img, gt, r0, r1, partials=ctx.needs_input_grad[0])
        ctx.save_for_backward(img, gt, maps)
        return sums

    @staticmethod
    def backward(ctx, grad):
        if ctx.record is None:
            img, gt, maps = ctx.saved_tensors
            return ssim_backward(img, gt, maps, grad, *ctx.window), None, None, None
        sums, leaves = ctx.record
        need = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(sums, need, (grad[0], grad[1]), allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in leaves) + (None, None)


def ssim_sums(img: torch.Tensor, gt: torch.Tensor, r0: int = 0, r1: int = None) -> torch.Tensor:
    """(2,): the sums of the SSIM map and of |img - gt| over rows [r0, r1):
    `SSIMLoss` where a gradient is wanted, else K11 alone without its
    partial maps (CPU tensors: the plain chain)."""
    _device_kind(img)
    r0, r1 = _window(img, r0, r1)
    if torch.is_grad_enabled() and (img.requires_grad or gt.requires_grad):
        return SSIMLoss.apply(img, gt, r0, r1)
    return ssim_forward(img, gt, r0, r1, partials=False)[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM."""
    return ssim_sums(img1, img2)[0] / img1.numel()


def training_loss(
    rendered: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2
) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM)  (gaussian.cpp:685-691)."""
    sums = ssim_sums(rendered, gt)
    n = rendered.numel()
    return (1.0 - lambda_dssim) * (sums[1] / n) + lambda_dssim * (1.0 - sums[0] / n)


HALO = _WINDOW_SIZE // 2  # rows of neighbour context one band needs for SSIM


def training_loss_band_part(
    rendered_ext: torch.Tensor,  # (C, Hb + 2*HALO, W) band + halo rows
    gt_ext: torch.Tensor,        # (C, Hb + 2*HALO, W) matching GT rows
    n_pixels: int,               # C*H*W of the FULL image
    lambda_dssim: float = 0.2,
) -> torch.Tensor:
    """Partial training loss of one horizontal band of the image (the JAX
    package's `ops/losses.py:training_loss_band_part`).

    The band is extended by HALO rows of its neighbours on each side (zeros
    at the image's edges, as `_blur`'s zero padding), so the band's rows of
    `ssim_map` here are those of the full image's map, and

        training_loss(full) = sum over bands of training_loss_band_part + lambda

    A sharded caller sums the parts over its ranks and adds lambda for the
    metric; each rank's gradient flows through its own band and, by the halo
    exchange's backward, its neighbours' halo rows."""
    hb = rendered_ext.shape[1] - 2 * HALO
    sums = ssim_sums(rendered_ext, gt_ext, HALO, HALO + hb)
    return ((1.0 - lambda_dssim) * sums[1] - lambda_dssim * sums[0]) / n_pixels
