"""LPIPS (AlexNet backbone), the eval-only perceptual metric.

The counterpart of the JAX package's `ops/lpips.py`. Reference behaviour
(C19): a torchscript lpips_alex.pt is loaded from `lpips_path` and fed
[0, 1]-clamped (1, 3, H, W) image pairs directly (gaussian.cpp:740-765, no
[-1, 1] rescale). The network: z-score with shift (-.030, -.088, -.188) /
scale (.458, .448, .450), the torchvision AlexNet `features` taps after each
of the five ReLUs, unit channel norm per tap, squared difference, a 1x1
no-bias linear head per tap, spatial mean, sum over taps.

The five convolutions run with TF32 off (cuDNN's default for float32
convolutions on the card is TF32), as the JAX package runs them at
`Precision.HIGHEST`. Weights come from an artifact (.npz, torch state_dict
.pth, or torchscript .pt), or from the "randinit" sentinel.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Union

import numpy as np
import torch
import torch.nn.functional as F

Device = Union[str, torch.device]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet `features` conv stack: (out_ch, in_ch, k, stride, pad)
_CONV_DEFS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
# a max-pool (3, stride 2) sits before convs 1 and 2
_POOL_BEFORE = {1, 2}
N_CHANNELS = [64, 192, 384, 256, 256]


class LPIPS(torch.nn.Module):
    """AlexNet-LPIPS with fixed weights, from a dict keyed conv{i}_w,
    conv{i}_b, lin{i}_w (the loaders' output). `forward(a, b)` takes
    (B, 3, H, W) images in [0, 1] and returns (B,)."""

    def __init__(self, params: Mapping[str, torch.Tensor], device: Device = "cpu"):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, torch.as_tensor(v, dtype=torch.float32).to(device))
        self.register_buffer("shift", torch.as_tensor(_SHIFT).to(device)[None, :, None, None])
        self.register_buffer("scale", torch.as_tensor(_SCALE).to(device)[None, :, None, None])

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Five unit-normalized feature taps."""
        cudnn = torch.backends.cudnn
        x = (x - self.shift) / self.scale
        feats = []
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            for i, (_o, _i, _k, stride, pad) in enumerate(_CONV_DEFS):
                if i in _POOL_BEFORE:
                    x = F.max_pool2d(x, kernel_size=3, stride=2)
                x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                    stride=stride, padding=pad))
                norm = torch.sqrt((x * x).sum(dim=1, keepdim=True))
                feats.append(x / (norm + 1e-10))
        return feats

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = a.new_zeros((a.shape[0],))
        for i, (xa, xb) in enumerate(zip(self.features(a), self.features(b))):
            lin = getattr(self, f"lin{i}_w")[0, :, 0, 0]
            score = ((xa - xb) ** 2 * lin[None, :, None, None]).sum(dim=1)
            total = total + score.mean(dim=(1, 2))
        return total


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

_EXPECTED_CONV_SHAPES = [(o, i, k, k) for (o, i, k, _s, _p) in _CONV_DEFS]


def _from_named_tensors(named) -> Dict[str, np.ndarray]:
    """The param dict from (name, array) pairs of any torch export: conv
    weights and biases matched by shape in stack order, lin heads by name
    order."""
    convs_w = {tuple(s): [] for s in _EXPECTED_CONV_SHAPES}
    biases: List[tuple] = []
    lins: List[tuple] = []
    for name, t in named:
        arr = np.asarray(t, np.float32)
        if arr.ndim == 4 and arr.shape[0] == 1 and arr.shape[2:] == (1, 1):
            lins.append((name, arr))
        elif arr.ndim == 4 and tuple(arr.shape) in convs_w:
            convs_w[tuple(arr.shape)].append((name, arr))
        elif arr.ndim == 1:
            biases.append((name, arr))

    params: Dict[str, np.ndarray] = {}
    bias_by_name = dict(biases)
    for i, shape in enumerate(_EXPECTED_CONV_SHAPES):
        cands = convs_w[tuple(shape)]
        if not cands:
            raise ValueError(f"missing conv{i} weight of shape {shape}")
        # two (256,256,3,3) convs: disambiguate by name order
        cands.sort(key=lambda kv: kv[0])
        name, w = cands.pop(0)
        params[f"conv{i}_w"] = w
        bname = name.replace("weight", "bias")
        if bname in bias_by_name:
            params[f"conv{i}_b"] = bias_by_name[bname]
        else:
            by_len = [b for _n, b in biases if b.shape[0] == shape[0]]
            if not by_len:
                raise ValueError(f"missing conv{i} bias ({shape[0]},)")
            params[f"conv{i}_b"] = by_len[0]
            biases = [nb for nb in biases if nb[1] is not params[f"conv{i}_b"]]
    lins.sort(key=lambda kv: kv[0])
    lin_arrays = [a for _n, a in lins]
    if [tuple(a.shape) for a in lin_arrays] != [(1, c, 1, 1) for c in N_CHANNELS]:
        # match by channel count, keeping name order for ties
        chosen = []
        pool = list(lin_arrays)
        for c in N_CHANNELS:
            for j, a in enumerate(pool):
                if a.shape[1] == c:
                    chosen.append(pool.pop(j))
                    break
            else:
                raise ValueError(f"missing lin head for {c} channels")
        lin_arrays = chosen
    for i, a in enumerate(lin_arrays):
        params[f"lin{i}_w"] = a
    return params


def _tensors(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}


def load_lpips_params(path: str) -> Dict[str, torch.Tensor]:
    """LPIPS-alex params (CPU tensors) from an .npz, a torch checkpoint (.pth
    state_dict) or a torchscript module (.pt), such as the reference's
    lpips_alex.pt, or a directory holding lpips_alex.{npz,pt,pth}.

    The sentinel path "randinit" (or "randinit:<seed>") builds the
    deterministic He-initialized instance of `randinit_lpips_params` instead
    of reading a file."""
    if path == "randinit" or path.startswith("randinit:"):
        seed = int(path.split(":", 1)[1]) if ":" in path else 0
        print(
            "[lpips] using the RANDOM-INIT AlexNet-LPIPS metric "
            f"(seed {seed}): self-consistent perceptual distance, NOT "
            "comparable to published LPIPS numbers — supply a trained "
            "lpips_alex artifact for those (tools/export_lpips.py)"
        )
        return randinit_lpips_params(seed)
    if os.path.isdir(path):
        for cand in ("lpips_alex.npz", "lpips_alex.pt", "lpips_alex.pth"):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                path = p
                break
        else:
            raise FileNotFoundError(f"no lpips_alex.{{npz,pt,pth}} under {path}")
    if path.endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
        params = raw if all(f"conv{i}_w" in raw for i in range(5)) else \
            _from_named_tensors(sorted(raw.items()))
    else:
        try:
            mod = torch.jit.load(path, map_location="cpu")
            named = [(n, p.detach().numpy()) for n, p in mod.named_parameters()]
            named += [(n, b.detach().numpy()) for n, b in mod.named_buffers()
                      if b.ndim in (1, 4)]
        except RuntimeError:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            named = [(n, t.numpy()) for n, t in sd.items()]
        params = _from_named_tensors(named)
    return _tensors(params)


def random_lpips_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random-weight instance (for architecture tests, not a trained metric)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for i, (o, ic, k, _s, _p) in enumerate(_CONV_DEFS):
        params[f"conv{i}_w"] = rng.normal(0, 0.05, (o, ic, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.01, (o,)).astype(np.float32)
    for i, c in enumerate(N_CHANNELS):
        params[f"lin{i}_w"] = np.abs(rng.normal(0, 0.01, (1, c, 1, 1))).astype(np.float32)
    return _tensors(params)


def randinit_lpips_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Deterministic randomly-initialized AlexNet-LPIPS: He-init convs and
    uniform 1/C lin heads, drawn from SeedSequence([0x1B1B5, seed]) as in the
    JAX package. A self-consistent perceptual distance that keeps the whole
    LPIPS pipeline exercised when no trained artifact exists; its values are
    not comparable to published LPIPS-alex numbers."""
    rng = np.random.default_rng(np.random.SeedSequence([0x1B1B5, seed]))
    params: Dict[str, np.ndarray] = {}
    for i, (o, ic, k, _s, _p) in enumerate(_CONV_DEFS):
        std = float(np.sqrt(2.0 / (ic * k * k)))  # He init for ReLU stacks
        params[f"conv{i}_w"] = rng.normal(0, std, (o, ic, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros((o,), np.float32)
    for i, c in enumerate(N_CHANNELS):
        params[f"lin{i}_w"] = np.full((1, c, 1, 1), 1.0 / c, np.float32)
    return _tensors(params)
