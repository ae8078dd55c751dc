"""Sparse visibility-masked Adam, and the dense Adam of the exposure.

Parity with adamUpdateCUDA (adam.cu:9-38) / SparseGaussianAdam
(optim_utils.h:69-142), as the JAX package's `ops/adam.py`:
  * update only where the Gaussian was visible in the last render (radii > 0)
  * NO bias correction (adam.cu:30-34)
  * param += -lr * m / (sqrt(v) + eps), eps = 1e-15, betas (0.9, 0.999)

`sparse_adam_update_groups` is kernel K7 (csrc/sparse_adam.cu), the
counterpart of the JAX package's `sparse_adam_update` over the six groups of
a train step, which XLA fuses on the TPU: on CUDA tensors one launch
updates every group, one thread per element, from a table of group
descriptors (its row is element // width); on CPU tensors it is the loop of
`sparse_adam_update` over the groups. Each element reads p, g, m, v and its
row's mask and writes p', m', v' (28 B; ~0.52 ms at 2^20 Gaussians of 59
floats on an H100): memory bound. The kernel rounds as PyTorch's ops do,
one float32 rounding each in the plain version's order, so it gives the
plain version's floats bit for bit. `LAUNCHES` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Union

import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15  # gaussian.cpp:401

# Launch count of K7 (plain-version calls are not counted).
LAUNCHES = {"sparse_adam": 0}
MAX_GROUPS = 6   # csrc/sparse_adam.cu's descriptor table


class _Group(ctypes.Structure):
    """One group's descriptor (csrc/sparse_adam.cu, AdamGroup)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("p", "g", "m", "v", "p_out", "m_out", "v_out")]
    _fields_ += [("offset", ctypes.c_longlong), ("width", ctypes.c_int),
                 ("neg_lr", ctypes.c_float)]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class AdamState(NamedTuple):
    """First/second moments of one parameter tensor."""

    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor

    @classmethod
    def zeros_like(cls, p: torch.Tensor) -> "AdamState":
        return cls(torch.zeros_like(p), torch.zeros_like(p))


def sparse_adam_update(
    param: torch.Tensor,
    grad: torch.Tensor,
    state: AdamState,
    visible: torch.Tensor,  # (P,) bool mask over the leading axis
    lr: float,
    b1: float = BETA1,
    b2: float = BETA2,
    eps: float = EPS,
):
    """One masked Adam step on a single (P, ...) tensor. Returns (param, state)."""
    mask = visible.reshape((-1,) + (1,) * (param.dim() - 1))
    m = b1 * state.exp_avg + (1.0 - b1) * grad
    v = b2 * state.exp_avg_sq + (1.0 - b2) * grad * grad
    step = -lr * m / (torch.sqrt(v) + eps)
    new_param = torch.where(mask, param + step, param)
    new_m = torch.where(mask, m, state.exp_avg)
    new_v = torch.where(mask, v, state.exp_avg_sq)
    return new_param, AdamState(new_m, new_v)


def sparse_adam_update_groups(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    states: Dict[str, AdamState],
    visible: torch.Tensor,      # (P,) bool mask over the leading axis
    lrs: Dict[str, float],
    b1: float = BETA1,
    b2: float = BETA2,
    eps: float = EPS,
):
    """`sparse_adam_update` of every group of `params` (each (P, ...)) ->
    (new params, new states), dicts keyed as `params`. K7 on CUDA tensors
    (one launch; it writes fresh tensors and none of its inputs), the loop
    over the groups on CPU tensors."""
    names = list(params)
    if visible.device.type == "cpu":
        out = {n: sparse_adam_update(params[n], grads[n], states[n], visible, lrs[n],
                                     b1, b2, eps) for n in names}
        return {n: o[0] for n, o in out.items()}, {n: o[1] for n, o in out.items()}
    if visible.device.type != "cuda":
        raise ValueError(f"sparse Adam takes CPU or CUDA tensors, got {visible.device}")
    if len(names) > MAX_GROUPS:
        raise ValueError(f"K7 takes at most {MAX_GROUPS} groups, got {len(names)}")
    P = visible.shape[0]
    if visible.dtype != torch.bool or tuple(visible.shape) != (P,):
        raise ValueError(f"visible must be (P,) bool, got {tuple(visible.shape)} {visible.dtype}")
    from gaussian_lic_tpu_torch import _build
    from gaussian_lic_tpu_torch.ops.blend import _launch, _ptr, _stream

    table = (_Group * MAX_GROUPS)()
    new_p, new_s, offset = {}, {}, 0
    for i, n in enumerate(names):
        ins = [params[n], grads[n], states[n].exp_avg, states[n].exp_avg_sq]
        for t in ins:
            if (t.shape != ins[0].shape or t.dtype != torch.float32 or t.device != visible.device
                    or t.shape[0] != P or not t.is_contiguous()):
                raise ValueError(f"group {n}: p, g, m and v must be contiguous float32 "
                                 f"(P, ...) on {visible.device} with P = {P}")
        outs = [torch.empty_like(t) for t in ins[:1] + ins[2:]]
        new_p[n], new_s[n] = outs[0], AdamState(outs[1], outs[2])
        table[i] = _Group(*(t.data_ptr() for t in ins + outs), offset,
                          ins[0].numel() // max(P, 1), -lrs[n])
        offset += ins[0].numel()
    f = ctypes.c_float
    _launch(_build.load().cdll.glic_sparse_adam, ctypes.cast(table, ctypes.c_void_p),
            len(names), ctypes.c_longlong(offset), _ptr(visible), f(b1), f(1.0 - b1), f(b2),
            f(1.0 - b2), f(eps), _stream(visible.device))
    LAUNCHES["sparse_adam"] += 1
    return new_p, new_s


def dense_adam_update(
    param: torch.Tensor,
    grad: torch.Tensor,
    state: AdamState,
    lr: float,
    b1: float = BETA1,
    b2: float = BETA2,
    eps: float = 1e-8,
    step_count: Optional[Union[int, torch.Tensor]] = None,
):
    """Bias-corrected Adam for the exposure params (torch::optim::Adam,
    gaussian.cpp:419-423). step_count is the 1-based step index, an int or
    a 0-d tensor (a CUDA graph's step reads it on the device). Either way
    1 - b**t is taken in float64 on the param's device and rounded to
    float32, as a Python float divisor is, so both give the same floats."""
    m = b1 * state.exp_avg + (1.0 - b1) * grad
    v = b2 * state.exp_avg_sq + (1.0 - b2) * grad * grad
    if step_count is None:
        mh, vh = m, v
    else:
        t = torch.as_tensor(step_count, dtype=torch.float64, device=m.device)
        mh = m / (1.0 - b1**t).float()
        vh = v / (1.0 - b2**t).float()
    new_param = param - lr * mh / (torch.sqrt(vh) + eps)
    return new_param, AdamState(m, v)
