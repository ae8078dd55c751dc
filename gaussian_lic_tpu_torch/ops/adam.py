"""Sparse visibility-masked Adam, and the dense Adam of the exposure.

Parity with adamUpdateCUDA (adam.cu:9-38) / SparseGaussianAdam
(optim_utils.h:69-142), as the JAX package's `ops/adam.py`:
  * update only where the Gaussian was visible in the last render (radii > 0)
  * NO bias correction (adam.cu:30-34)
  * param += -lr * m / (sqrt(v) + eps), eps = 1e-15, betas (0.9, 0.999)

`sparse_adam_update_groups` is kernel K7 (csrc/sparse_adam.cu), the
counterpart of the JAX package's `sparse_adam_update` over the six groups of
a train step, which XLA fuses on the TPU: on CUDA tensors one launch
updates every group from a table of group descriptors; on CPU tensors it is
the loop of `sparse_adam_update` over the groups. It writes fresh p', m', v'
of every row and none of its inputs (28 B an element; ~0.52 ms at 2^20
Gaussians of 59 floats on an H100): memory bound. `sparse_adam_update_groups_`
is the same update in place, the train step's inside a bundle's CUDA graph:
it writes p, m and v at the visible rows below the map's count alone and
reads no other row's floats, so its bytes follow the visible rows, not the
map's capacity; on CPU tensors it updates the visible rows by index. The
kernel rounds as PyTorch's ops do, one float32 rounding each in the plain
version's order, so both forms give the plain version's floats bit for bit.
`LAUNCHES` counts its launches.
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
    _fields_ += [("width", ctypes.c_int), ("neg_lr", ctypes.c_float)]


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


def _adam_rows(param, grad, exp_avg, exp_avg_sq, lr, b1, b2, eps):
    """Adam without bias correction on every element -> (param + step, m, v)."""
    m = b1 * exp_avg + (1.0 - b1) * grad
    v = b2 * exp_avg_sq + (1.0 - b2) * grad * grad
    step = -lr * m / (torch.sqrt(v) + eps)
    return param + step, m, v


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
    p, m, v = _adam_rows(param, grad, state.exp_avg, state.exp_avg_sq, lr, b1, b2, eps)
    new_param = torch.where(mask, p, param)
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
    new_p = {n: torch.empty_like(params[n]) for n in names}
    new_s = {n: AdamState(torch.empty_like(params[n]), torch.empty_like(params[n]))
             for n in names}
    _k7(params, grads, states, visible, lrs, new_p, new_s, None, b1, b2, eps)
    return new_p, new_s


def sparse_adam_update_groups_(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    states: Dict[str, AdamState],
    visible: torch.Tensor,      # (P,) bool mask over the leading axis
    lrs: Dict[str, float],
    count: Optional[torch.Tensor] = None,
    b1: float = BETA1,
    b2: float = BETA2,
    eps: float = EPS,
):
    """`sparse_adam_update_groups` in place: each group's param and moments
    get the plain version's floats at the rows `visible` marks, and every
    other row keeps its bits (K7 reads none of its floats). Returns (params,
    states), the objects passed in. `count` (the map's 0-d int32 count, on
    the device) bounds the rows walked: rows at or past it must be
    invisible. On CPU tensors the visible rows are updated by index."""
    names = list(params)
    if visible.device.type == "cpu":
        rows = visible.nonzero().squeeze(1)
        if count is not None:
            rows = rows[rows < count]
        for n in names:
            st = states[n]
            upd = _adam_rows(params[n][rows], grads[n][rows], st.exp_avg[rows],
                             st.exp_avg_sq[rows], lrs[n], b1, b2, eps)
            for t, u in zip((params[n], st.exp_avg, st.exp_avg_sq), upd):
                t.index_copy_(0, rows, u)
        return params, states
    if count is not None and (count.dtype != torch.int32 or count.device != visible.device
                              or count.dim() != 0):
        raise ValueError(f"count must be a 0-d int32 tensor on {visible.device}")
    _k7(params, grads, states, visible, lrs, params, states, count, b1, b2, eps)
    return params, states


def _k7(params, grads, states, visible, lrs, out_p, out_s, count, b1, b2, eps) -> None:
    """One K7 launch over the groups of `params` into `out_p` / `out_s`:
    in place when they are `params` / `states`, else fresh tensors."""
    names = list(params)
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
    for i, n in enumerate(names):
        ins = [params[n], grads[n], states[n].exp_avg, states[n].exp_avg_sq]
        for t in ins:
            if (t.shape != ins[0].shape or t.dtype != torch.float32 or t.device != visible.device
                    or t.shape[0] != P or not t.is_contiguous()):
                raise ValueError(f"group {n}: p, g, m and v must be contiguous float32 "
                                 f"(P, ...) on {visible.device} with P = {P}")
        outs = [out_p[n], out_s[n].exp_avg, out_s[n].exp_avg_sq]
        table[i] = _Group(*(t.data_ptr() for t in ins + outs),
                          ins[0].numel() // max(P, 1), -lrs[n])
    f = ctypes.c_float
    _launch(_build.load().cdll.glic_sparse_adam, ctypes.cast(table, ctypes.c_void_p),
            len(names), ctypes.c_longlong(P), _ptr(visible),
            ctypes.c_void_p(None if count is None else count.data_ptr()), f(b1), f(1.0 - b1),
            f(b2), f(1.0 - b2), f(eps), _stream(visible.device))
    LAUNCHES["sparse_adam"] += 1


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
