"""Sparse visibility-masked Adam, and the dense Adam of the exposure.

Parity with adamUpdateCUDA (adam.cu:9-38) / SparseGaussianAdam
(optim_utils.h:69-142), as the JAX package's `ops/adam.py`:
  * update only where the Gaussian was visible in the last render (radii > 0)
  * NO bias correction (adam.cu:30-34)
  * param += -lr * m / (sqrt(v) + eps), eps = 1e-15, betas (0.9, 0.999)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15  # gaussian.cpp:401


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
