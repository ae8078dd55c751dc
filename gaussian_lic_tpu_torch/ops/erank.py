"""Effective-rank (anti-needle) regularizer on Gaussian scales.

The counterpart of the JAX package's `ops/erank.py`. The reference adds this
term directly to the scale gradients when lambda_erank > 0 (backward.cu:355-376):

  S      = s1^2 + s2^2 + s3^2
  q_i    = s_i / S
  erank  = exp(-sum q_i log q_i)
  gated on -log(erank - 1 + 1e-5) > 0:
    dq_i = erank / (erank - 1 + 1e-5) * (-log q_i - 1)
    g_1  = lambda * 2/S^2 * s1 * ( dq_1 (s2^2+s3^2) - dq_2 s2^2 - dq_3 s3^2)
    g_2  = lambda * 2/S^2 * s2 * (-dq_1 s1^2 + dq_2 (s1^2+s3^2) - dq_3 s3^2)
    g_3  = lambda * 2/S^2 * s3 * (-dq_1 s1^2 - dq_2 s2^2 + dq_3 (s1^2+s2^2))
  plus an unconditional +1 on the s3 (z-scale) gradient.

The reference has no loss value for it, only this gradient, so
`erank_regularizer` is a zero-valued autograd function whose backward injects
exactly this gradient into the scale cotangent.
"""

from __future__ import annotations

import torch

_EPS = 1e-5


def _erank_scale_grad(scale: torch.Tensor) -> torch.Tensor:
    """The reference's per-Gaussian addition to dL/dscale, without lambda
    and without the +1 on z."""
    s1, s2, s3 = scale[:, 0], scale[:, 1], scale[:, 2]
    s1s1, s2s2, s3s3 = s1 * s1, s2 * s2, s3 * s3
    S = s1s1 + s2s2 + s3s3
    safe_S = torch.clamp_min(S, 1e-20)
    q1 = torch.clamp_min(s1 / safe_S, 1e-20)
    q2 = torch.clamp_min(s2 / safe_S, 1e-20)
    q3 = torch.clamp_min(s3 / safe_S, 1e-20)
    erank = torch.exp(-(q1 * torch.log(q1) + q2 * torch.log(q2) + q3 * torch.log(q3)))
    # reference gate: -log(erank - 1 + eps) > 0. The q_i are not normalized
    # (s / sum s^2), so erank < 1 happens; there the CUDA log returns NaN and
    # the comparison is false: the gate is open only for 0 < arg < 1.
    arg = erank - 1.0 + _EPS
    gate = (arg > 0.0) & (arg < 1.0)
    coeff = erank / (erank - 1.0 + _EPS)
    dq1 = coeff * (-torch.log(q1) - 1.0)
    dq2 = coeff * (-torch.log(q2) - 1.0)
    dq3 = coeff * (-torch.log(q3) - 1.0)
    lam_ = 2.0 / (safe_S * safe_S)
    g1 = lam_ * s1 * (dq1 * (s2s2 + s3s3) - dq2 * s2s2 - dq3 * s3s3)
    g2 = lam_ * s2 * (-dq1 * s1s1 + dq2 * (s1s1 + s3s3) - dq3 * s3s3)
    g3 = lam_ * s3 * (-dq1 * s1s1 - dq2 * s2s2 + dq3 * (s1s1 + s2s2))
    g = torch.stack([g1, g2, g3], dim=1)
    return torch.where(gate[:, None], g, torch.zeros_like(g))


class _Erank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scale, lambda_erank):
        ctx.save_for_backward(scale)
        ctx.lambda_erank = lambda_erank
        return scale.new_zeros(())

    @staticmethod
    def backward(ctx, ct):
        (scale,) = ctx.saved_tensors
        g = ctx.lambda_erank * _erank_scale_grad(scale)
        g[:, 2] += 1.0  # unconditional +1 on the z-scale gradient
        return ct * g, None


def erank_regularizer(scale: torch.Tensor, lambda_erank: float) -> torch.Tensor:
    """Zero-valued term injecting the reference's erank gradient into `scale`
    (activated (P, 3) scales). Add its result to the training loss."""
    return _Erank.apply(scale, lambda_erank)
