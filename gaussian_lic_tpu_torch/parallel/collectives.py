"""The collectives of the sharded step, on `torch.distributed`.

What `jax.shard_map` gives the JAX package for free, written out: each
differentiable collective is a `torch.autograd.Function` whose backward is
the transpose JAX's AD derives.

  * `all_gather` (dim 0) -> its backward is a reduce-scatter (sum): each
    rank's cotangent of the gathered tensor is summed over the ranks and the
    owner keeps its slice (JAX: all_gather's transpose, psum_scatter).
    `gather_grad` is that backward alone, for rows gathered without autograd.
  * `halo_exchange` -> the top HALO rows of a band go to rank - 1 and the
    bottom rows to rank + 1, zeros where the image ends (JAX: ppermute); the
    backward sends each halo cotangent back to the rank that owns the rows.
  * `all_reduce_sum`, not differentiable: the loss metric, the exposure
    gradient and the overflow counters.

Only calls that both the card's torch (2.11) and the CPU tests' (2.13) have:
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single,
batch_isend_irecv and all_reduce; gloo runs all of them on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_dim0(x: torch.Tensor, mesh) -> torch.Tensor:
    """(D * n, ...) concatenation of every rank's (n, ...) `x`, in rank order."""
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def reduce_scatter_dim0(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rank r's (n, ...) slice r of the sum over the ranks of (D * n, ...) `x`."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // mesh.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_dim0(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim0(g, ctx.mesh), None


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable gather along dim 0; the backward reduce-scatters."""
    return _AllGather.apply(x, mesh)


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.new_zeros(()).expand((mesh.size * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim0(g, ctx.mesh), None


def gather_grad(x: torch.Tensor, mesh) -> torch.Tensor:
    """A zero-strided (D * n, ...) stand-in for the gather of `x` (nothing is
    sent) whose backward is all_gather's, a reduce-scatter: the gradient of
    rows gathered by `gather_dim0` (ops/preprocess.py's `Splats.attrs`)."""
    return _GatherGrad.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor; no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def _neighbour_swap(to_prev: torch.Tensor, to_next: torch.Tensor, mesh):
    """Sends `to_prev` to rank - 1 and `to_next` to rank + 1; returns what
    rank - 1 and rank + 1 sent here (zeros where there is no neighbour). No
    operation is issued for a missing neighbour, so one rank issues none."""
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    ops = []
    if mesh.rank > 0:
        prev = mesh.ranks[mesh.rank - 1]
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), prev, mesh.group),
                dist.P2POp(dist.irecv, from_prev, prev, mesh.group)]
    if mesh.rank < mesh.size - 1:
        nxt = mesh.ranks[mesh.rank + 1]
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), nxt, mesh.group),
                dist.P2POp(dist.irecv, from_next, nxt, mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, band, halo, mesh):
        ctx.halo, ctx.mesh, ctx.rows = halo, mesh, band.shape[1]
        return _neighbour_swap(band[:, :halo], band[:, -halo:], mesh)

    @staticmethod
    def backward(ctx, g_up, g_dn):
        # g_up belongs to rank - 1's bottom rows, g_dn to rank + 1's top rows
        h = ctx.halo
        top, bottom = _neighbour_swap(g_up, g_dn, ctx.mesh)
        g = top.new_zeros((top.shape[0], ctx.rows, top.shape[2]))
        g[:, :h] += top
        g[:, ctx.rows - h:] += bottom
        return g, None, None


def halo_exchange(band: torch.Tensor, halo: int, mesh):
    """(up, dn) for a (C, Hb, W) band: the `halo` rows above it (rank - 1's
    bottom rows) and below it (rank + 1's top rows), zeros at the image's
    top and bottom. Differentiable: the cotangents go back to their owners."""
    return _Halo.apply(band, halo, mesh)
