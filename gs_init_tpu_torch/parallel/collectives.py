"""Collectives over a ``torch.distributed`` process group, with the
gradients that ``jax.shard_map`` gives the JAX package's sharded steps.

- ``all_gather(x, group, dim)`` concatenates every rank's ``x`` along
  ``dim`` in group-rank order, as ``jax.lax.all_gather(..., tiled=True)``.
  Its backward is a *summing* reduce-scatter: each rank gets the sum over
  the group of the cotangents of its own slice. That is JAX's transpose of
  an all_gather, so the fold factors of ``parallel/shard.py`` (a gradient
  that arrives once from every rank of the group) carry over unchanged.
- ``psum(x, group)``: a sum over the group whose backward is again a psum
  of the cotangents (JAX's transpose of ``psum`` without replication
  checks). ``pmean`` and ``pmax`` carry no gradient.

The backend is the group's own, chosen where the group was made: ``nccl``
for ranks on separate cards, ``gloo`` for CPU tensors and for ranks that
share one card (NCCL refuses two ranks of one communicator on one device:
"Duplicate GPU detected"). Every op here is the list form of a
``torch.distributed`` collective, which both backends run on CPU and CUDA
tensors (gloo too: ``chip_smoke.py`` phase 9 runs ranks that share
``cuda:0`` over gloo and holds their steps against the one-rank step), so
nothing here copies through the host and nothing depends on the backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def gather_raw(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather`` without autograd: every rank's ``x`` (same shape)
    concatenated along ``dim`` in group-rank order."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter_raw(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group of ``x``, split into ``group_size`` equal
    slices along ``dim``: this rank's slice."""
    chunks = [c.contiguous() for c in x.detach().chunk(group_size(group), dim)]
    out = torch.empty_like(chunks[group_rank(group)])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.group, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled all_gather along ``dim``; its gradient is a summing
    reduce-scatter (see the module docstring)."""
    if not x.requires_grad:
        return gather_raw(x, group, dim)
    return _AllGather.apply(x, group, dim)


def psum_raw(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduction over the group (a copy of ``x``; no autograd)."""
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return psum_raw(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the gradient is the psum of the cotangents."""
    if not x.requires_grad:
        return psum_raw(x, group)
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group (no gradient)."""
    return psum_raw(x, group) / group_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Maximum over the group (no gradient)."""
    return psum_raw(x, group, op=dist.ReduceOp.MAX)


def psum_flat(tensors, group, scale: float = 1.0):
    """psum of a list of tensors in one collective (flattened into one
    buffer), each multiplied by ``scale``; returns new tensors."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i : i + t.numel()].view_as(t))
        i += t.numel()
    return out
