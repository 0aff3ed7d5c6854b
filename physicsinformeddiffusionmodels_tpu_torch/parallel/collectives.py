"""Collectives over a process group that autograd differentiates.

Every one is an ``all_reduce`` (sum or max): a gather writes the rank's
part into a zero-filled buffer of the whole and sums, which is exact
because the other ranks add zeros. One code path thus serves NCCL and gloo,
and gloo is the backend that takes CUDA tensors of two ranks on one card.
The gather moves twice the bytes of an ``all_gather_into_tensor``.

The backward of each depends on what the ranks do with the result:

- ``all_sum``: each rank's gradient of the sum is the share its own
  downstream work contributes, so the backward sums them (all-reduce).
- ``all_max``: the max-shift of a softmax statistic cancels in the softmax,
  so its gradient is zero (JAX's ``_pmax_stat``).
- ``gather(..., partial=False)``: every rank computes the same from the
  gathered tensor, so each holds the whole gradient and keeps its part.
- ``gather(..., partial=True)``: the ranks compute different things from it
  (each its own output channels), so their gradients are summed first and
  each keeps its part (a reduce-scatter).
- ``shard``: a rank keeps its part of a tensor every rank holds; the whole
  gradient is the parts of all ranks (the backward gathers).
- ``enter_partial``: the identity on a tensor that every rank holds, whose
  gradient each rank's different downstream work only contributes to (the
  backward sums).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _place(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A zero tensor of the whole (``x``'s size times the group's along
    ``dim``) with ``x`` at the rank's position."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * dist.get_world_size(group)
    whole = x.new_zeros(shape)
    whole.narrow(dim, dist.get_rank(group) * n, n).copy_(x)
    return whole


def rank_part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's contiguous part of ``x`` along ``dim``."""
    size = dist.get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {size} ranks")
    n = x.shape[dim] // size
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


def gather_tensor(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no autograd)."""
    whole = _place(x, dim, group)
    dist.all_reduce(whole, group=group)
    return whole


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return torch.zeros_like(dy), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        return gather_tensor(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, dy):
        if ctx.partial:
            dy = dy.contiguous().clone()
            dist.all_reduce(dy, group=ctx.group)
        return rank_part(dy, ctx.dim, ctx.group), None, None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return rank_part(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return gather_tensor(dy.contiguous(), ctx.dim, ctx.group), None, None


class _EnterPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x``; its backward sums the ranks' gradients."""
    return _Sum.apply(x, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of the ranks' ``x``, with a zero gradient."""
    return _Max.apply(x, group)


def gather(x: torch.Tensor, dim: int, group, partial: bool) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``. ``partial``: the ranks'
    gradients of the result are summed before each keeps its part."""
    return _Gather.apply(x, dim, group, partial)


def shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's contiguous part along ``dim`` of an ``x`` every rank holds;
    the backward gathers the parts' gradients."""
    return _Shard.apply(x, dim, group)


def enter_partial(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; the backward sums the ranks' gradients."""
    return _EnterPartial.apply(x, group)
