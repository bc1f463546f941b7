"""The explicit collectives of tensor parallelism, each a
`torch.autograd.Function` whose backward is the transposed collective.

Every activation on a rank is either replicated (the same value on every
rank of the `model` axis, and its gradient on each rank the full one) or
sharded (the rank's piece, and the piece's gradient). The four moves:

* `copy_to_model`   replicated → consumed by a column shard: identity
                    forward, all-reduce backward (each rank's gradient is
                    its columns' share);
* `reduce_from_model` partial sums → replicated: all-reduce forward,
                    identity backward;
* `gather_from_model` sharded → replicated along a dim: all-gather
                    forward, this rank's slice backward;
* `split_to_model`  replicated → sharded along a dim: this rank's slice
                    forward, all-gather backward.

Over the `data` axis, `sum_over_data` sums a statistic of each rank's
rows into the global batch's (the MoE load-balance loss's token counts
and router probabilities): all-reduce forward, all-reduce backward.

gloo takes CUDA tensors for `all_reduce` and `broadcast` only, so on a
gloo group (ranks sharing one card) `all_gather` is one broadcast a rank;
on nccl and for CPU tensors it is `dist.all_gather`. No collective copies
a CUDA tensor to the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        me = dist.get_rank(group)
        parts = []
        for i in range(n):
            buf = x if i == me else torch.empty_like(x)
            dist.broadcast(buf, src=dist.get_global_rank(group, i),
                           group=group)
            parts.append(buf)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: `x` reduced over the group (every rank gets the same
    bits)."""
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _slice(x, dim, group):
    n = dist.get_world_size(group)
    k = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * k, k).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _slice(dy, ctx.dim, ctx.group), None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.dim, ctx.group), None, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        # the transpose of a sum across ranks: every rank's output depends
        # on every rank's input, so each input's cotangent is the sum of
        # the ranks' output cotangents
        return all_reduce(dy, ctx.group), None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x, dim, group):
    return _GatherFromModel.apply(x, dim, group)


def split_to_model(x, dim, group):
    return _SplitToModel.apply(x, dim, group)


def sum_over_data(x, group):
    return _SumOverData.apply(x, group)
