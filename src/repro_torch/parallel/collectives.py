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
and router probabilities): all-reduce forward, all-reduce backward. Under
FSDP (a config's leaves cut over `data` too), `gather_from_data` makes a
rank's piece of a weight whole over the axis for the layer that reads it:
all-gather forward, reduce-scatter (SUM) backward, so each rank keeps its
piece of the gradient summed over the data ranks' rows;
`lookup_over_data` looks rows up in a table whose columns are cut over
`data` without making it whole (the embedding).

gloo takes CUDA tensors for `all_reduce` and `broadcast` only, so on a
gloo group (ranks sharing one card) `all_gather` is one broadcast a rank;
on nccl and for CPU tensors it is `dist.all_gather`. gloo has no
reduce-scatter: there `reduce_scatter` all-reduces each rank's slice in
turn and keeps its own; on nccl it is `dist.reduce_scatter_tensor`. No
collective copies a CUDA tensor to the host, and none catches a failure:
a collective that fails raises.

Each collective tells the active cost counters (`core/tally.py`) its
class, as the nccl path issues it (a reduce-scatter is one whatever the
backend runs), and its payload, the largest tensor of the op: the
gathered output, the reduced tensor, the reduce-scatter's input.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import tally


def _nbytes(x, dtype=None) -> int:
    return x.numel() * (x.element_size() if dtype is None else
                        torch.empty((), dtype=dtype).element_size())


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    tally.collective("all-gather", n * _nbytes(x))
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
    return all_reduce_(x.clone(), group, op)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """`x` reduced over the group in place, and returned."""
    tally.collective("all-reduce", _nbytes(x))
    dist.all_reduce(x, op=op, group=group)
    return x


def _slice(x, dim, group):
    n = dist.get_world_size(group)
    k = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * k, k).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group,
                   dtype=None) -> torch.Tensor:
    """This rank's slice along `dim` (group-rank order) of `x` summed over
    the group, in `dtype` (default `x`'s; the cast made a slice at a
    time): the transpose of `all_gather`."""
    n = dist.get_world_size(group)
    dtype = dtype or x.dtype
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    if n == 1:
        return x.to(dtype)
    tally.collective("reduce-scatter", _nbytes(x, dtype))
    if dist.get_backend(group) != "nccl":
        # an all-reduce a rank's slice, keeping this rank's: the same sums
        # as one all-reduce of `x`, with one slice's copy at a time
        me = dist.get_rank(group)
        out = None
        for i, part in enumerate(x.chunk(n, dim)):
            y = part.to(dtype, memory_format=torch.contiguous_format,
                        copy=True)
            dist.all_reduce(y, group=group)
            if i == me:
                out = y
        return out
    xt = x.movedim(dim, 0).to(dtype, memory_format=torch.contiguous_format)
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


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


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, dtype):
        ctx.dim, ctx.group, ctx.dtype = dim, group, x.dtype
        return all_gather(x if dtype is None else x.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, dy):
        # the cotangent in the piece's type (fp32 for the masters) before
        # the sum over the ranks, as the replicated step's cast and
        # all-reduce take it
        return (reduce_scatter(dy, ctx.dim, ctx.group, ctx.dtype), None,
                None, None)


class _LookupOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, group):
        me = dist.get_rank(group)
        every = all_gather(idx[None], 0, group)      # each rank's indices
        ctx.save_for_backward(every)
        ctx.group, ctx.shape = group, table.shape
        # this rank's columns of every rank's rows, gathered along the
        # columns: each rank's rows whole
        return all_gather(table[every], -1, group)[me]

    @staticmethod
    def backward(ctx, dy):
        every, = ctx.saved_tensors
        me, n = dist.get_rank(ctx.group), ctx.shape[-1]
        # every rank's cotangents on this rank's columns, each rank's
        # scattered as its lookup's backward scatters them, the ranks'
        # sums then added in rank order (the data all-reduce's two
        # addends, for two ranks)
        dy = all_gather(dy.contiguous()[None], 0, ctx.group)[
            ..., me * n:(me + 1) * n]
        out = None
        for r in range(dy.shape[0]):
            g = torch.zeros(ctx.shape, dtype=dy.dtype, device=dy.device)
            g.index_put_((every[r],), dy[r], accumulate=True)
            out = g if out is None else out.add_(g)
        return out, None, None


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


def gather_from_data(x, dim, group, dtype=None):
    """`x` (a rank's piece of a weight cut along `dim` over the data axis)
    whole, cast to `dtype` first where given (half the bytes for a bf16
    forward; the same bits as casting the whole). The backward casts the
    cotangent to `x`'s type and reduce-scatters it."""
    return _GatherFromData.apply(x, dim, group, dtype)


def lookup_over_data(table, idx, group):
    """`table[idx]` for a table whose columns (its last dim) are cut over
    the data axis, each rank's rows whole, without the whole table on any
    rank: every rank looks up its columns of all the ranks' rows, and the
    columns are gathered. The backward scatters every rank's cotangents
    into this rank's columns and sums them, the transpose."""
    return _LookupOverData.apply(table, idx, group)
