"""A batch's rows sharded over the ranks of a ``data`` axis, where the loss
couples them.

The JAX package trains data-parallel by constraining the batch to the
``data`` axis (``constrain_batch``) inside one jit, so XLA computes every
cross-row quantity over the global batch: a BatchNorm layer's batch
moments and a causal loss's ``[B, B]`` weights. Here each rank is a process
holding its own rows, so those two gather the rows of every rank
themselves. The data-parallel step (``train.trainer.make_train_step`` on a
mesh whose ``data`` axis has more than one rank) runs its loss, backward
and running-statistics refresh inside :func:`sharded_rows`; outside it
(no mesh, one rank, a population) every function here is the identity and
puts no collective on the path, so a one-rank run keeps its bits.

:func:`all_rows` is differentiable: its backward sums each rank's
gradient of the gathered rows and hands every rank its own slice, through
an all-reduce that is differentiable in turn, so it sits inside the
derivative taps of a BatchNorm net (second order, ``create_graph=True``)
and under the loss's backward. Every rank calls it at the same points of
the same program, so the ranks enter the same collectives in the same
order.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist

_SHARDS = contextvars.ContextVar("sharded_rows", default=None)


@contextlib.contextmanager
def sharded_rows(group, rank: int, size: int):
    """Inside the block, the batch's rows are sharded in equal parts over
    the ``size`` ranks of ``group``, this rank holding part ``rank``; a
    ``size`` of 1 changes nothing."""
    token = _SHARDS.set((group, rank, size) if size > 1 else None)
    try:
        yield
    finally:
        _SHARDS.reset(token)


def row_count(n: int) -> int:
    """The global batch's row count of a shard of ``n`` rows."""
    shards = _SHARDS.get()
    return n if shards is None else n * shards[2]


def all_rows(x):
    """The rows of every rank's ``x`` joined along dim 0 in rank order (the
    global batch), differentiable; ``x`` itself outside
    :func:`sharded_rows`."""
    shards = _SHARDS.get()
    if shards is None:
        return x
    return _AllRows.apply(x, *shards)


class _AllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        total = _SumOverRanks.apply(grad, ctx.group)
        lo = ctx.rank * ctx.rows
        return total[lo:lo + ctx.rows], None, None, None


class _SumOverRanks(torch.autograd.Function):
    """The sum of every rank's tensor; its adjoint is itself."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad, ctx.group), None
