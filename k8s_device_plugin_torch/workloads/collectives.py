"""Differentiable collectives for the port's meshes.

JAX differentiates a sharded program as one global program: it transposes
each collective itself (``ppermute`` into the inverse ``ppermute``,
``all_to_all`` into the reverse ``all_to_all``, ``psum`` into a
broadcast). In PyTorch every rank runs its own program and back-propagates
its own share of the loss, so each collective here is a
``torch.autograd.Function`` whose backward is that transpose under this
convention: a rank's cotangents are its own share, and a cotangent that
several ranks' shares feed is summed over them.

* :func:`ring_shift` sends to the next rank of ``group`` and receives from
  the previous one; its backward shifts the cotangent the other way round.
* :func:`all_to_all` exchanges chunk ``j`` of dim 0 with rank ``j``; it is
  its own transpose.
* :func:`all_reduce_sum` sums over ``group``; its backward sums the
  cotangents (every rank's share of the loss reads the sum).
* :func:`reduce_loss` sums each rank's share of a loss into the global
  value; its backward passes each rank's cotangent to its own share.
* :func:`copy_to` and :func:`gather_from` enter and leave a layer whose
  output features are split over ``group`` (Megatron's column-parallel
  pair, what DTensor's ``ColwiseParallel(output_layouts=Replicate())``
  does): the identity and an all-reduce of the cotangent, then an
  all-gather and the rank's own slice of the cotangent.

Plain ``torch.distributed`` calls, so the same code runs on gloo (CPU
ranks) and NCCL (one rank per card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` from rank r - step of ``group`` to rank r (a cyclic shift)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    rank = dist.get_rank(group)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (rank + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (rank - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's ``x`` lands on rank r + 1 of ``group`` (``lax.ppermute``
    over the ring ``i -> i + 1``)."""
    return _RingShift.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n, ...]: chunk j goes to rank j, and chunk j of the result
    came from rank j."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim 0 is {x.shape[0]}, the group "
                         f"has {dist.get_world_size(group)} ranks")
    return _AllToAll.apply(x, group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, read by every rank's share of the
    loss (so the cotangents are summed too)."""
    return _AllReduceSum.apply(x, group)


class _ReduceLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_loss(share: torch.Tensor, group=None) -> torch.Tensor:
    """The global loss from each rank's ``share`` of it (a sum over
    ``group``, default the world); differentiating it on a rank
    differentiates that rank's share, so the parameters' gradients must
    then be summed over the ranks (:func:`sum_grads`)."""
    return _ReduceLoss.apply(share, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering a layer split over ``group``: each
    rank's cotangent covers its slice of the outputs only, so they are
    summed."""
    return _CopyTo.apply(x, group)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The slices of ``dim`` that the ranks of ``group`` computed, joined
    in rank order; the computation after it is replicated, so each rank
    keeps the cotangent of its own slice."""
    return _GatherFrom.apply(x, group, dim)


@torch.no_grad()
def sum_grads(params, group=None, average: bool = False) -> None:
    """Sum (or average) the gradients of ``params`` over ``group`` (default
    the world), in place: the gradient of a parameter replicated on ranks
    that each differentiated their own share of the loss."""
    n = dist.get_world_size(group)
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)
            if average:
                p.grad.div_(n)
