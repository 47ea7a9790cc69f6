"""The collectives a gradient passes through, as autograd Functions.

JAX states token sharding as annotations and XLA inserts the collectives
with their transposes; here every rank holds only its own shard and each
collective is written out with its backward. Each Function takes the
`ProcessGroup` it runs in and leaves its tensors on their own device
(NCCL on CUDA; gloo carries these collectives on the CPU and on CUDA
tensors too).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _a2a(x: torch.Tensor, group, scatter_dim: int, gather_dim: int
         ) -> torch.Tensor:
    """Split ``x`` into ``world`` chunks on ``scatter_dim``, send chunk j to
    rank j, and concatenate the chunks received on ``gather_dim`` in rank
    order."""
    world = dist.get_world_size(group)
    if x.shape[scatter_dim] % world:
        raise ValueError(f"dim {scatter_dim} of {tuple(x.shape)} does not "
                         f"divide by the group's {world} ranks")
    send = torch.stack(x.chunk(world, dim=scatter_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=gather_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.args = (group, scatter_dim, gather_dim)
        return _a2a(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, grad):
        group, scatter_dim, gather_dim = ctx.args
        return _a2a(grad, group, gather_dim, scatter_dim), None, None, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        world = dist.get_world_size(group)
        ctx.args = (group, dim, x.shape[dim])
        lead = x.movedim(dim, 0).contiguous()
        out = lead.new_empty((world * lead.shape[0], *lead.shape[1:]))
        dist.all_gather_into_tensor(out, lead, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim, n = ctx.args
        rank = dist.get_rank(group)
        return grad.narrow(dim, rank * n, n).contiguous(), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_to_all(x: torch.Tensor, group, scatter_dim: int, gather_dim: int
               ) -> torch.Tensor:
    """All-to-all over ``group``: ``x``'s dim ``scatter_dim`` is split over
    the ranks, their pieces concatenated on ``gather_dim`` (Ulysses' heads
    <-> tokens). The backward is the reverse all-to-all."""
    return _AllToAll.apply(x, group, scatter_dim, gather_dim)


def gather_tokens(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """All-gather of the ranks' equal shards on ``dim``, in rank order. The
    backward returns this rank's slice of the incoming gradient: the
    gathered value feeds a computation every rank repeats alike, so each
    rank's slice is its whole gradient."""
    return _GatherTokens.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial values. The backward is the identity:
    the sum feeds a computation every rank repeats alike."""
    return _AllReduceSum.apply(x, group)
