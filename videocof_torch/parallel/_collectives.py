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


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` of every rank i to rank (i + shift) mod S, over
    ``all_to_all_single`` with every split empty but the neighbour's."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    send = x.contiguous().reshape(-1)
    n = send.numel()
    recv_split = [0] * world           # what this rank receives from each
    send_split = [0] * world           # ... and sends to each
    recv_split[(rank - shift) % world] = n
    send_split[(rank + shift) % world] = n
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, recv_split, send_split, group=group)
    return recv.view_as(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.args = (group, shift)
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        group, shift = ctx.args
        return _shift(grad, group, -shift), None, None


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
    """The sum of the ranks' partial values. The backward is the identity,
    which is right only where every rank consumes the sum alike: the
    row-parallel output of tensor parallelism (Megatron's *g*), the
    pipeline's replicated output. A sum that each rank then uses for its
    own slice only (the q/k RMSNorm's sum of squares) takes
    `all_reduce_sum_both`."""
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*, at the input of every column-parallel linear: the
    identity forward, a backward that sums the gradient over ``group``
    (each rank's gradient is only its own output columns' share)."""
    return _CopyToGroup.apply(x, group)


def all_reduce_sum_both(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, whose backward sums the gradient too: for a
    sum each rank uses for its own slice only (the tensor-parallel q/k
    RMSNorm's sum of squares)."""
    return _AllReduceBoth.apply(x, group)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Every rank i of ``group`` sends ``x`` to rank (i + shift) mod S and
    returns what rank (i - shift) mod S sent (JAX's ``ppermute`` over a
    ring). One ``all_to_all_single`` with uneven splits (every split empty
    but the neighbour's), which gloo carries on CUDA tensors, as NCCL does.
    The backward is the reverse shift."""
    return _PPermute.apply(x, group, shift)
