"""Ring attention on `torch.distributed`.

Counterpart of `videocof_tpu/parallel/ring.py` (the reference delegates ring
KV rotation to xfuser's NCCL P2P, `dist/fuser.py:46-49`). Tokens stay
sharded [B, L/sp, N, D]; the K/V shards (and the key mask's) rotate around
the seq ranks with `batch_isend_irecv` while each rank folds the shard it
holds into its queries' partial result: O(L/sp) memory per rank and
neighbour traffic only, the shape for the 4x length-extrapolation edit,
where Ulysses would still hold full-length K/V on every rank.

At a head dim that is a multiple of 128 each rotated shard runs through
kernel B2 (`ops.flash_attention.flash_attention_with_lse`) and the (out,
LSE) pairs merge with the blockwise log-sum-exp combine in fp32; other head
dims run an fp32 einsum online softmax with the same semantics (JAX's own
dispatch). Inference only, as JAX's trainers use Ulysses.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.flash_attention import flash_attention_with_lse
from .mesh import axis_size

NEG = torch.finfo(torch.float32).min


def _combine(o1, lse1, o2, lse2):
    """Merge two normalized partial attentions [B, Lq, N, D] with their
    log-sum-exps [B, Lq, N, 1], in fp32."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    o = (o1 * w1 + o2.float() * w2) / denom
    return o, m + torch.log(denom)


def make_ring_attention(mesh: DeviceMesh, seq_axis: str = "seq",
                        scale: Optional[float] = None,
                        model_axis: Optional[str] = None) -> Callable:
    """Returns ``attn(q, k, v, mask=None)`` on this rank's LOCAL shards
    [B, L/sp, N, D] (JAX's takes logically global arrays). ``mask`` is the
    global boolean key mask [B, L] (every rank holds it whole); this rank's
    shard of it rotates with the K/V shards. JAX's ``batch_axis`` has no
    counterpart: the rows a rank is given are already its own (CFG
    parallelism).

    ``model_axis`` (tensor parallelism): the heads a rank is given are its
    own model shard's [B, L/sp, N/tp, D], and the K/V shards rotate over
    the ``seq`` ranks of this rank's model coordinate (the seq group the
    mesh gives this rank), so the ring needs nothing more than the axis'
    presence in the mesh."""
    if model_axis is not None:
        axis_size(mesh, model_axis)          # KeyError for a missing axis
    group = mesh.get_group(seq_axis)
    sp = axis_size(mesh, seq_axis)
    rank = mesh.get_local_rank(seq_axis)
    send_to = dist.get_global_rank(group, (rank + 1) % sp)
    recv_from = dist.get_global_rank(group, (rank - 1) % sp)

    def rotate(blocks):
        """Each tensor of ``blocks`` to seq rank + 1, from seq rank - 1."""
        got = [torch.empty_like(t) for t in blocks]
        ops = []
        for t, r in zip(blocks, got):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), send_to, group))
            ops.append(dist.P2POp(dist.irecv, r, recv_from, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def ring(blocks, fold, state):
        for step in range(sp):
            state = fold(state, *blocks)
            if step + 1 < sp:
                blocks = rotate(blocks)
        return state

    def inner_kernel(q, k, v, mask):
        """B2 per rotated shard + the blockwise LSE combine."""
        B, Lq, N, D = q.shape
        sc = D ** -0.5 if scale is None else scale

        def fold(state, k_blk, v_blk, *m_blk):
            o_b, lse_b = flash_attention_with_lse(
                q, k_blk, v_blk, kv_mask=m_blk[0] if m_blk else None,
                scale=sc)
            return _combine(*state, o_b, lse_b)

        o0 = torch.zeros((B, Lq, N, D), dtype=torch.float32, device=q.device)
        lse0 = torch.full((B, Lq, N, 1), NEG, dtype=torch.float32,
                          device=q.device)
        blocks = [k, v] + ([] if mask is None else [mask])
        o, _ = ring(blocks, fold, (o0, lse0))
        return o.to(q.dtype)

    def inner_einsum(q, k, v, mask):
        """fp32 einsum online softmax (head_dim % 128 != 0)."""
        B, Lq, N, D = q.shape
        sc = D ** -0.5 if scale is None else scale
        qf = q.float()

        def fold(state, k_blk, v_blk, *m_blk):
            acc, m, l = state
            s = torch.einsum("bqnd,bknd->bqnk", qf, k_blk.float()) * sc
            if m_blk:
                s = torch.where(m_blk[0][:, None, None, :], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            acc = acc * alpha + torch.einsum("bqnk,bknd->bqnd", p,
                                             v_blk.float())
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            return acc, m_new, l

        acc0 = torch.zeros((B, Lq, N, D), dtype=torch.float32,
                           device=q.device)
        m0 = torch.full((B, Lq, N, 1), NEG, dtype=torch.float32,
                        device=q.device)
        l0 = torch.zeros((B, Lq, N, 1), dtype=torch.float32, device=q.device)
        blocks = [k, v] + ([] if mask is None else [mask])
        acc, _, l = ring(blocks, fold, (acc0, m0, l0))
        return (acc / l).to(q.dtype)

    def attn(q, k, v, mask=None):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError("ring attention is an inference path "
                                      "(the trainers use Ulysses)")
        B, Ls = q.shape[:2]
        if mask is not None:
            assert mask.shape == (B, Ls * sp), (tuple(mask.shape), B, Ls * sp)
            mask = mask.bool().chunk(sp, dim=1)[rank].contiguous()
        inner = inner_kernel if q.shape[3] % 128 == 0 else inner_einsum
        return inner(q, k, v, mask)

    return attn
