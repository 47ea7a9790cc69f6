"""Ulysses sequence-parallel attention on `torch.distributed`.

Counterpart of `videocof_tpu/parallel/ulysses.py` and of the reference's
xfuser ``xFuserLongContextAttention`` (`videox_fun/dist/wan_xfuser.py:68-111`):
tokens arrive sharded [B, L/sp, N, D] over the ``seq`` ranks, an
all-to-all re-shards them to [B, L, N/sp, D] (the whole sequence, the heads
split), attention runs locally, and a second all-to-all restores token
sharding. Both all-to-alls are differentiable (`_collectives.all_to_all`),
so the training step's backward runs through them.

RoPE, the CoF segment restarts included, is applied to q and k before this
function on per-token position data, so sequence parallelism composes with
chain-of-frames editing (the reference's USP forward drops
`frame_split_indices`, `dist/wan_xfuser.py:68-74`).
"""

from __future__ import annotations

from typing import Callable, Optional

from torch.distributed.device_mesh import DeviceMesh

from ..ops.attention import attention
from ._collectives import all_to_all
from .mesh import axis_size
from .sp import pad_tokens_for_sp  # noqa: F401  (re-export, as in JAX)


def make_ulysses_attention(mesh: DeviceMesh, seq_axis: str = "seq",
                           inner_backend: Optional[str] = None) -> Callable:
    """Returns ``attn(q, k, v, mask=None)`` on this rank's LOCAL shards
    [B, L/sp, N, D] (JAX's takes logically global arrays and shards them
    itself); N must divide by the seq-axis size. ``mask`` is the global
    boolean key mask [B, L] (True = attend), which every rank holds whole:
    after the first all-to-all the keys are the whole sequence, so it
    applies as it is. The local attention is `ops.attention.attention` with
    ``inner_backend`` (kernel B1 on CUDA; B2 and B3 under autograd). JAX's
    ``batch_axis`` (the CFG-parallel batch split) has no counterpart: the
    rows a rank is given are already its own."""
    group = mesh.get_group(seq_axis)
    sp = axis_size(mesh, seq_axis)

    def attn(q, k, v, mask=None):
        B, Ls, N, D = q.shape
        assert N % sp == 0, f"heads {N} not divisible by sp={sp}"
        if sp == 1:
            return attention(q, k, v, mask=mask, backend=inner_backend)
        if mask is not None:
            assert mask.shape == (B, Ls * sp), (tuple(mask.shape), B, Ls * sp)
        # [B, L/sp, N, D] -> [B, L, N/sp, D]
        q_, k_, v_ = (all_to_all(t, group, scatter_dim=2, gather_dim=1)
                      for t in (q, k, v))
        o = attention(q_, k_, v_, mask=mask, backend=inner_backend)
        return all_to_all(o, group, scatter_dim=1, gather_dim=2)

    return attn
