"""Whole-forward sequence-parallel context.

Counterpart of `videocof_tpu/parallel/sp.py`. The reference chunks the
whole token stream across ranks right after the patch embedding and
all-gathers after the head (`wan_transformer3d.py:949-953, 1085-1086`), so
the FFN, projections, AdaLN and head scale with the sequence-parallel
degree, not only attention. JAX states that sharding as GSPMD constraints;
here each rank holds only its own shard: `SPContext` cuts the stream, the
RoPE tables and the per-sample tensors to this rank's part, and `gather`
is the head-exit all-gather (differentiable, `_collectives.gather_tokens`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ._collectives import gather_tokens
from .mesh import axis_size


def pad_tokens_for_sp(L: int, sp: int) -> int:
    """Sequence length rounded up to a multiple of the seq axis (the
    reference rounds seq_len the same way, `wan_transformer3d.py:904-905`)."""
    return ((L + sp - 1) // sp) * sp


@dataclasses.dataclass(frozen=True, eq=False)
class SPContext:
    mesh: DeviceMesh
    axis: str = "seq"
    data_axis: str = "data"
    # CFG parallelism (reference `dist/fuser.py:35-49`): the doubled
    # cond/uncond batch splits over the data axis, so each data rank runs
    # ONE guidance branch. The pipeline turns it on for the steps whose
    # batch carries both branches.
    cfg_parallel: bool = False

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.axis)

    @property
    def rank(self) -> int:
        return self.mesh.get_local_rank(self.axis)

    @property
    def data_size(self) -> int:
        return axis_size(self.mesh, self.data_axis)

    @property
    def data_rank(self) -> int:
        return self.mesh.get_local_rank(self.data_axis)

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    @property
    def data_group(self):
        return self.mesh.get_group(self.data_axis)

    def with_cfg_parallel(self) -> "SPContext":
        return dataclasses.replace(self, cfg_parallel=True)

    def padded_len(self, L: int) -> int:
        return pad_tokens_for_sp(L, self.size)

    # -- this rank's shards ----------------------------------------------
    def shard_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[2B, ...] -> this data rank's contiguous rows (CFG parallelism:
        one guidance branch per data rank)."""
        if x.shape[0] % self.data_size:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"{self.data_size} data ranks")
        return x.chunk(self.data_size, dim=0)[self.data_rank]

    def shard_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, ...] -> this rank's contiguous L/sp tokens (and, under CFG
        parallelism, its batch rows)."""
        if x.shape[1] % self.size:
            raise ValueError(f"{x.shape[1]} tokens do not divide over "
                             f"{self.size} ranks (pad first)")
        x = x.chunk(self.size, dim=1)[self.rank]
        return self.shard_batch(x) if self.cfg_parallel else x

    def shard_rope(self, x: torch.Tensor) -> torch.Tensor:
        """[L, D/2] RoPE table -> this rank's rows (they go with its
        tokens)."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} positions do not divide over "
                             f"{self.size} ranks (pad first)")
        return x.chunk(self.size, dim=0)[self.rank]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The head-exit all-gather: [B, L/sp, ...] -> [B, L, ...] over the
        seq ranks, and under CFG parallelism the batch rows over the data
        ranks too."""
        if self.size > 1:
            x = gather_tokens(x, self.group, dim=1)
        return self.gather_batch(x) if self.cfg_parallel else x

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' batch rows, all-gathered in rank order (the
        inverse of `shard_batch`)."""
        return gather_tokens(x, self.data_group, dim=0)


# ---------------------------------------------------------- joint-stream SP
# The image/video families (CogVideoX, Flux, QwenImage) run a JOINT
# text+image sequence through every block. Recipe: pad EACH stream to a
# multiple of the seq axis (so both the per-stream residuals and their
# concatenation divide), shard both streams, and key-mask the pad slots out
# of every softmax.

def pad_stream(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the token axis (axis 1) of [B, L, D] up to a multiple of
    ``mult``."""
    L = x.shape[1]
    Lp = pad_tokens_for_sp(L, mult)
    return x if Lp == L else F.pad(x, (0, 0, 0, Lp - L))


def pad_rope_tables(cos: torch.Tensor, sin: torch.Tensor, new_len: int):
    """Pad [L, c] cos/sin tables with identity rotations (cos 1, sin 0)."""
    pad = new_len - cos.shape[0]
    if pad <= 0:
        return cos, sin
    return (F.pad(cos, (0, 0, 0, pad), value=1.0), F.pad(sin, (0, 0, 0, pad)))


def joint_pad_masks(B: int, lt_real, lt_pad: int, li_real: int, li_pad: int
                    ) -> torch.Tensor:
    """Joint [B, lt_pad + li_pad] key mask (True = real token). ``lt_real``
    may be an int or a [B, lt] tensor (ragged text lengths, QwenImage's
    encoder_hidden_states_mask)."""
    if isinstance(lt_real, torch.Tensor) and lt_real.dim() >= 2:
        tmask = F.pad(lt_real.bool(), (0, lt_pad - lt_real.shape[1]))
        device = lt_real.device
    else:
        device = lt_real.device if isinstance(lt_real, torch.Tensor) else None
        if isinstance(lt_real, torch.Tensor) and lt_real.dim() == 1:
            lt_real = lt_real[:, None]
        tmask = (torch.arange(lt_pad, device=device) < lt_real).expand(
            B, lt_pad)
    imask = (torch.arange(li_pad, device=device) < li_real).expand(B, li_pad)
    return torch.cat([tmask, imask], dim=1)


def rank_major_mask(mask: torch.Tensor, lt_pad: int, size: int
                    ) -> torch.Tensor:
    """A joint key mask [B, lt_pad + li_pad] (text first, each stream padded
    to the seq axis) in the order the keys take in the port's parallel
    attention: each rank concatenates ITS text shard and ITS image shard,
    so the gathered keys run rank by rank, [text_0 | image_0 | text_1 |
    image_1 | ...] (JAX concatenates the logical streams instead, and
    needs no reordering)."""
    t = mask[:, :lt_pad].chunk(size, dim=1)
    i = mask[:, lt_pad:].chunk(size, dim=1)
    return torch.cat([part for pair in zip(t, i) for part in pair], dim=1)
