"""Sequence, CFG and data parallelism on `torch.distributed` (counterpart of
`videocof_tpu/parallel/`; tensor, pipeline and expert parallelism are not
ported yet, ROADMAP.md §A.2)."""

from .mesh import make_mesh, rank_device
from .ring import make_ring_attention
from .sharding import apply_fsdp, fsdp_param_sharding, replicate
from .sp import (SPContext, joint_pad_masks, pad_rope_tables, pad_stream,
                 pad_tokens_for_sp, rank_major_mask)
from .ulysses import make_ulysses_attention

__all__ = ["make_mesh", "rank_device", "make_ulysses_attention",
           "make_ring_attention", "pad_tokens_for_sp", "pad_stream",
           "pad_rope_tables", "joint_pad_masks", "rank_major_mask", "SPContext",
           "fsdp_param_sharding", "apply_fsdp", "replicate"]
