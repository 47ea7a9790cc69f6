"""Sequence, CFG, data, tensor, pipeline and expert parallelism on
`torch.distributed` (counterpart of `videocof_tpu/parallel/`)."""

from .ep import ep_param_shardings, select_expert, stack_experts
from .mesh import make_mesh, rank_device
from .pp import pp_param_shardings, pp_scan_blocks
from .ring import make_ring_attention
from .sharding import apply_fsdp, fsdp_param_sharding, replicate
from .sp import (SPContext, joint_pad_masks, pad_rope_tables, pad_stream,
                 pad_tokens_for_sp, rank_major_mask)
from .tp import (apply_tp, make_tp_attention, tp_fsdp_param_shardings,
                 tp_param_shardings, validate_tp)
from .ulysses import make_ulysses_attention

__all__ = ["make_mesh", "rank_device", "make_ulysses_attention",
           "make_ring_attention", "pad_tokens_for_sp", "pad_stream",
           "pad_rope_tables", "joint_pad_masks", "rank_major_mask", "SPContext",
           "fsdp_param_sharding", "apply_fsdp", "replicate",
           "make_tp_attention", "tp_param_shardings", "validate_tp",
           "apply_tp", "tp_fsdp_param_shardings", "pp_param_shardings",
           "pp_scan_blocks", "ep_param_shardings", "select_expert",
           "stack_experts"]
