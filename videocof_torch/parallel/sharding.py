"""Parameter sharding over the ``data`` axis (FSDP).

Counterpart of `videocof_tpu/parallel/sharding.py`. JAX states FSDP as a
sharding rule and lets pjit insert the all-gathers and reduce-scatters; the
reference wraps each transformer block in torch FSDP
(`videox_fun/dist/fsdp.py`, SURVEY.md §2.4). Here the rule picks each
parameter's sharded dim as JAX's does, and `apply_fsdp` hands it to FSDP2's
``fully_shard``, one unit per DiT block and one for the rest.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Shard

from .mesh import axis_size


def replicate(param: torch.Tensor) -> torch.Tensor:
    """A replicated parameter as it is: every rank holds all of it (JAX's
    ``P()`` sharding)."""
    return param


def fsdp_param_sharding(mesh: DeviceMesh, module: nn.Module,
                        axis: str = "data", min_size: int = 2 ** 16
                        ) -> Dict[str, Optional[int]]:
    """{parameter name: the dim sharded over ``axis``, or None}: a
    parameter of at least ``min_size`` elements shards its largest dim that
    divides by the axis size (ties: the later dim, as JAX's reversed
    argsort), every other one is replicated."""
    n = axis_size(mesh, axis)

    def rule(p: torch.Tensor) -> Optional[int]:
        if p.numel() < min_size or n == 1:
            return None
        dims = list(p.shape)
        for d in np.argsort(dims)[::-1]:
            if dims[d] % n == 0:
                return int(d)
        return None

    return {name: rule(p) for name, p in module.named_parameters()}


def apply_fsdp(module: nn.Module, mesh: DeviceMesh, axis: str = "data",
               min_size: int = 2 ** 16,
               dims: Optional[Dict[str, Optional[int]]] = None) -> nn.Module:
    """Shard ``module`` (a `WanDiT`) over ``axis`` with FSDP2, in place: each
    block is one ``fully_shard`` unit and the root another, each parameter
    ``Shard(dim)`` on the dim `fsdp_param_sharding` picks, or on the one
    ``dims`` ({name: dim or None}) gives; the parameters it
    replicates stay plain tensors outside FSDP (their gradients are
    reduced by the train step), and so do those of a dtype other than the
    one most of a unit's sharded elements have (FSDP2 takes one dtype of
    trained parameters a unit). Forward calls gather a block's weights and
    free them after it; the backward reduce-scatters the gradients
    (averaged over ``axis``). A no-op on an axis of size 1."""
    if axis_size(mesh, axis) == 1:
        return module
    if dims is None:
        dims = fsdp_param_sharding(mesh, module, axis, min_size)
    by_param = {p: dims[name] for name, p in module.named_parameters()}
    replicated = {p for p, d in by_param.items() if d is None}
    units = [set(b.parameters()) for b in module.blocks]
    in_blocks = set().union(*units)
    units.append({p for p in by_param if p not in in_blocks})
    for unit in units:
        # FSDP2 takes one dtype of trained parameters a unit: the others
        # (the fp32 time MLP beside bf16 weights) stay whole, as the small
        # ones do
        sizes: Dict[torch.dtype, int] = {}
        for p in unit - replicated:
            sizes[p.dtype] = sizes.get(p.dtype, 0) + p.numel()
        if len(sizes) > 1:
            keep = max(sizes, key=sizes.get)
            replicated |= {p for p in unit
                           if p.requires_grad and p.dtype != keep}
    sub = mesh[axis]

    def place(p):
        return Shard(by_param[p])

    for block in module.blocks:
        fully_shard(block, mesh=sub, shard_placement_fn=place,
                    ignored_params=replicated & set(block.parameters()))
    fully_shard(module, mesh=sub, shard_placement_fn=place,
                ignored_params=replicated)
    return module
