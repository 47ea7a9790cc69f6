"""Expert-parallel weight residency for the Wan2.2 temporal MoE, on
`torch.distributed`.

Counterpart of `videocof_tpu/parallel/ep.py`. Wan2.2 routes by denoising
phase, not by token: at any step one expert is live, so what a placement
buys is residency. The experts' tensors are stacked on a leading expert
axis (`stack_experts`), rank r of an axis of n ranks keeps experts ``[r
E/n, (r+1) E/n)`` (`ep_param_shardings`), and `select_expert` materializes
expert k on every rank from its owner, once per phase switch.

The selected expert's tensors travel as their bytes (a ``uint8`` view; gloo
carries no float8) through one ``all_reduce`` in which every rank but the
owner contributes zeros, so the copy is exact bit for bit for every dtype,
fp8 weights and their fp32 scales included. It runs through
``torch.func.functional_call`` on a module of the expert's structure (JAX
has no pipeline caller, and the port adds none).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _padded(n: int) -> int:
    return -(-n // 16) * 16          # each tensor's bytes 16-byte aligned


def _stack(ts) -> torch.Tensor:
    if ts[0].dtype.itemsize == 1:           # fp8: stack the bytes
        return torch.stack([t.view(torch.uint8) for t in ts]).view(
            ts[0].dtype)
    return torch.stack(ts)


def stack_experts(*experts) -> Dict[str, torch.Tensor]:
    """{name: [E, ...]} of structurally identical experts (modules, whose
    parameters and buffers are taken, or state dicts)."""
    sds = [e.state_dict() if isinstance(e, nn.Module) else e
           for e in experts]
    keys = list(sds[0])
    for sd in sds[1:]:
        if list(sd) != keys:
            raise ValueError("experts differ in structure")
    return {k: _stack([sd[k] for sd in sds]) for k in keys}


@dataclasses.dataclass(eq=False)
class ExpertStack:
    """This rank's experts ``local`` ({name: [E/n, ...]}) of ``n_experts``,
    sharded over a group of ``size`` ranks in which this one is
    ``rank``."""
    local: Dict[str, torch.Tensor]
    n_experts: int
    group: object
    size: int
    rank: int


def ep_param_shardings(mesh: DeviceMesh, stacked: Mapping[str, torch.Tensor],
                       axis: str = "data") -> ExpertStack:
    """This rank's share of ``stacked`` (`stack_experts`): rank r of the
    ``axis`` ranks keeps experts ``[r E/n, (r+1) E/n)``, copied (the stack
    may be freed). JAX's ``inner`` (TP specs below the expert axis) has no
    counterpart: no caller composes EP with TP."""
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    E = next(iter(stacked.values())).shape[0]
    if E % n:
        raise ValueError(f"{E} experts % {n} ranks != 0")
    per = E // n
    local = {name: t[r * per:(r + 1) * per].clone()
             for name, t in stacked.items()}
    return ExpertStack(local, E, mesh.get_group(axis), n, r)


def select_expert(stack, index: int) -> Dict[str, torch.Tensor]:
    """Expert ``index``'s {name: tensor}, on every rank: from an
    `ExpertStack`, its owner's bytes through one all-reduce over the
    stack's group (every rank calls it); from a plain stack (`stack_
    experts`), the index taken."""
    if not isinstance(stack, ExpertStack):
        return {k: v[index] for k, v in stack.items()}
    per = stack.n_experts // stack.size
    owner, j = divmod(index, per)
    names = list(stack.local)
    metas = [(stack.local[k].shape[1:], stack.local[k].dtype) for k in names]
    sizes = [_as_bytes(stack.local[k][0]).numel() for k in names]
    room = [_padded(n) for n in sizes]
    flat = torch.zeros(sum(room), dtype=torch.uint8,
                       device=stack.local[names[0]].device)
    if stack.rank == owner:
        for k, part, n in zip(names, flat.split(room), sizes):
            part[:n] = _as_bytes(stack.local[k][j])
    dist.all_reduce(flat, group=stack.group)
    return {k: part[:n].view(dtype).view(shape)
            for k, (shape, dtype), part, n in zip(names, metas,
                                                  flat.split(room), sizes)}
