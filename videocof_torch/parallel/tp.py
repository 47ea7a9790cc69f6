"""Megatron tensor parallelism on `torch.distributed`.

Counterpart of `videocof_tpu/parallel/tp.py`. Each block's attention heads
and FFN hidden dim are split over the mesh's ``model`` ranks, so weights and
per-layer activations scale down with the TP degree. JAX places the
parameters with column/row shardings and lets XLA insert the collectives;
here every rank holds only its own slice (`apply_tp` cuts the parameters in
place) and the forwards of the DiTs call the collectives themselves, through
the `TPContext` that `apply_tp` attaches to each block: Megatron's *f*
(identity forward, gradient all-reduce) at the input of every
column-parallel linear, *g* (the all-reduce of the row-parallel partial
products in fp32, identity backward) at ``o``, ``fc2``, ``add_o`` and
``proj_out``, whose bias is added once after the reduce.

The rules by parameter name follow JAX's ``_spec_for`` table; torch's
linear weights are [out, in], so a column-parallel weight is cut on dim 0
(with its bias) and a row-parallel one on dim 1 (its bias whole):

    blocks / blocks2 / single_blocks only (embeddings, head, time MLP whole)
    q, k, v, k_img, v_img, fc1, add_q/k/v, proj_mlp     column
    o, fc2, add_o, proj_out                             row
    norm_q/k (Wan: over the whole dim)                  follow the column
    norm_* under ``attn`` (Flux, Qwen: per head dim)    whole
    ``lin`` of img_mod, txt_mod, norm1, norm1_context,  column (the output
      norm, norm2 (the image families' AdaLN)           all-gathered before
                                                        it is chunked)

Departures: the shardings are ``{parameter name: dim or None}`` (the
port's convention, `sharding.fsdp_param_sharding`), the attention takes
local shards, and Flux's single-block ``proj_out`` ([d, 5d], row) keeps
the rows that meet this rank's [attention | MLP] features,
``[r d/tp, (r+1) d/tp) u [d + r 4d/tp, d + (r+1) 4d/tp)``, where JAX's
contiguous in-dim spec holds the same number of rows a rank; CogVideoX's
``norm2.lin`` is cut as ``norm1.lin`` is, where JAX's table keeps it whole.
fp8 weights are cut after quantization and keep the whole tensor's
scale.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..ops.attention import attention
from ._collectives import (all_reduce_sum, all_reduce_sum_both,
                           copy_to_group, gather_tokens)
from .mesh import axis_size

_COLUMN = ("q", "k", "v", "k_img", "v_img", "fc1",
           "add_q", "add_k", "add_v", "proj_mlp")
_ROW = ("o", "fc2", "add_o", "proj_out")
_NORM_FOLLOW = ("norm_q", "norm_k", "norm_k_img",
                "norm_added_q", "norm_added_k")
# JAX's table names norm1 but not CogVideoX's norm2 (its test's docstring
# names both): the port cuts both of CogVideoX's AdaLN linears
_ADALN_PARENTS = ("img_mod", "txt_mod", "norm1", "norm1_context", "norm",
                  "norm2")
_BLOCK_STACKS = frozenset(("blocks", "blocks2", "single_blocks"))
# the row-parallel partial products are summed in fp32: the safer rounding
# at any TP degree, and under gloo on the card faster than bf16 (its bf16
# sums moved half the bytes at under half the rate)
REDUCE_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True, eq=False)
class TPContext:
    """This rank's place on the ``model`` axis and the collectives a
    tensor-parallel block calls (`apply_tp` sets it as ``block.tp``)."""
    group: object
    size: int
    rank: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *f*, before a column-parallel linear."""
        return copy_to_group(x, self.group)

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """Megatron's *g*: the row-parallel partial products summed in
        ``REDUCE_DTYPE``."""
        return all_reduce_sum(partial.to(REDUCE_DTYPE), self.group)

    def sum_sq(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial sums of squares (the q/k RMSNorm
        over the whole dim), its backward a sum too."""
        return all_reduce_sum_both(x, self.group)

    def gather_cols(self, y: torch.Tensor) -> torch.Tensor:
        """A column-parallel output [..., n/tp] all-gathered to [..., n]
        in rank order (its backward: this rank's slice)."""
        return gather_tokens(y, self.group, dim=y.dim() - 1)

    def slice_adapter(self, name: str, up: torch.Tensor, down: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A LoRA adapter (up [dout, r], down [r, din]) of the linear
        ``name``, cut as its base weight: up's rows for a column-parallel
        linear, down's columns for a row-parallel one."""
        if name in _COLUMN:
            up = _narrow(up, 0, self.size, self.rank)
        elif name in _ROW:
            down = _narrow(down, 1, self.size, self.rank)
        return up, down


def _narrow(t: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {size} model ranks")
    return t.narrow(dim, rank * (n // size), n // size)


def _is_split_rows(name: str) -> bool:
    """Flux's single-block ``proj_out`` weight, which contracts
    ``cat([attention, MLP])``."""
    parts = name.split(".")
    return parts[0] == "single_blocks" and parts[-2:] == ["proj_out",
                                                          "weight"]


def shard_param(name: str, t: torch.Tensor, dim: Optional[int], size: int,
                rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the parameter ``name`` (``dim`` from
    `tp_param_shardings`); the whole tensor for ``dim`` None."""
    if dim is None or size == 1:
        return t
    if _is_split_rows(name):
        d = t.shape[1] // 5
        parts = (_narrow(t.narrow(1, 0, d), 1, size, rank),
                 _narrow(t.narrow(1, d, 4 * d), 1, size, rank))
        if t.dtype.itemsize == 1:           # fp8: cat the bytes
            return torch.cat([p.view(torch.uint8) for p in parts],
                             dim=1).view(t.dtype)
        return torch.cat(parts, dim=1)
    return _narrow(t, dim, size, rank)


def unshard_param(name: str, shards, dim: Optional[int]) -> torch.Tensor:
    """The whole parameter ``name`` from every model rank's shard in rank
    order (``shards``): the inverse of `shard_param`."""
    if dim is None or len(shards) == 1:
        return shards[0]
    if _is_split_rows(name):
        d = shards[0].shape[1] // 5
        fp8 = shards[0].dtype.itemsize == 1
        raw = [t.view(torch.uint8) if fp8 else t for t in shards]
        whole = torch.cat([t.narrow(1, 0, d) for t in raw]
                          + [t.narrow(1, d, 4 * d) for t in raw], dim=1)
        return whole.view(shards[0].dtype) if fp8 else whole
    return torch.cat(list(shards), dim=dim)


def _spec_for(name: str) -> Optional[int]:
    parts = [p for p in name.split(".") if not p.isdigit()]
    if not (_BLOCK_STACKS & set(parts)):
        return None
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    grand = parts[-3] if len(parts) > 2 else ""
    if parent in _COLUMN:
        return 0                      # weight [out, in] and bias [out]
    if parent in _ROW:
        return 1 if leaf == "weight" else None   # bias added post-reduce
    if parent == "lin" and grand in _ADALN_PARENTS:
        return 0
    if parent in _NORM_FOLLOW and leaf == "weight":
        return None if grand == "attn" else 0
    return None


def tp_param_shardings(mesh: DeviceMesh, module: nn.Module,
                       axis: str = "model") -> Dict[str, Optional[int]]:
    """{parameter name: the dim cut over ``axis``, or None} of the table
    in the module docstring."""
    axis_size(mesh, axis)
    return tp_dims(module)


def tp_dims(module: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the dim `apply_tp` cuts, or None}, by name alone
    (`tp_param_shardings` without a mesh)."""
    return {name: _spec_for(name) for name, _ in module.named_parameters()}


def tp_fsdp_param_shardings(mesh: DeviceMesh, module: nn.Module,
                            tp_axis: str = "model", fsdp_axis: str = "data",
                            min_size: int = 2 ** 16
                            ) -> Dict[str, Tuple[Optional[int],
                                                 Optional[int]]]:
    """{parameter name: (TP dim, FSDP dim)}: the TP rule, then FSDP on the
    largest dim TP left free that divides by the ``fsdp_axis`` size, for a
    parameter of at least ``min_size`` elements (JAX's
    `tp_fsdp_param_shardings`; ties go to the later dim, JAX's earlier one
    in its [in, out] layout)."""
    n = axis_size(mesh, fsdp_axis)
    tp = tp_param_shardings(mesh, module, tp_axis)
    out = {}
    for name, p in module.named_parameters():
        t, f = tp[name], None
        if p.numel() >= min_size and n > 1:
            for d in np.argsort(list(p.shape), kind="stable")[::-1]:
                if d != t and p.shape[d] % n == 0:
                    f = int(d)
                    break
        out[name] = (t, f)
    return out


def validate_tp(cfg, mesh: DeviceMesh, axis: str = "model") -> None:
    """ValueError unless the heads and the FFN dim divide over ``axis``
    (a `WanDiTConfig`'s num_heads/ffn_dim, or an image family's
    num_attention_heads and FFN 4 x inner_dim)."""
    tp = axis_size(mesh, axis)
    heads = getattr(cfg, "num_heads", None)
    if heads is None:
        heads = cfg.num_attention_heads
    ffn = getattr(cfg, "ffn_dim", None)
    if ffn is None:
        ffn = 4 * cfg.inner_dim
    if heads % tp:
        raise ValueError(f"num_heads {heads} % tp {tp} != 0")
    if ffn % tp:
        raise ValueError(f"ffn_dim {ffn} % tp {tp} != 0")


@torch.no_grad()
def apply_tp(module: nn.Module, mesh: DeviceMesh, axis: str = "model"
             ) -> nn.Module:
    """Cut ``module``'s parameters to this rank's shards in place (the
    table in the module docstring) and attach the `TPContext` to each
    block of its stacks and to ``module`` (``.tp``). A no-op on an axis of
    size 1, and on a module already cut over an axis of this size."""
    size = axis_size(mesh, axis)
    if size == 1:
        return module
    done = getattr(module, "tp", None)
    if done is not None:
        if done.size != size:
            raise ValueError(f"module already cut over {done.size} model "
                             f"ranks, not {size}")
        return module
    ctx = TPContext(mesh.get_group(axis), size, mesh.get_local_rank(axis))
    dims = tp_param_shardings(mesh, module, axis)
    for name, dim in dims.items():
        if dim is None:
            continue
        owner_name, leaf = name.rsplit(".", 1)
        owner = module.get_submodule(owner_name)
        old = getattr(owner, leaf)
        new = shard_param(name, old.data, dim, size, ctx.rank).clone()
        setattr(owner, leaf, nn.Parameter(new,
                                          requires_grad=old.requires_grad))
    for name, sub in module.named_modules():
        parts = name.split(".")
        if len(parts) == 2 and parts[0] in _BLOCK_STACKS:
            sub.tp = ctx
    module.tp = ctx
    return module


def make_tp_attention(mesh: DeviceMesh, model_axis: str = "model",
                      seq_axis: Optional[str] = None,
                      inner_backend: Optional[str] = None) -> Callable:
    """Returns ``attn(q, k, v, mask=None)`` on this rank's LOCAL shards
    [B, L/sp, N/tp, D]: the heads are already this rank's model shard
    (attention needs no collective over them), and with ``seq_axis`` of
    more than one rank Ulysses runs over ``seq`` on the local head group
    (N/tp must divide by sp); otherwise ``inner_backend`` runs locally.
    JAX's ``batch_axis`` has no counterpart: the rows a rank is given are
    already its own (CFG parallelism)."""
    from .ulysses import make_ulysses_attention
    axis_size(mesh, model_axis)
    if seq_axis is not None and axis_size(mesh, seq_axis) > 1:
        return make_ulysses_attention(mesh, seq_axis, inner_backend)

    def attn(q, k, v, mask=None):
        return attention(q, k, v, mask=mask, backend=inner_backend)

    return attn
