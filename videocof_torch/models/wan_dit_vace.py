"""VACE control branch of the Wan DiT, PyTorch.

Counterpart of the JAX package's `models/wan_dit_vace.py` (the reference's
`wan_transformer3d_vace.py:20-135`): ``n_vace`` hint blocks (full Wan
blocks) run over the patch-embedded control latents, seeded with
``before_proj(c) + x``, each emitting an ``after_proj`` hint; the base
stack, grouped by ``stride = num_layers // n_vace``, adds ``hint * scale``
after the first layer of each group. ``before_proj`` and ``after_proj``
start at zero, so a fresh branch leaves the base model's velocity as it is.
The control stream and the base stream are fp32 between blocks, as JAX's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs import WanDiTConfig
from ..utils.fp8 import compute_dtype as _kernel_dtype
from .wan_dit import WanBlock, WanDiT, _linear, _lin, patchify, unpatchify
from .weights import StateDict, convert_block_state_dict, \
    convert_dit_state_dict


class WanVace(nn.Module):
    """The control branch's weights: ``vace_patch_embed``, the hint blocks
    ``vace_blocks``, ``before_proj`` and one ``after_proj`` a hint block."""

    def __init__(self, cfg: WanDiTConfig, stride: int = 2,
                 vace_in_dim: Optional[int] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        if cfg.num_layers % stride:
            raise ValueError(f"stride {stride} does not divide the "
                             f"{cfg.num_layers} layers")
        self.cfg, self.stride = cfg, stride
        n_vace = cfg.num_layers // stride
        pt, ph, pw = cfg.patch_size
        d = cfg.dim
        self.vace_patch_embed = _lin((vace_in_dim or cfg.in_dim) * pt * ph * pw,
                                     d, dtype, device)
        self.vace_blocks = nn.ModuleList(WanBlock(cfg, dtype, device)
                                         for _ in range(n_vace))
        self.before_proj = _lin(d, d, dtype, device)
        self.after_proj = nn.ModuleList(_lin(d, d, dtype, device)
                                        for _ in range(n_vace))

    @property
    def n_vace(self) -> int:
        return len(self.vace_blocks)


@torch.no_grad()
def init_vace_params(cfg: WanDiTConfig, generator: torch.Generator,
                     stride: int = 2, vace_in_dim: Optional[int] = None,
                     dtype=torch.float32, device=None) -> WanVace:
    """A control branch with random hint blocks and patch embedding (drawn
    as `init_wan_dit` draws the DiT's) and zero ``before_proj`` and
    ``after_proj`` (JAX's `init_vace_params`), from ``generator``."""
    vace = WanVace(cfg, stride, vace_in_dim, dtype,
                   device or generator.device)
    gdev = generator.device
    for name, p in vace.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith(("before_proj.", "after_proj.")) or leaf == "bias":
            p.zero_()
        elif leaf == "modulation":
            p.copy_(torch.randn(p.shape, generator=generator, device=gdev)
                    / math.sqrt(cfg.dim))
        elif leaf == "weight" and p.dim() == 2:
            bound = 1.0 / math.sqrt(p.shape[1])
            p.copy_(torch.empty(p.shape, device=gdev).uniform_(
                -bound, bound, generator=generator))
    return vace


def vace_key_map(n_vace: int) -> dict:
    """{published key of the branch's projections: the port's}; the hint
    blocks go through `convert_block_state_dict`."""
    names = {}
    for p in ("weight", "bias"):
        names[f"vace_patch_embedding.{p}"] = f"vace_patch_embed.{p}"
        names[f"vace_blocks.0.before_proj.{p}"] = f"before_proj.{p}"
        for n in range(n_vace):
            names[f"vace_blocks.{n}.after_proj.{p}"] = f"after_proj.{n}.{p}"
    return names


def vace_stride(sd: StateDict, cfg: WanDiTConfig) -> int:
    """The stride of a `VaceWanTransformer3DModel` state dict: the base
    layers over its hint blocks."""
    n_vace = 1 + max(int(k.split(".")[1]) for k in sd
                     if k.startswith("vace_blocks."))
    return cfg.num_layers // n_vace


def convert_vace_state_dict(sd: StateDict, cfg: WanDiTConfig,
                            stride: int = 2,
                            dtype: torch.dtype = torch.float32
                            ) -> Tuple[StateDict, StateDict]:
    """`VaceWanTransformer3DModel` keys -> (the `WanDiT` state dict, the
    `WanVace` one). The base blocks are plain Wan blocks
    (`wan_transformer3d_vace.py:66-90`); ``vace_patch_embedding``'s Conv3d
    becomes a linear over patchified tokens, as the base patch embedding."""
    base = convert_dit_state_dict(sd, cfg, dtype)
    n_vace = cfg.num_layers // stride
    vace = {}
    for src, dst in vace_key_map(n_vace).items():
        t = sd[src]
        if src == "vace_patch_embedding.weight":
            t = t.reshape(t.shape[0], -1)
        vace[dst] = t.to(dtype)
    for n in range(n_vace):
        vace.update(convert_block_state_dict(sd, f"vace_blocks.{n}.",
                                             f"vace_blocks.{n}.", cfg, dtype))
    return base, vace


def export_vace_state_dict(sd: StateDict, cfg: WanDiTConfig,
                           stride: int = 2) -> StateDict:
    """`WanVace` state dict -> the published ``vace_*`` keys (the inverse of
    `convert_vace_state_dict`'s branch half)."""
    from ..utils.checkpoint import export_block_state_dict
    n_vace = cfg.num_layers // stride
    out = {}
    for src, dst in vace_key_map(n_vace).items():
        t = sd[dst]
        if src == "vace_patch_embedding.weight":
            t = t.reshape(cfg.dim, -1, *cfg.patch_size)
        out[src] = t
    for n in range(n_vace):
        out.update(export_block_state_dict(sd, f"vace_blocks.{n}.",
                                           f"vace_blocks.{n}.", cfg))
    return out


def vace_forward(dit: WanDiT, vace: WanVace, x: torch.Tensor,
                 vace_context: torch.Tensor, t: torch.Tensor,
                 context: torch.Tensor, rope_cos: torch.Tensor,
                 rope_sin: torch.Tensor, context_scale: float = 1.0,
                 attn_backend=None) -> torch.Tensor:
    """Velocity [B, out_dim, F, H, W] of ``dit`` with the control hints of
    ``vace`` from ``vace_context`` [B, C_vace, F, H, W] (JAX's
    `vace_forward`). The DiT's ``runtime_lora`` (`LoRAAdapters`, scale) is
    fused into each base block inside its call, as `WanDiT.forward` does;
    the hint blocks take none (LoRA files name the base blocks only).
    JAX's `vace_forward` skips the runtime adapters: a departure, which
    computes what merging the same files into the base weights computes."""
    cfg, stride = dit.cfg, vace.stride
    lora = dit.runtime_lora
    compute_dtype = _kernel_dtype(dit.patch_embed)
    tokens, grid = patchify(x.to(compute_dtype), cfg.patch_size)
    stream = _linear(tokens, dit.patch_embed).float()
    e, e0 = dit.embed_time(t)
    ctx = dit.embed_text(context)
    rope = (rope_cos, rope_sin)

    ctoks, _ = patchify(vace_context.to(compute_dtype), cfg.patch_size)
    c = _linear(ctoks, vace.vace_patch_embed).float()
    c = _linear(c, vace.before_proj, torch.float32) + stream
    hints = []
    for block, proj in zip(vace.vace_blocks, vace.after_proj):
        c = block(c, e0, ctx, rope, attn_backend=attn_backend)
        hints.append(_linear(c, proj, torch.float32))

    for i, block in enumerate(dit.blocks):
        ad = None if lora is None else (lora[0].blocks[i], lora[1])
        stream = block(stream, e0, ctx, rope, attn_backend=attn_backend,
                       lora=ad)
        if i % stride == 0:
            stream = stream + hints[i // stride] * context_scale
    out = dit.head_out(stream, e)
    return unpatchify(out.float(), grid, cfg.patch_size, cfg.out_dim)
