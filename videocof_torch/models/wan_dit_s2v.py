"""The S2V (speech-to-video) Wan variant, PyTorch.

Counterpart of the JAX package's `models/wan_dit_s2v.py`, which rebuilds what
the reference's broken `wan_transformer3d_s2v.py` defines: segment-wise
AdaLN (each token's 6-way modulation picked by its segment id, ``seg_ids``
[L] in {0, 1}), per-sample RoPE tables [B, L, head_dim/2], and the audio
path: an encoder from per-latent-frame audio features to ``num_token``
tokens a frame, and at each inject layer a cross-attention of each latent
frame's video tokens to that frame's audio tokens (kernel B1 at a key
length of ``num_token`` and a batch of B * frames where head_dim is 128,
the naive backend otherwise, as JAX's). The base blocks are the t2v DiT's;
the stream is fp32 between them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs import WanDiTConfig
from ..ops import attention
from ..utils.fp8 import compute_dtype as _kernel_dtype
from . import rope as rope_lib
from .wan_dit import (WanBlock, WanDiT, _layer_norm, _lin,
                      _linear, _rms_norm, _ScaleBias, _Weight, ffn_apply,
                      fused_block_weights, patchify, unpatchify)


def apply_rope_per_sample(x: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, N, D] rotated by per-sample tables cos/sin [B, L, D//2] in
    fp32, returned in x's dtype (`s2v_rope_apply`)."""
    return rope_lib.apply_rope(x, cos, sin, compute_dtype=torch.float32)


def s2v_block_apply(block: WanBlock, cfg: WanDiTConfig, x: torch.Tensor,
                    e0: torch.Tensor, seg_ids: torch.Tensor,
                    context: torch.Tensor, rope_cs, attn_backend=None,
                    lora=None) -> torch.Tensor:
    """One S2V block on the fp32 stream x [B, L, D]: e0 [B, 6, 2, D] holds
    each segment's modulation, gathered per token by ``seg_ids``. A block
    cut by `parallel.apply_tp` runs its heads and FFN shard. ``lora`` =
    (this block's adapters, scale) fused into its weights for this call
    (`WanBlock.forward`'s)."""
    eps, tp = cfg.eps, block.tp
    fused = fused_block_weights(block, lora)
    e = block.modulation[None, :, None, :].float() + e0
    e_ = e[:, :, seg_ids].unbind(1)                    # 6 x [B, L, D]
    cdt = context.dtype
    tx = _layer_norm(x, eps) * (1.0 + e_[1]) + e_[0]
    y = block.self_attn(tx.to(cdt), cfg.num_heads, eps, rope_cs=rope_cs,
                        backend=attn_backend, rope_dtype=torch.float32,
                        weights=fused["self_attn"], tp=tp)
    x = x + y.float() * e_[2]
    nx = (_layer_norm(x, eps, block.norm3.scale, block.norm3.bias)
          if cfg.cross_attn_norm else x)
    y = block.cross_attn(nx.to(cdt), cfg.num_heads, eps, kv_in=context,
                         backend=attn_backend, weights=fused["cross_attn"],
                         tp=tp)
    x = x + y.float()
    tx = _layer_norm(x, eps) * (1.0 + e_[4]) + e_[3]
    h = ffn_apply(block.ffn, tx.to(cdt), tp, fused["ffn"])
    return x + h.float() * e_[5]


class _AudioEncoder(nn.Module):
    def __init__(self, audio_dim, dim, num_token, dtype, device):
        super().__init__()
        self.proj = _lin(audio_dim, dim * num_token, dtype, device)
        self.norm = _Weight(audio_dim, dtype, device)


class _Injector(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.norm = _ScaleBias(d, dtype, device)
        self.q, self.k = _lin(d, d, dtype, device), _lin(d, d, dtype, device)
        self.v, self.o = _lin(d, d, dtype, device), _lin(d, d, dtype, device)


class _AudioInjector(nn.Module):
    def __init__(self, d, inject_layers, dtype, device):
        super().__init__()
        self.layers = nn.ModuleDict({str(int(i)): _Injector(d, dtype, device)
                                     for i in inject_layers})


class WanS2V(nn.Module):
    """The S2V extras beside the base DiT: ``audio_encoder`` and one
    ``audio_injector`` layer per inject layer."""

    def __init__(self, cfg: WanDiTConfig, audio_dim: int = 1024,
                 num_audio_token: int = 4,
                 inject_layers: Sequence[int] = (0,), dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_audio_token = num_audio_token
        self.inject_layers = tuple(int(i) for i in inject_layers)
        self.audio_encoder = _AudioEncoder(audio_dim, cfg.dim,
                                           num_audio_token, dtype, device)
        self.audio_injector = _AudioInjector(cfg.dim, self.inject_layers,
                                             dtype, device)


@torch.no_grad()
def init_s2v_params(cfg: WanDiTConfig, generator: torch.Generator,
                    audio_dim: int = 1024, num_audio_token: int = 4,
                    inject_layers: Sequence[int] = (0,), dtype=torch.float32,
                    device=None) -> WanS2V:
    """The S2V extras with random weights as JAX's `init_s2v_params` draws
    them: uniform ±1/sqrt(din) linears, zero biases, unit norms, and each
    injector's output projection zero (the injection starts as a no-op)."""
    s2v = WanS2V(cfg, audio_dim, num_audio_token, inject_layers, dtype,
                 device or generator.device)
    for name, p in s2v.named_parameters():
        if name.endswith(".bias") or name.endswith(".o.weight"):
            p.zero_()
        elif name.endswith(".weight") and p.dim() == 2:
            b = 1.0 / math.sqrt(p.shape[1])
            p.copy_(torch.empty(p.shape, device=generator.device).uniform_(
                -b, b, generator=generator))
    return s2v


def audio_encode(enc: _AudioEncoder, feats: torch.Tensor, num_token: int
                 ) -> torch.Tensor:
    """Audio features [B, F, audio_dim] -> tokens [B, F, num_token, dim]."""
    B, Fr, _ = feats.shape
    h = _linear(_rms_norm(feats, enc.norm.weight, 1e-6), enc.proj)
    return h.reshape(B, Fr, num_token, -1)


def audio_inject(inj: _Injector, cfg: WanDiTConfig, x: torch.Tensor,
                 audio_tokens: torch.Tensor, grid: Tuple[int, int, int]
                 ) -> torch.Tensor:
    """Per-frame cross-attention: the video tokens of latent frame f (x
    [B, f*h*w, D]) attend to ``audio_tokens[:, f]``."""
    B, L, D = x.shape
    f, hh, ww = grid
    N, hd = cfg.num_heads, D // cfg.num_heads
    nx = _layer_norm(x, cfg.eps, inj.norm.scale, inj.norm.bias).to(
        audio_tokens.dtype)
    q = _linear(nx, inj.q).reshape(B * f, hh * ww, N, hd)
    na = audio_tokens.shape[2]
    ka = _linear(audio_tokens, inj.k).reshape(B * f, na, N, hd)
    va = _linear(audio_tokens, inj.v).reshape(B * f, na, N, hd)
    out = attention(q, ka, va, backend="naive" if hd % 128 else None)
    return x + _linear(out.reshape(B, L, D).to(nx.dtype), inj.o).float()


def wan_s2v_forward(dit: WanDiT, s2v: WanS2V, x: torch.Tensor,
                    t: torch.Tensor, context: torch.Tensor,
                    rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                    seg_ids: torch.Tensor,
                    audio_feats: Optional[torch.Tensor] = None,
                    attn_backend=None) -> torch.Tensor:
    """Velocity [B, out_dim, F, H, W] of the S2V model: ``rope_cos``/
    ``rope_sin`` [B, L, head_dim//2] per sample, ``audio_feats``
    [B, F_latent, audio_dim] (None: no injection). The DiT's
    ``runtime_lora`` (`LoRAAdapters`, scale) is fused into each block
    inside its call; JAX's forward skips the runtime adapters (a
    departure, which computes what merging the same files computes)."""
    cfg = dit.cfg
    lora = dit.runtime_lora
    compute_dtype = _kernel_dtype(dit.patch_embed)
    tokens, grid = patchify(x.to(compute_dtype), cfg.patch_size)
    stream = _linear(tokens, dit.patch_embed).float()
    e, e0 = dit.embed_time(t)
    # both segments share the timestep modulation
    e0 = torch.stack([e0, e0], dim=2)                  # [B, 6, 2, D]
    ctx = dit.embed_text(context)
    audio_tokens = None
    if audio_feats is not None:
        if audio_feats.shape[1] != grid[0]:
            raise ValueError(f"audio features cover {audio_feats.shape[1]} "
                             f"frames; the latents have {grid[0]}")
        audio_tokens = audio_encode(s2v.audio_encoder,
                                    audio_feats.to(compute_dtype),
                                    s2v.num_audio_token)
    layers = s2v.audio_injector.layers
    for i, block in enumerate(dit.blocks):
        stream = s2v_block_apply(
            block, cfg, stream, e0, seg_ids, ctx, (rope_cos, rope_sin),
            attn_backend, None if lora is None else (lora[0].blocks[i],
                                                     lora[1]))
        if audio_tokens is not None and str(i) in layers:
            stream = audio_inject(layers[str(i)], cfg, stream, audio_tokens,
                                  grid)
    out = dit.head_out(stream, e)
    return unpatchify(out.float(), grid, cfg.patch_size, cfg.out_dim)
