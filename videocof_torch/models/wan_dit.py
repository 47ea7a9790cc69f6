"""Wan2.1 3D diffusion transformer (t2v), PyTorch.

Counterpart of `videocof_tpu/models/wan_dit.py` (`wan_dit_forward`). The
precision islands are the same: the residual stream is stored in
``cfg.stream_dtype``; LayerNorm, AdaLN modulation and the time MLP run in
fp32; q/k RMSNorm returns its input dtype; matmul inputs are cast to the
parameter dtype. Patch embedding is patchify + linear (identical to the
stride == kernel Conv3d). RoPE arrives as per-token cos/sin tables.

Parameter names follow the JAX tree (`convert.dit_from_jax` maps one onto
the other); linear weights are [out, in] as in ``nn.Linear``. A linear may
store its weight in fp8 (`utils/fp8.py`): it is dequantized to bf16 at its
use and computes in bf16, as JAX's `_kernel` does. Runtime LoRA adapters
attached as ``runtime_lora`` (`WanPipeline.set_runtime_lora`) are fused into
each block's weights inside that block's call when ``lora=`` is not given.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..configs import WanDiTConfig
from ..ops import attention
from ..utils.fp8 import compute_dtype as _kernel_dtype
from ..utils.fp8 import dequantize
from . import rope as rope_lib
from .lora import fuse_block_adapters


# --------------------------------------------------------------------- helpers

def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """cat([cos(p*w), sin(p*w)]) with w_i = 10000^(-i/half), fp32."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=position.device) / half)
    ang = position.float()[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _layer_norm(x, eps, scale=None, bias=None):
    xf = x.float()
    w = None if scale is None else scale.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(xf, (xf.shape[-1],), w, b, eps)


def _rms_norm(x, weight, eps):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (out * weight.float()).to(x.dtype)


def _linear(x, lin: nn.Linear, dtype=None):
    """x @ W^T + b in ``dtype`` (default: the weight's compute dtype, bf16
    for fp8 storage, which is dequantized here)."""
    w = dequantize(lin, dtype)
    bias = None if lin.bias is None else lin.bias.to(w.dtype)
    return F.linear(x.to(w.dtype), w, bias)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------- modules

class _Weight(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


class _ScaleBias(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


def _lin(din, dout, dtype, device):
    return nn.Linear(din, dout, bias=True, dtype=dtype, device=device)


class Attention(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.q, self.k = _lin(d, d, dtype, device), _lin(d, d, dtype, device)
        self.v, self.o = _lin(d, d, dtype, device), _lin(d, d, dtype, device)
        self.norm_q = _Weight(d, dtype, device)
        self.norm_k = _Weight(d, dtype, device)

    def forward(self, x_in, num_heads, eps, kv_in=None, rope_cs=None,
                kv_mask=None, backend=None, rope_dtype=None):
        B, L, D = x_in.shape
        hd = D // num_heads
        kv_in = x_in if kv_in is None else kv_in
        q = _rms_norm(_linear(x_in, self.q), self.norm_q.weight, eps)
        k = _rms_norm(_linear(kv_in, self.k), self.norm_k.weight, eps)
        v = _linear(kv_in, self.v)
        q = q.view(B, L, num_heads, hd)
        k = k.view(B, k.shape[1], num_heads, hd)
        v = v.view(B, v.shape[1], num_heads, hd)
        if rope_cs is not None:
            cos, sin = rope_cs
            q = rope_lib.apply_rope(q, cos, sin, compute_dtype=rope_dtype)
            k = rope_lib.apply_rope(k, cos, sin, compute_dtype=rope_dtype)
        out = attention(q, k, v, mask=kv_mask, backend=backend)
        return _linear(out.reshape(B, L, D), self.o)


class FFN(nn.Module):
    def __init__(self, d, f, dtype, device):
        super().__init__()
        self.fc1 = _lin(d, f, dtype, device)
        self.fc2 = _lin(f, d, dtype, device)


class WanBlock(nn.Module):
    """One WanAttentionBlock: AdaLN-gated self-attention with RoPE, text
    cross-attention, AdaLN-gated gelu-tanh FFN."""

    def __init__(self, cfg: WanDiTConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.self_attn = Attention(d, dtype, device)
        self.cross_attn = Attention(d, dtype, device)
        self.ffn = FFN(d, cfg.ffn_dim, dtype, device)
        self.modulation = nn.Parameter(
            torch.zeros(6, d, dtype=torch.float32, device=device))
        if cfg.cross_attn_norm:
            self.norm3 = _ScaleBias(d, dtype, device)

    def forward(self, x, e0, context, rope_cs, seq_mask=None,
                attn_backend=None):
        cfg, eps = self.cfg, self.cfg.eps
        e = self.modulation[None].float() + e0                  # [B, 6, D]
        e_ = [e[:, i][:, None, :] for i in range(6)]
        sdt = x.dtype

        tx = _layer_norm(x, eps) * (1.0 + e_[1]) + e_[0]
        y = self.self_attn(tx.to(context.dtype), cfg.num_heads, eps,
                           rope_cs=rope_cs, kv_mask=seq_mask,
                           backend=attn_backend,
                           rope_dtype=getattr(torch, cfg.rope_dtype))
        x = (x.float() + y.float() * e_[2]).to(sdt)

        if cfg.cross_attn_norm:
            nx = _layer_norm(x, eps, self.norm3.scale, self.norm3.bias)
        else:
            nx = x
        y = self.cross_attn(nx.to(context.dtype), cfg.num_heads, eps,
                            kv_in=context, backend=attn_backend)
        x = (x.float() + y.float()).to(sdt)

        tx = _layer_norm(x, eps) * (1.0 + e_[4]) + e_[3]
        h = _gelu_tanh(_linear(tx.to(context.dtype), self.ffn.fc1))
        h = _linear(h, self.ffn.fc2)
        return (x.float() + h.float() * e_[5]).to(sdt)


class _MLP2(nn.Module):
    def __init__(self, din, d, dtype, device):
        super().__init__()
        self.fc1 = _lin(din, d, dtype, device)
        self.fc2 = _lin(d, d, dtype, device)


class _Head(nn.Module):
    def __init__(self, d, dout, dtype, device):
        super().__init__()
        self.fc = _lin(d, dout, dtype, device)
        self.modulation = nn.Parameter(
            torch.zeros(2, d, dtype=torch.float32, device=device))


class _TimeProj(nn.Module):
    def __init__(self, d, device):
        super().__init__()
        self.fc = _lin(d, 6 * d, torch.float32, device)


# -------------------------------------------------------------------- patchify

def patchify(x: torch.Tensor, patch_size) -> Tuple[torch.Tensor,
                                                   Tuple[int, int, int]]:
    """[B, C, F, H, W] -> ([B, L, C*pt*ph*pw], grid); feature order
    (c, dt, dh, dw)."""
    B, C, Fr, H, W = x.shape
    pt, ph, pw = patch_size
    f, h, w = Fr // pt, H // ph, W // pw
    x = x.reshape(B, C, f, pt, h, ph, w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(B, f * h * w, C * pt * ph * pw), (f, h, w)


def unpatchify(x: torch.Tensor, grid, patch_size, out_dim: int) -> torch.Tensor:
    """[B, L, pt*ph*pw*c] -> [B, c, F, H, W]; feature order (dt, dh, dw, c)."""
    B = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = x.reshape(B, f, h, w, pt, ph, pw, out_dim).permute(0, 7, 1, 4, 2, 5,
                                                           3, 6)
    return x.reshape(B, out_dim, f * pt, h * ph, w * pw)


# ---------------------------------------------------------------------- model

def _block_call(block, ad, lora_scale, attn_backend, stream, e0, ctx,
                rope_cos, rope_sin, seq_mask):
    """One block, with its LoRA adapters ``ad`` fused into its weights for
    this call only when given."""
    args = (stream, e0, ctx, (rope_cos, rope_sin), seq_mask, attn_backend)
    if ad is None:
        return block(*args)
    return functional_call(block, fuse_block_adapters(block, ad, lora_scale),
                           args)


class WanDiT(nn.Module):
    """Velocity prediction [B, out_dim, F, H, W] from latents, timesteps,
    text embeddings and per-token RoPE tables."""

    def __init__(self, cfg: WanDiTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        pt, ph, pw = cfg.patch_size
        self.patch_embed = _lin(cfg.in_dim * pt * ph * pw, d, dtype, device)
        self.text_mlp = _MLP2(cfg.text_dim, d, dtype, device)
        self.time_mlp = _MLP2(cfg.freq_dim, d, torch.float32, device)
        self.time_proj = _TimeProj(d, device)
        self.head = _Head(d, pt * ph * pw * cfg.out_dim, dtype, device)
        self.blocks = nn.ModuleList(WanBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        # (LoRAAdapters, scale) fused per block when forward's lora is None
        self.runtime_lora = None

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                attn_backend: Optional[str] = None, lora=None,
                remat_blocks: bool = False,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lora`` = (`LoRAAdapters`, scale) fuses each block's adapters into
        its weights inside that block's call, as the JAX scan does, so only
        one block's fused weights exist at a time; without it the attached
        ``runtime_lora`` is fused so. ``remat_blocks`` wraps each
        block in activation checkpointing (JAX's full remat): the backward
        recomputes the block from its input stream.

        The RoPE tables are [L, head_dim//2], or [B, L, head_dim//2] per
        sample. ``seq_lens`` [B] (a ragged batch) gives each sample's valid
        token count: keys past it leave that sample's self-attention, and
        the caller keeps each sample's valid region of the output."""
        return self._run(x, t, context, rope_cos, rope_sin, attn_backend,
                         lora=lora, remat_blocks=remat_blocks,
                         seq_lens=seq_lens)[0]

    def forward_with_residual(self, x: torch.Tensor, t: torch.Tensor,
                              context: torch.Tensor, rope_cos: torch.Tensor,
                              rope_sin: torch.Tensor,
                              attn_backend: Optional[str] = None,
                              residual: Optional[torch.Tensor] = None,
                              skip_blocks: bool = False,
                              seq_lens: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward that exposes TeaCache's token-stream residual
        (`wan_dit_forward_with_residual` with a Python-bool skip): returns
        (velocity, residual). Computing, the residual is the block stack's
        output stream minus its input; with ``skip_blocks`` the stack is
        bypassed, ``residual`` (of an earlier computed step) is added to the
        embedded stream and returned as it is, and the head still runs.
        ``seq_lens`` as in `forward`."""
        if skip_blocks and residual is None:
            raise ValueError("skip_blocks needs a cached residual")
        return self._run(x, t, context, rope_cos, rope_sin, attn_backend,
                         residual=residual, skip_blocks=skip_blocks,
                         want_residual=True, seq_lens=seq_lens)

    def _run(self, x, t, context, rope_cos, rope_sin, attn_backend, lora=None,
             remat_blocks=False, residual=None, skip_blocks=False,
             want_residual=False, seq_lens=None):
        cfg = self.cfg
        if lora is None:
            lora = self.runtime_lora
        compute_dtype = _kernel_dtype(self.patch_embed)
        tokens, grid = patchify(x.to(compute_dtype), cfg.patch_size)
        hseq = _linear(tokens, self.patch_embed)

        e = sinusoidal_embedding_1d(cfg.freq_dim, t.float())
        e = _linear(e, self.time_mlp.fc1, torch.float32)
        e = _linear(F.silu(e), self.time_mlp.fc2, torch.float32)    # [B, D]
        e0 = _linear(F.silu(e), self.time_proj.fc, torch.float32)
        e0 = e0.view(e0.shape[0], 6, cfg.dim)

        ctx = _linear(context.to(compute_dtype), self.text_mlp.fc1)
        ctx = _linear(_gelu_tanh(ctx), self.text_mlp.fc2)          # [B, Lt, D]

        # pad tokens to the kernel tile (the tables, [L, D/2] or per sample
        # [B, L, D/2], with the identity rotation); padded keys leave
        # self-attention
        L_real = hseq.shape[1]
        seq_mask = None
        pad_to = cfg.token_pad_multiple
        Lp = ((L_real + pad_to - 1) // pad_to) * pad_to
        if Lp != L_real:
            pad = Lp - L_real
            hseq = F.pad(hseq, (0, 0, 0, pad))
            rope_cos = F.pad(rope_cos, (0, 0, 0, pad), value=1.0)
            rope_sin = F.pad(rope_sin, (0, 0, 0, pad))
            seq_mask = (torch.arange(Lp, device=hseq.device) < L_real
                        )[None].expand(hseq.shape[0], Lp)
        if seq_lens is not None:
            # a ragged batch: each sample's own valid length supersedes the
            # pad mask (the reference's per-sample varlen k_lens)
            seq_mask = (torch.arange(Lp, device=hseq.device)[None]
                        < torch.as_tensor(seq_lens, device=hseq.device)[:, None])

        stream0 = hseq.to(getattr(torch, cfg.stream_dtype))
        stream = stream0
        if skip_blocks:
            stream = stream0 + residual
        for i, block in enumerate(() if skip_blocks else self.blocks):
            ad = None if lora is None else lora[0].blocks[i]
            call = functools.partial(_block_call, block, ad,
                                     None if lora is None else lora[1],
                                     attn_backend)
            args = (stream, e0, ctx, rope_cos, rope_sin, seq_mask)
            if remat_blocks and torch.is_grad_enabled():
                stream = checkpoint(call, *args, use_reentrant=False)
            else:
                stream = call(*args)
        if skip_blocks:
            residual_out = residual
        else:
            residual_out = stream - stream0 if want_residual else None

        hm = self.head.modulation[None].float() + e[:, None, :]
        he0, he1 = hm[:, 0][:, None, :], hm[:, 1][:, None, :]
        out = _layer_norm(stream, cfg.eps) * (1.0 + he1) + he0
        out = _linear(out.to(compute_dtype), self.head.fc)[:, :L_real]
        return (unpatchify(out.float(), grid, cfg.patch_size, cfg.out_dim),
                residual_out)


def make_rope_for_geometry(cfg: WanDiTConfig, grid,
                           f_src: Optional[int] = None, f_ground: int = 0,
                           temporal_table: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side cos/sin tables for a latent grid (see rope.py);
    ``temporal_table`` replaces the temporal angles (RIFLEx)."""
    return rope_lib.build_rope_cos_sin(grid, cfg.head_dim, f_src=f_src,
                                       f_ground=f_ground,
                                       max_pos=cfg.rope_max_pos,
                                       theta=cfg.rope_theta,
                                       temporal_table=temporal_table)


# ------------------------------------------------------------------------ init

@torch.no_grad()
def init_wan_dit(cfg: WanDiTConfig, generator: torch.Generator,
                 dtype=torch.float32, device=None) -> WanDiT:
    """Random weights drawn as the JAX init draws them (uniform
    ±1/sqrt(din) linear kernels, zero biases, unit norms, N(0, 1/d)
    modulations), from ``generator`` on ``device``."""
    model = WanDiT(cfg, dtype=dtype, device=device or generator.device)
    gdev = generator.device
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "modulation":
            r = torch.randn(p.shape, generator=generator, device=gdev)
            p.copy_(r / math.sqrt(cfg.dim))
        elif leaf == "weight" and p.dim() == 2:
            bound = 1.0 / math.sqrt(p.shape[1])
            r = torch.empty(p.shape, device=gdev).uniform_(-bound, bound,
                                                          generator=generator)
            p.copy_(r)
        elif leaf == "bias":
            p.zero_()
    return model
