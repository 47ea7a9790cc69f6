"""Wan2.1 3D diffusion transformer (t2v, and i2v's image branch), PyTorch.

Counterpart of `videocof_tpu/models/wan_dit.py` (`wan_dit_forward`). The
precision islands are the same: the residual stream is stored in
``cfg.stream_dtype``; LayerNorm, AdaLN modulation and the time MLP run in
fp32; q/k RMSNorm returns its input dtype; matmul inputs are cast to the
parameter dtype. On CUDA, with no gradient recorded, no tensor parallelism,
the fp32 stream and bf16 branches, the block's elementwise chain (AdaLN
modulation, the residual adds with the cross-attention norm, q/k RMSNorm
with RoPE) runs as the five hand-written passes of `ops/dit_fused.py`, with
the same arithmetic; elsewhere as the plain steps. Patch embedding is
patchify + linear (identical to the stride == kernel Conv3d). RoPE arrives
as per-token cos/sin tables.

Activation checkpointing of the blocks (``remat_blocks``) takes JAX's
named policies where they mean something on a torch graph (`remat_policy`),
through selective activation checkpointing.

Parameter names follow the JAX tree (`convert.dit_from_jax` maps one onto
the other); linear weights are [out, in] as in ``nn.Linear``. A linear may
store its weight in fp8 (`utils/fp8.py`): it is dequantized to bf16 at its
use and computes in bf16, as JAX's `_kernel` does. Runtime LoRA adapters
attached as ``runtime_lora`` (`WanPipeline.set_runtime_lora`) are fused into
each block's weights inside that block's call when ``lora=`` is not given.

An i2v model (``cfg.model_type == "i2v"``) takes the conditioning latents
``y`` concatenated to ``x`` on the channel axis and the CLIP features
``clip_fea``, embedded by ``img_emb`` and put before the text context; its
cross-attention attends the shared q to the first 257 (image) tokens
through ``k_img``/``v_img`` and to the text through ``k``/``v``, and sums
the two before ``o``. It raises without ``clip_fea``, where JAX's would take
the first 257 text tokens as image tokens. ``y_camera`` (camera control) is
added onto the patch embeddings.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs import WanDiTConfig
from ..ops import attention, dit_fused
from ..utils.fp8 import compute_dtype as _kernel_dtype
from ..utils.fp8 import dequantize
from ..utils.profiling import spanned
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


def _linear(x, lin: nn.Linear, dtype=None, weight=None):
    """x @ W^T + b in ``dtype`` (default: the weight's compute dtype, bf16
    for fp8 storage, which is dequantized here). ``weight`` replaces the
    stored weight (a LoRA-fused one)."""
    if weight is None:
        w = dequantize(lin, dtype)
    else:
        w = weight if dtype is None else weight.to(dtype)
    bias = None if lin.bias is None else lin.bias.to(w.dtype)
    return F.linear(x.to(w.dtype), w, bias)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------- tensor parallelism
# A block cut by `parallel.apply_tp` carries its `TPContext` as ``.tp``;
# these helpers are the plain operations when it is None.

def _tp_enter(x, tp):
    """Megatron's *f* before a column-parallel linear."""
    return x if tp is None else tp.enter(x)


def _rms_norm_tp(x, weight, eps, tp, full_dim):
    """`_rms_norm` of a column shard of a ``full_dim`` feature vector: the
    sum of squares over every rank's features, each rank scaling its
    own."""
    if tp is None:
        return _rms_norm(x, weight, eps)
    xf = x.float()
    ss = tp.sum_sq(xf.square().sum(dim=-1, keepdim=True))
    out = xf * torch.rsqrt(ss / full_dim + eps)
    return (out * weight.float()).to(x.dtype)


def _row_linear(x, lin: nn.Linear, tp, weight=None):
    """`_linear` of a row-parallel linear: the ranks' partial products
    summed (`TPContext.reduce`, in fp32), then the bias, once."""
    if tp is None:
        return _linear(x, lin, weight=weight)
    w = dequantize(lin) if weight is None else weight
    out = tp.reduce(F.linear(x.to(w.dtype), w))
    if lin.bias is not None:
        out = out + lin.bias.float()
    return out.to(w.dtype)


def ffn_apply(ffn: nn.Module, x, tp=None, weights=None):
    """The gelu-tanh FFN, fc1 column- and fc2 row-parallel under ``tp``;
    ``weights`` replaces fc1's and fc2's weights (LoRA-fused)."""
    w = weights or {}
    h = _gelu_tanh(_linear(_tp_enter(x, tp), ffn.fc1, weight=w.get("fc1")))
    return _row_linear(h, ffn.fc2, tp, weight=w.get("fc2"))


# context tokens of the i2v image stream (CLIP's CLS + 16 x 16 patches)
IMAGE_TOKENS = 257
CLIP_DIM = 1280


# ------------------------------------------------------------------- remat

@torch.library.custom_op("videocof::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` under ``name``: the op a 'save_names:' policy saves
    (JAX's `checkpoint_name`; a custom op, so that selective checkpointing
    sees it with its name)."""
    return x.clone()


checkpoint_name.register_fake(lambda x, name: torch.empty_like(x))
checkpoint_name.register_autograd(lambda ctx, grad: (grad, None),
                                  setup_context=lambda ctx, inputs,
                                  output: None)

_MATMULS = frozenset({torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default})
# JAX's `jax.checkpoint_policies` names that keep the outputs of some ops:
# the dots (the linears, the adapters' products and, under "dots_saveable",
# the batched products of the naive attention)
_SAVED_OPS = {
    "dots_saveable": _MATMULS | {torch.ops.aten.bmm.default},
    "checkpoint_dots": _MATMULS | {torch.ops.aten.bmm.default},
    "dots_with_no_batch_dims_saveable": _MATMULS,
    "checkpoint_dots_with_no_batch_dims": _MATMULS,
}
REMAT_POLICIES = ("nothing_saveable", "everything_saveable", *_SAVED_OPS)


def remat_policy(remat_blocks: Union[bool, str]) -> Optional[dict]:
    """``remat_blocks`` -> the keyword arguments of each block's
    ``checkpoint`` call, or None for no checkpointing (JAX's `_remat_wrap`).

    False: none. True or "nothing_saveable": full remat, the backward
    recomputes the block from its input. "everything_saveable": every
    residual is kept, which is the block without checkpointing (a selective
    checkpoint would still rerun the block's Python, and with it the
    attention kernels, which it cannot see). "dots_saveable" /
    "checkpoint_dots": the outputs of ``mm``, ``addmm`` and ``bmm`` are kept;
    "dots_with_no_batch_dims_saveable" /
    "checkpoint_dots_with_no_batch_dims": those of ``mm`` and ``addmm``
    (the linears, the adapters' products). "save_names:<n1,n2>": the
    outputs tagged by `checkpoint_name` (``attn_out``, ``xattn_out`` on a
    config with ``remat_tag_names``; without the tags nothing is saved, as
    in JAX). Every other value raises ValueError. The attention kernels are
    recomputed under every policy that checkpoints (as JAX recomputes a
    ``pallas_call``, which is not a dot)."""
    if remat_blocks in (False, None, "everything_saveable"):
        return None
    if remat_blocks in (True, "nothing_saveable"):
        return {}
    if isinstance(remat_blocks, str) and remat_blocks.startswith(
            "save_names:"):
        names = frozenset(remat_blocks.split(":", 1)[1].split(","))

        def must_save(op, args):
            return (op is torch.ops.videocof.checkpoint_name.default
                    and args[1] in names)
    elif isinstance(remat_blocks, str) and remat_blocks in _SAVED_OPS:
        saved = _SAVED_OPS[remat_blocks]

        def must_save(op, args):
            return op in saved
    else:
        raise ValueError(
            f"unknown remat policy {remat_blocks!r}; use a bool, one of "
            f"{list(REMAT_POLICIES)} or 'save_names:<n1,n2>'")

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if must_save(op, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}


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
    def __init__(self, d, dtype, device, image: bool = False):
        super().__init__()
        self.q, self.k = _lin(d, d, dtype, device), _lin(d, d, dtype, device)
        self.v, self.o = _lin(d, d, dtype, device), _lin(d, d, dtype, device)
        self.norm_q = _Weight(d, dtype, device)
        self.norm_k = _Weight(d, dtype, device)
        if image:        # i2v's image keys and values
            self.k_img = _lin(d, d, dtype, device)
            self.v_img = _lin(d, d, dtype, device)
            self.norm_k_img = _Weight(d, dtype, device)

    def forward(self, x_in, num_heads, eps, kv_in=None, rope_cs=None,
                kv_mask=None, backend=None, rope_dtype=None, weights=None,
                tp=None):
        """``backend``: a backend name, or a callable ``(q, k, v, mask)``
        (the sequence-parallel attention of `parallel`). ``weights``
        replaces the named projections' weights ({"q": W, ...}). ``tp``
        (a `parallel.tp.TPContext`): the projections are this rank's
        column (q, k, v) and row (o) shards and it runs its
        ``num_heads / tp`` heads."""
        B, L, D = x_in.shape
        n = num_heads if tp is None else num_heads // tp.size
        x_in = _tp_enter(x_in, tp)
        kv_in = x_in if kv_in is None else _tp_enter(kv_in, tp)
        w = weights or {}
        q = _linear(x_in, self.q, weight=w.get("q"))
        k = _linear(kv_in, self.k, weight=w.get("k"))
        v = _linear(kv_in, self.v, weight=w.get("v"))
        wq, wk = self.norm_q.weight, self.norm_k.weight
        paired = k.shape == q.shape        # self-attention: one launch
        if (paired or rope_cs is None) and dit_fused.plain_reason(
                q.device, None, q.dtype, tp, rope_dtype,
                (q, k, wq, wk)) is None:
            q, kn = dit_fused.qk_norm_rope(q, k if paired else None, wq, wk,
                                           eps, *(rope_cs or (None, None)))
            k = kn if paired else _rms_norm(k, wk, eps)
            rope_cs = None                 # rotated in the pass
        else:
            q = _rms_norm_tp(q, wq, eps, tp, D)
            k = _rms_norm_tp(k, wk, eps, tp, D)
        hd = q.shape[-1] // n
        q = q.view(B, L, n, hd)
        k = k.view(B, k.shape[1], n, hd)
        v = v.view(B, v.shape[1], n, hd)
        if rope_cs is not None:
            cos, sin = rope_cs
            q = rope_lib.apply_rope(q, cos, sin, compute_dtype=rope_dtype)
            k = rope_lib.apply_rope(k, cos, sin, compute_dtype=rope_dtype)
        if callable(backend):
            out = backend(q, k, v, mask=kv_mask)
        else:
            out = attention(q, k, v, mask=kv_mask, backend=backend)
        return _row_linear(out.reshape(B, L, n * hd), self.o, tp,
                           weight=w.get("o"))

    def forward_i2v(self, x_in, num_heads, eps, ctx_img, ctx_txt,
                    backend=None, weights=None, tp=None):
        """i2v's cross-attention: one q against the image stream (``k_img``,
        ``v_img``, ``norm_k_img``) and the text stream, the two outputs
        summed before ``o`` (JAX's `_i2v_cross_attn`); ``tp`` as in
        `forward`."""
        B, L, D = x_in.shape
        n = num_heads if tp is None else num_heads // tp.size
        w = weights or {}
        q = _rms_norm_tp(_linear(_tp_enter(x_in, tp), self.q,
                                 weight=w.get("q")),
                         self.norm_q.weight, eps, tp, D)
        hd = q.shape[-1] // n
        q = q.view(B, L, n, hd)

        def kv(ctx, k_lin, v_lin, norm, kw, vw):
            ctx = _tp_enter(ctx, tp)
            k = _rms_norm_tp(_linear(ctx, k_lin, weight=kw), norm.weight, eps,
                             tp, D)
            v = _linear(ctx, v_lin, weight=vw)
            return (k.view(B, -1, n, hd), v.view(B, -1, n, hd))

        k_t, v_t = kv(ctx_txt, self.k, self.v, self.norm_k, w.get("k"),
                      w.get("v"))
        k_i, v_i = kv(ctx_img, self.k_img, self.v_img, self.norm_k_img, None,
                      None)
        out = (attention(q, k_t, v_t, backend=backend)
               + attention(q, k_i, v_i, backend=backend))
        return _row_linear(out.reshape(B, L, n * hd), self.o, tp,
                           weight=w.get("o"))


class FFN(nn.Module):
    def __init__(self, d, f, dtype, device):
        super().__init__()
        self.fc1 = _lin(d, f, dtype, device)
        self.fc2 = _lin(f, d, dtype, device)


def fused_block_weights(block: nn.Module, lora) -> Dict[str, Dict]:
    """``{"self_attn" | "cross_attn" | "ffn": {linear: fused weight}}`` of
    ``lora`` = (this block's adapters, scale) fused into ``block``'s
    weights for one call (`fuse_block_adapters`); empty dicts for None."""
    fused = {mod: {} for mod in ("self_attn", "cross_attn", "ffn")}
    if lora is not None:
        for key, w in fuse_block_adapters(block, *lora).items():
            mod, name, _ = key.split(".")
            fused[mod][name] = w
    return fused


class WanBlock(nn.Module):
    """One WanAttentionBlock: AdaLN-gated self-attention with RoPE, text
    cross-attention, AdaLN-gated gelu-tanh FFN. ``tp`` is the
    `parallel.tp.TPContext` of a block `parallel.apply_tp` has cut."""

    tp = None

    def __init__(self, cfg: WanDiTConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.self_attn = Attention(d, dtype, device)
        self.cross_attn = Attention(d, dtype, device,
                                    image=cfg.model_type == "i2v")
        self.ffn = FFN(d, cfg.ffn_dim, dtype, device)
        self.modulation = nn.Parameter(
            torch.zeros(6, d, dtype=torch.float32, device=device))
        if cfg.cross_attn_norm:
            self.norm3 = _ScaleBias(d, dtype, device)

    def forward(self, x, e0, context, rope_cs, seq_mask=None,
                attn_backend=None, tag_names=False, lora=None):
        """``tag_names`` tags the attention outputs for a 'save_names:'
        remat policy (`checkpoint_name`). ``lora`` = (this block's adapters,
        scale) fuses them into the adapted weights here, inside the call
        (so that a sharded block has gathered its weights first). A
        callable ``attn_backend`` is the sequence-parallel self-attention;
        cross-attention then runs locally against the whole text context
        (the default backend), as in JAX."""
        cfg, eps = self.cfg, self.cfg.eps
        tp = self.tp
        fused = fused_block_weights(self, lora)
        rope_dtype = getattr(torch, cfg.rope_dtype)
        # the elementwise chain in five passes (`ops/dit_fused.py`) where
        # nothing needs what the kernels lack: a backward, TP's all-reduce,
        # other dtypes; else the same steps as plain tensors, in the
        # branches' dtype
        df = dit_fused
        if df.count_block(df.plain_reason(
                x.device, x.dtype, context.dtype, tp, rope_dtype,
                itertools.chain((x, e0, context), self.parameters(),
                                *(d.values() for d in fused.values())))
                is None):
            ln_mod, gate_ln = df.ln_modulate, df.gate_residual_ln
            res_ln, gate_res = df.residual_ln_modulate, df.gate_residual
        else:
            bdt = context.dtype
            ln_mod = functools.partial(df.ln_modulate_reference, dtype=bdt)
            gate_ln = functools.partial(df.gate_residual_ln_reference,
                                        dtype=bdt)
            res_ln = functools.partial(df.residual_ln_modulate_reference,
                                       dtype=bdt)
            gate_res = df.gate_residual_reference
        e = self.modulation[None].float() + e0                  # [B, 6, D]
        e_ = [e[:, i][:, None, :] for i in range(6)]
        norm3 = ((self.norm3.scale, self.norm3.bias) if cfg.cross_attn_norm
                 else (None, None))

        tx = ln_mod(x, e_[0], e_[1], eps)
        y = self.self_attn(tx, cfg.num_heads, eps,
                           rope_cs=rope_cs, kv_mask=seq_mask,
                           backend=attn_backend, rope_dtype=rope_dtype,
                           weights=fused["self_attn"], tp=tp)
        if tag_names:
            y = checkpoint_name(y, "attn_out")
        x, nx = gate_ln(x, y, e_[2], eps, *norm3)
        xattn_backend = None if callable(attn_backend) else attn_backend
        if hasattr(self.cross_attn, "k_img"):
            y = self.cross_attn.forward_i2v(
                nx, cfg.num_heads, eps,
                context[:, :IMAGE_TOKENS], context[:, IMAGE_TOKENS:],
                backend=xattn_backend, weights=fused["cross_attn"], tp=tp)
        else:
            y = self.cross_attn(nx, cfg.num_heads, eps,
                                kv_in=context, backend=xattn_backend,
                                weights=fused["cross_attn"], tp=tp)
        if tag_names:
            y = checkpoint_name(y, "xattn_out")
        x, tx = res_ln(x, y, e_[3], e_[4], eps)
        h = ffn_apply(self.ffn, tx, tp, fused["ffn"])
        return gate_res(x, h, e_[5])


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


class _ImageEmbed(nn.Module):
    """i2v's CLIP-feature MLP: LayerNorm, linear, exact GELU, linear,
    LayerNorm (`wan_transformer3d.py:551-563`)."""

    def __init__(self, d, dtype, device):
        super().__init__()
        self.ln1 = _ScaleBias(CLIP_DIM, dtype, device)
        self.fc1 = _lin(CLIP_DIM, CLIP_DIM, dtype, device)
        self.fc2 = _lin(CLIP_DIM, d, dtype, device)
        self.ln2 = _ScaleBias(d, dtype, device)

    def forward(self, clip_fea, compute_dtype):
        h = _layer_norm(clip_fea, 1e-5, self.ln1.scale, self.ln1.bias)
        h = F.gelu(_linear(h.to(compute_dtype), self.fc1), approximate="none")
        h = _linear(h, self.fc2)
        return _layer_norm(h, 1e-5, self.ln2.scale, self.ln2.bias)


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

@spanned("videocof.dit.block")
def _block_call(block, ad, lora_scale, attn_backend, tag_names, stream, e0,
                ctx, rope_cos, rope_sin, seq_mask):
    """One block, with its LoRA adapters ``ad`` fused into its weights for
    this call only when given."""
    return block(stream, e0, ctx, (rope_cos, rope_sin), seq_mask,
                 attn_backend, tag_names,
                 None if ad is None else (ad, lora_scale))


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
        if cfg.model_type == "i2v":
            self.img_emb = _ImageEmbed(d, dtype, device)
        self.blocks = nn.ModuleList(WanBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        # (LoRAAdapters, scale) fused per block when forward's lora is None
        self.runtime_lora = None

    # the pieces around the block stack, shared with the VACE and S2V
    # forwards
    def embed_time(self, t: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Timesteps [B] -> (e [B, D], e0 [B, 6, D]), fp32."""
        cfg = self.cfg
        e = sinusoidal_embedding_1d(cfg.freq_dim, t.float())
        e = _linear(e, self.time_mlp.fc1, torch.float32)
        e = _linear(F.silu(e), self.time_mlp.fc2, torch.float32)
        e0 = _linear(F.silu(e), self.time_proj.fc, torch.float32)
        return e, e0.view(e0.shape[0], 6, cfg.dim)

    def embed_text(self, context: torch.Tensor,
                   clip_fea: Optional[torch.Tensor] = None) -> torch.Tensor:
        """umT5 embeddings -> the blocks' context [B, Lt, D]; an i2v model's
        image tokens (``img_emb`` of ``clip_fea``) go first, and without
        ``clip_fea`` it raises."""
        compute_dtype = _kernel_dtype(self.patch_embed)
        ctx = _linear(context.to(compute_dtype), self.text_mlp.fc1)
        ctx = _linear(_gelu_tanh(ctx), self.text_mlp.fc2)
        if hasattr(self, "img_emb"):
            if clip_fea is None:
                raise ValueError(
                    "an i2v DiT needs clip_fea (the CLIP features of the "
                    "start image, [B, 257, 1280]): without them its "
                    "cross-attention would take the first 257 text tokens "
                    "as image tokens")
            img = self.img_emb(clip_fea, compute_dtype)
            ctx = torch.cat([img.to(ctx.dtype), ctx], dim=1)
        return ctx

    def head_out(self, stream: torch.Tensor, e: torch.Tensor
                 ) -> torch.Tensor:
        """The head with its 2-way modulation: stream [B, L, D] -> patch
        tokens [B, L, pt*ph*pw*out_dim] in the compute dtype."""
        hm = self.head.modulation[None].float() + e[:, None, :]
        he0, he1 = hm[:, 0][:, None, :], hm[:, 1][:, None, :]
        out = _layer_norm(stream, self.cfg.eps) * (1.0 + he1) + he0
        return _linear(out.to(_kernel_dtype(self.patch_embed)), self.head.fc)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                attn_backend: Optional[str] = None, lora=None,
                remat_blocks: Union[bool, str] = False,
                seq_lens: Optional[torch.Tensor] = None,
                sp=None, clip_fea: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None,
                y_camera: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lora`` = (`LoRAAdapters`, scale) fuses each block's adapters into
        its weights inside that block's call, as the JAX scan does, so only
        one block's fused weights exist at a time; without it the attached
        ``runtime_lora`` is fused so. ``remat_blocks`` checkpoints each
        block under a policy (`remat_policy`: True is JAX's full remat, the
        backward recomputes the block from its input stream).

        The RoPE tables are [L, head_dim//2], or [B, L, head_dim//2] per
        sample. ``seq_lens`` [B] (a ragged batch) gives each sample's valid
        token count: keys past it leave that sample's self-attention, and
        the caller keeps each sample's valid region of the output.

        With ``sp`` (a `parallel.SPContext`) the WHOLE forward is
        sequence-parallel, as the reference chunks the tokens after the
        patch embedding and gathers after the head
        (`wan_transformer3d.py:949-953, 1085-1086`): the token count is
        padded to a multiple of the seq axis (and of
        ``cfg.token_pad_multiple``) with identity RoPE and a key mask, this
        rank keeps its contiguous L/sp tokens and RoPE rows (under CFG
        parallelism also its batch rows, with their timestep modulations
        and text context), every block runs on them, and the head's output
        is all-gathered before the padding is dropped. Each rank returns
        the whole velocity. ``attn_backend`` is then the sequence-parallel
        self-attention (`make_ulysses_attention`, `make_ring_attention`).

        ``y`` [B, C', F, H, W] is concatenated to ``x`` on the channel axis
        and ``clip_fea`` [B, 257, 1280] embedded before the text context
        (i2v); ``y_camera`` [B, D, f, h, w] is added onto the patch
        embeddings (camera control)."""
        return self._run(x, t, context, rope_cos, rope_sin, attn_backend,
                         lora=lora, remat_blocks=remat_blocks,
                         seq_lens=seq_lens, sp=sp, clip_fea=clip_fea, y=y,
                         y_camera=y_camera)[0]

    @spanned("videocof.dit")
    def forward_with_residual(self, x: torch.Tensor, t: torch.Tensor,
                              context: torch.Tensor, rope_cos: torch.Tensor,
                              rope_sin: torch.Tensor,
                              attn_backend: Optional[str] = None,
                              residual: Optional[torch.Tensor] = None,
                              skip_blocks: bool = False,
                              seq_lens: Optional[torch.Tensor] = None,
                              sp=None, clip_fea: Optional[torch.Tensor] = None,
                              y: Optional[torch.Tensor] = None,
                              y_camera: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward that exposes TeaCache's token-stream residual
        (`wan_dit_forward_with_residual` with a Python-bool skip): returns
        (velocity, residual). Computing, the residual is the block stack's
        output stream minus its input; with ``skip_blocks`` the stack is
        bypassed, ``residual`` (of an earlier computed step) is added to the
        embedded stream and returned as it is, and the head still runs.
        ``seq_lens``, ``sp``, ``clip_fea``, ``y`` and ``y_camera`` as in
        `forward`; under ``sp`` the residual is this rank's shard of the
        stream, and so is the one it takes."""
        if skip_blocks and residual is None:
            raise ValueError("skip_blocks needs a cached residual")
        return self._run(x, t, context, rope_cos, rope_sin, attn_backend,
                         residual=residual, skip_blocks=skip_blocks,
                         want_residual=True, seq_lens=seq_lens, sp=sp,
                         clip_fea=clip_fea, y=y, y_camera=y_camera)

    def _run(self, x, t, context, rope_cos, rope_sin, attn_backend, lora=None,
             remat_blocks=False, residual=None, skip_blocks=False,
             want_residual=False, seq_lens=None, sp=None, clip_fea=None,
             y=None, y_camera=None):
        cfg = self.cfg
        remat = remat_policy(remat_blocks)
        if lora is None:
            lora = self.runtime_lora
        compute_dtype = _kernel_dtype(self.patch_embed)
        if y is not None:
            x = torch.cat([x, y.to(x.dtype)], dim=1)
        tokens, grid = patchify(x.to(compute_dtype), cfg.patch_size)
        hseq = _linear(tokens, self.patch_embed)
        if y_camera is not None:
            cam = y_camera.reshape(y_camera.shape[0], y_camera.shape[1], -1)
            hseq = hseq + cam.transpose(1, 2).to(hseq.dtype)

        e, e0 = self.embed_time(t)                       # [B, D], [B, 6, D]
        ctx = self.embed_text(context, clip_fea)         # [B, Lt, D]

        # pad tokens to the kernel tile and the seq axis (the tables, [L,
        # D/2] or per sample [B, L, D/2], with the identity rotation);
        # padded keys leave self-attention
        L_real = hseq.shape[1]
        seq_mask = None
        sp_on = sp is not None and (sp.size > 1 or sp.cfg_parallel)
        pad_to = math.lcm(cfg.token_pad_multiple, sp.size if sp_on else 1)
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
        if sp_on:
            # this rank's tokens (and, under CFG parallelism, batch rows);
            # the key mask stays whole over the tokens
            hseq = sp.shard_tokens(hseq)
            shard_table = sp.shard_tokens if rope_cos.dim() == 3 \
                else sp.shard_rope
            rope_cos, rope_sin = shard_table(rope_cos), shard_table(rope_sin)
            if sp.cfg_parallel:
                e, e0, ctx = (sp.shard_batch(a) for a in (e, e0, ctx))
                if seq_mask is not None:
                    seq_mask = sp.shard_batch(seq_mask)

        stream0 = hseq.to(getattr(torch, cfg.stream_dtype))
        stream = stream0
        if skip_blocks:
            stream = stream0 + residual
        for i, block in enumerate(() if skip_blocks else self.blocks):
            ad = None if lora is None else lora[0].blocks[i]
            call = functools.partial(_block_call, block, ad,
                                     None if lora is None else lora[1],
                                     attn_backend, cfg.remat_tag_names)
            args = (stream, e0, ctx, rope_cos, rope_sin, seq_mask)
            if remat is not None and torch.is_grad_enabled():
                stream = checkpoint(call, *args, use_reentrant=False, **remat)
            else:
                stream = call(*args)
        if skip_blocks:
            residual_out = residual
        else:
            residual_out = stream - stream0 if want_residual else None

        out = self.head_out(stream, e)
        if sp_on:
            out = sp.gather(out)         # the head-exit all-gather
        out = out[:, :L_real]
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
