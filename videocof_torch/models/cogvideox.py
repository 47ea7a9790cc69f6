"""CogVideoX 3D transformer, PyTorch.

Counterpart of `videocof_tpu/models/cogvideox.py` (the reference's
`videox_fun/models/cogvideox_transformer3d.py`): a joint [text | video]
sequence through every block, dual-stream AdaLN-zero (one silu + linear
over the time embedding gives shift, scale and gate for the video stream
and for the text stream), per-head LayerNorm on q and k, rotary embeddings
on the video tokens only (the 1.5 family and the 5B) or 3D sincos position
embeddings added at patch time (the 2B), an AdaLayerNorm head. The joint
self-attention goes through ``ops.attention`` (kernel B1 on the card: head
dim 64).

The residual streams are fp32; the matmuls run in the weights' dtype. The
module tree follows the JAX parameter tree (`convert.cogvideox_from_jax`),
linear weights [out, in]. ``load_cogvideox`` reads a diffusers-layout
directory (``config.json`` and safetensors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.fp8 import compute_dtype as _kernel_dtype
from . import rope as rope_lib
from ._family import FF, MLP, attend, init_uniform_, linear
from .flux import adaln
from .wan_dit import (_ScaleBias, _layer_norm, _linear, _row_linear,
                      _tp_enter, ffn_apply)


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    num_attention_heads: int = 30
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 30
    patch_size: int = 2
    patch_size_t: Optional[int] = None       # None: the 1.0 family; 2: 1.5
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = False
    rope_theta: float = 10000.0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


COGVIDEOX_2B = CogVideoXConfig()
COGVIDEOX_5B = CogVideoXConfig(num_attention_heads=48, num_layers=42,
                               use_rotary_positional_embeddings=True)
COGVIDEOX_TINY = CogVideoXConfig(num_attention_heads=4, attention_head_dim=16,
                                 in_channels=4, out_channels=4, num_layers=2,
                                 time_embed_dim=32, text_embed_dim=32,
                                 max_text_seq_length=8)


# ------------------------------------------------------------ position tables

def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000.0 ** (np.arange(dim // 2, dtype=np.float64)
                              / (dim // 2))
    out = np.einsum("p,d->pd", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, spatial_hw: Tuple[int, int],
                            temporal: int, sis: float, tis: float
                            ) -> np.ndarray:
    """[T, H*W, D] float32: a quarter of the channels temporal sincos, the
    rest spatial. As in diffusers' `get_3d_sincos_pos_embed`, the grid is
    built w first, so the first spatial half embeds w and the second h."""
    h, w = spatial_hw
    dim_t = embed_dim // 4
    dim_s = embed_dim - dim_t
    emb_h = _sincos_1d(dim_s // 2, np.arange(h, dtype=np.float64) / sis)
    emb_w = _sincos_1d(dim_s // 2, np.arange(w, dtype=np.float64) / sis)
    spatial = np.concatenate([
        np.repeat(emb_w[None, :, :], h, axis=0),
        np.repeat(emb_h[:, None, :], w, axis=1),
    ], axis=-1).reshape(h * w, dim_s)
    temporal_e = _sincos_1d(dim_t, np.arange(temporal, dtype=np.float64) / tis)
    out = np.concatenate([
        np.repeat(temporal_e[:, None, :], h * w, axis=1),
        np.repeat(spatial[None, :, :], temporal, axis=0),
    ], axis=-1)
    return out.astype(np.float32)


def get_3d_rope_cos_sin(cfg: CogVideoXConfig, grid: Tuple[int, int, int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Pairwise cos/sin tables [L, head_dim//2] (float32) of the rotary
    path: the head dim splits (t, h, w) as (d/4, 3d/8, 3d/8)."""
    f, h, w = grid
    d = cfg.attention_head_dim
    ct = d // 4 // 2
    cs = (d // 2 - ct) // 2

    def inv(c):
        dim = 2 * c
        return 1.0 / cfg.rope_theta ** (np.arange(0, dim, 2) / dim)

    ang = np.zeros((f, h, w, ct + 2 * cs))
    ang[..., :ct] = np.arange(f)[:, None, None, None] * inv(ct)
    ang[..., ct:ct + cs] = np.arange(h)[None, :, None, None] * inv(cs)
    ang[..., ct + cs:] = np.arange(w)[None, None, :, None] * inv(cs)
    ang = ang.reshape(f * h * w, -1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# -------------------------------------------------------------------- modules

class _Mod(nn.Module):
    """An AdaLN: ``lin`` (fp32) over the time embedding and the affine
    LayerNorm ``norm`` (fp32)."""

    def __init__(self, te, nout, d, device):
        super().__init__()
        self.lin = linear(te, nout, torch.float32, device)
        self.norm = _ScaleBias(d, torch.float32, device)


class _Attn(nn.Module):
    def __init__(self, d, hd, dtype, device):
        super().__init__()
        for name in ("q", "k", "v", "o"):
            setattr(self, name, linear(d, d, dtype, device))
        self.norm_q = _ScaleBias(hd, dtype, device)
        self.norm_k = _ScaleBias(hd, dtype, device)


class CogBlock(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, dtype, device):
        super().__init__()
        d, te = cfg.inner_dim, cfg.time_embed_dim
        self.norm1 = _Mod(te, 6 * d, d, device)
        self.attn = _Attn(d, cfg.attention_head_dim, dtype, device)
        self.norm2 = _Mod(te, 6 * d, d, device)
        self.ff = FF(d, dtype, device)


class CogVideoX(nn.Module):
    """Velocity (v-prediction) [B, F, C, H, W] from latents in CogVideoX's
    layout [B, F, C, H, W], text embeddings [B, Lt, text_embed_dim] and
    timesteps [B]."""

    def __init__(self, cfg: CogVideoXConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, te = cfg.inner_dim, cfg.time_embed_dim
        p, pt = cfg.patch_size, cfg.patch_size_t or 1
        self.patch_proj = linear(cfg.in_channels * p * p * pt, d, dtype,
                                 device)
        self.text_proj = linear(cfg.text_embed_dim, d, dtype, device)
        self.time_mlp = MLP(d, te, torch.float32, device)
        self.blocks = nn.ModuleList(CogBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.norm_final = _ScaleBias(d, torch.float32, device)
        self.norm_out = _Mod(te, 2 * d, d, device)
        self.proj_out = linear(d, cfg.out_channels * p * p * pt, dtype, device)

    def forward(self, hidden_states, encoder_hidden_states, timestep,
                attn_backend=None, sp=None):
        return cogvideox_forward(self, hidden_states, encoder_hidden_states,
                                 timestep, attn_backend=attn_backend, sp=sp)


@torch.no_grad()
def init_cogvideox(cfg: CogVideoXConfig, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> CogVideoX:
    """Random weights drawn from ``generator`` on its device (or
    ``device``), as the JAX init draws them (`_family.init_uniform_`)."""
    model = CogVideoX(cfg, dtype=dtype, device=device or generator.device)
    return init_uniform_(model, generator)


# ----------------------------------------------------------------- blocks

def _ln_zero(m: _Mod, x_vid, x_txt, temb, eps, tp=None):
    """CogVideoXLayerNormZero: a shared affine LayerNorm, shift, scale and
    gate per stream (under ``tp`` a column-parallel ``lin``'s output is
    gathered first, `flux.adaln`)."""
    mod = adaln(m, temb, tp)
    shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=1)
    g, b = m.norm.scale, m.norm.bias
    nv = _layer_norm(x_vid, eps, g, b) * (1 + scale[:, None]) + shift[:, None]
    nt = _layer_norm(x_txt, eps, g, b) * (1 + e_scale[:, None]) \
        + e_shift[:, None]
    return nv, nt, gate[:, None], e_gate[:, None]


def _head_ln(x, norm):
    """Per-head LayerNorm on q or k (diffusers' qk_norm 'layer_norm', eps
    1e-6 whatever the blocks' norm eps)."""
    return _layer_norm(x, 1e-6, norm.scale, norm.bias).to(x.dtype)


def cog_block_apply(block: CogBlock, cfg: CogVideoXConfig, vid, txt, temb,
                    rope_cs, attn_backend=None, seq_mask=None):
    """One block on the fp32 streams ``vid`` [B, Lv, D] and ``txt`` [B, Lt,
    D]: q, k and v projected per stream (RoPE on the video tokens only),
    joint attention over [text | video], then the joint FFN. A block cut by
    `parallel.apply_tp` runs its heads and FFN shard (``block.tp``)."""
    eps, tp = cfg.norm_eps, getattr(block, "tp", None)
    B, Lv, _ = vid.shape
    Lt = txt.shape[1]
    N = cfg.num_attention_heads // (1 if tp is None else tp.size)
    hd = cfg.attention_head_dim
    at = block.attn

    nv, nt, gate, egate = _ln_zero(block.norm1, vid, txt, temb, eps, tp)
    cdtype = _kernel_dtype(at.q)
    nt, nv = _tp_enter(nt.to(cdtype), tp), _tp_enter(nv.to(cdtype), tp)

    def heads(x, lin):
        return _linear(x, lin).view(x.shape[0], x.shape[1], N, hd)

    q_t, q_v = _head_ln(heads(nt, at.q), at.norm_q), \
        _head_ln(heads(nv, at.q), at.norm_q)
    k_t, k_v = _head_ln(heads(nt, at.k), at.norm_k), \
        _head_ln(heads(nv, at.k), at.norm_k)
    if rope_cs is not None:
        q_v = rope_lib.apply_rope(q_v, *rope_cs)
        k_v = rope_lib.apply_rope(k_v, *rope_cs)
    q = torch.cat([q_t, q_v], dim=1)
    k = torch.cat([k_t, k_v], dim=1)
    v = torch.cat([heads(nt, at.v), heads(nv, at.v)], dim=1)
    o = attend(q, k, v, seq_mask, attn_backend).reshape(B, Lt + Lv, N * hd)
    o = _row_linear(o, at.o, tp).float()
    txt = txt + egate * o[:, :Lt]
    vid = vid + gate * o[:, Lt:]

    nv, nt, gate, egate = _ln_zero(block.norm2, vid, txt, temb, eps, tp)
    joint = torch.cat([nt, nv], dim=1).to(_kernel_dtype(block.ff.fc1))
    h = ffn_apply(block.ff, joint, tp).float()
    txt = txt + egate * h[:, :Lt]
    vid = vid + gate * h[:, Lt:]
    return vid, txt


# ----------------------------------------------------------------- forward

def _timestep_embed(model: CogVideoX, t: torch.Tensor) -> torch.Tensor:
    """diffusers' Timesteps(flip_sin_to_cos=True, shift=0) and
    TimestepEmbedding, fp32."""
    half = model.cfg.inner_dim // 2
    expo = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half
    ang = t.float()[:, None] * torch.exp(expo)[None, :]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    h = _linear(emb, model.time_mlp.fc1, torch.float32)
    return _linear(F.silu(h), model.time_mlp.fc2, torch.float32)


def cogvideox_forward(model: CogVideoX, hidden_states: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      timestep: torch.Tensor, attn_backend=None,
                      sp=None) -> torch.Tensor:
    """[B, F, C, H, W] latents -> [B, F, C_out, H, W] fp32 velocity.

    With ``sp`` (a `parallel.SPContext` over more than one rank) the whole
    forward is sequence-parallel over the joint sequence: each stream is
    padded to a multiple of the seq axis (the video RoPE rows with the
    identity), both are cut to this rank's tokens, the padded keys are
    masked out of every softmax (the mask in the ranks' key order,
    `parallel.rank_major_mask`), and the streams are all-gathered after
    the blocks. ``attn_backend`` is then the sequence-parallel
    attention."""
    cfg = model.cfg
    B, Fr, C, H, W = hidden_states.shape
    p, pt = cfg.patch_size, cfg.patch_size_t or 1
    f, hh, ww = Fr // pt, H // p, W // p
    cdtype = _kernel_dtype(model.patch_proj)
    dev = hidden_states.device

    temb = _timestep_embed(model, timestep)
    # patchify: features in (C, pt, p, p) order, the 2B's per-frame conv's
    x = hidden_states.to(cdtype).permute(0, 1, 3, 4, 2)         # B F H W C
    x = x.reshape(B, f, pt, hh, p, ww, p, C)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(B, f * hh * ww, -1)
    vid = _linear(x, model.patch_proj).float()
    txt = _linear(encoder_hidden_states.to(cdtype), model.text_proj).float()
    Lt = txt.shape[1]

    rope_cs = None
    if cfg.use_rotary_positional_embeddings:
        rope_cs = tuple(torch.as_tensor(a, device=dev)
                        for a in get_3d_rope_cos_sin(cfg, (f, hh, ww)))
    else:
        pos = get_3d_sincos_pos_embed(
            cfg.inner_dim, (hh, ww), f, cfg.spatial_interpolation_scale,
            cfg.temporal_interpolation_scale).reshape(1, -1, cfg.inner_dim)
        vid = vid + torch.as_tensor(pos, device=dev)

    Lv_real = vid.shape[1]
    seq_mask = None
    sp_on = sp is not None and sp.size > 1
    if sp_on:
        from ..parallel import (joint_pad_masks, pad_rope_tables,
                                pad_stream, rank_major_mask)
        vid = pad_stream(vid, sp.size)
        txt = pad_stream(txt, sp.size)
        if rope_cs is not None:
            rope_cs = pad_rope_tables(*rope_cs, vid.shape[1])
            rope_cs = (sp.shard_rope(rope_cs[0]), sp.shard_rope(rope_cs[1]))
        if txt.shape[1] != Lt or vid.shape[1] != Lv_real:
            seq_mask = rank_major_mask(joint_pad_masks(
                B, Lt, txt.shape[1], Lv_real, vid.shape[1]).to(dev),
                txt.shape[1], sp.size)
        vid = sp.shard_tokens(vid)
        txt = sp.shard_tokens(txt)

    for block in model.blocks:
        vid, txt = cog_block_apply(block, cfg, vid, txt, temb, rope_cs,
                                   attn_backend=attn_backend,
                                   seq_mask=seq_mask)

    if sp_on:
        vid = sp.gather(vid)[:, :Lv_real]
        txt = sp.gather(txt)[:, :Lt]

    nf = model.norm_final
    if cfg.use_rotary_positional_embeddings:
        joint = _layer_norm(torch.cat([txt, vid], dim=1), cfg.norm_eps,
                            nf.scale, nf.bias)
        vid = joint[:, Lt:]
    else:
        vid = _layer_norm(vid, cfg.norm_eps, nf.scale, nf.bias)

    # AdaLayerNorm out: chunks (shift, scale), an affine inner LayerNorm
    m = _linear(F.silu(temb), model.norm_out.lin, torch.float32)
    shift, scale = m.chunk(2, dim=1)
    no = model.norm_out.norm
    vid = _layer_norm(vid, cfg.norm_eps, no.scale, no.bias) \
        * (1 + scale[:, None]) + shift[:, None]
    out = _linear(vid.to(cdtype), model.proj_out)
    # unpatchify: proj_out's features are (C, pt, p, p)
    out = out.float().reshape(B, f, hh, ww, cfg.out_channels, pt, p, p)
    out = out.permute(0, 1, 5, 4, 2, 6, 3, 7)
    return out.reshape(B, Fr, cfg.out_channels, H, W)


# ------------------------------------------------------- checkpoint loading

def convert_cogvideox_state_dict(sd: Dict[str, torch.Tensor],
                                 cfg: CogVideoXConfig, dtype=torch.float32
                                 ) -> Dict[str, torch.Tensor]:
    """A diffusers-layout ``CogVideoXTransformer3DModel`` state dict -> the
    port's, JAX's converter's dtypes: the AdaLN and time linears and the
    block LayerNorms in fp32, the rest in ``dtype``. The 2B's per-frame
    Conv2d patch weight [D, C, p, p] flattens to the pt = 1 linear."""
    out: Dict[str, torch.Tensor] = {}

    def put(dst, src, dt=dtype):
        out[dst] = sd[src].to(dt)

    def lin(dst, src, dt=dtype):
        put(f"{dst}.weight", f"{src}.weight", dt)
        put(f"{dst}.bias", f"{src}.bias", dt)

    def ln(dst, src, dt=torch.float32):
        put(f"{dst}.scale", f"{src}.weight", dt)
        put(f"{dst}.bias", f"{src}.bias", dt)

    pw = sd["patch_embed.proj.weight"]
    out["patch_proj.weight"] = pw.reshape(pw.shape[0], -1).to(dtype)
    put("patch_proj.bias", "patch_embed.proj.bias")
    lin("text_proj", "patch_embed.text_proj")
    lin("time_mlp.fc1", "time_embedding.linear_1", torch.float32)
    lin("time_mlp.fc2", "time_embedding.linear_2", torch.float32)
    for i in range(cfg.num_layers):
        pre, dst = f"transformer_blocks.{i}", f"blocks.{i}"
        for n in ("norm1", "norm2"):
            lin(f"{dst}.{n}.lin", f"{pre}.{n}.linear", torch.float32)
            ln(f"{dst}.{n}.norm", f"{pre}.{n}.norm")
        for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                     ("o", "to_out.0")):
            lin(f"{dst}.attn.{a}", f"{pre}.attn1.{b}")
        ln(f"{dst}.attn.norm_q", f"{pre}.attn1.norm_q", dtype)
        ln(f"{dst}.attn.norm_k", f"{pre}.attn1.norm_k", dtype)
        lin(f"{dst}.ff.fc1", f"{pre}.ff.net.0.proj")
        lin(f"{dst}.ff.fc2", f"{pre}.ff.net.2")
    ln("norm_final", "norm_final")
    lin("norm_out.lin", "norm_out.linear", torch.float32)
    ln("norm_out.norm", "norm_out.norm")
    lin("proj_out", "proj_out")
    return out


_CONFIG_KEYS = ("num_attention_heads", "attention_head_dim", "in_channels",
                "out_channels", "time_embed_dim", "text_embed_dim",
                "num_layers", "patch_size", "patch_size_t",
                "temporal_compression_ratio", "max_text_seq_length",
                "norm_eps", "spatial_interpolation_scale",
                "temporal_interpolation_scale",
                "use_rotary_positional_embeddings")


def load_cogvideox(model_dir: str, dtype=torch.bfloat16, quantize=None,
                   device=None) -> CogVideoX:
    """A diffusers-layout directory (``config.json`` and safetensors) ->
    `CogVideoX` on ``device``; ``quantize="fp8"`` stores its matmul
    weights in fp8 with JAX's default exclusions (the AdaLN linears, under
    'norm', and the time MLP stay)."""
    from . import weights
    from ._family import read_config
    cfg = CogVideoXConfig(**read_config(model_dir, _CONFIG_KEYS))
    sd = convert_cogvideox_state_dict(weights.load_state_dict(model_dir),
                                      cfg, dtype)
    return weights.module_from_state_dict(CogVideoX, cfg, sd, dtype, device,
                                          quantize)
