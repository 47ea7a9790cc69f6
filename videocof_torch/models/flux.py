"""Flux 2D transformer, PyTorch.

Counterpart of `videocof_tpu/models/flux.py` (the reference's
`videox_fun/models/flux_transformer2d.py`): double-stream MMDiT blocks
(separate image and text projections, one joint attention, an
AdaLayerNormZero per stream), then single-stream blocks (attention and an
MLP in parallel over the joint sequence, their outputs concatenated before
``proj_out``), 3-axis RoPE from the image and text position ids, the
timestep, pooled-text and (Flux-dev) guidance embeddings summed, an
AdaLayerNormContinuous head. Text tokens go first in the joint sequence.
Every attention goes through ``ops.attention`` (B1 on the card).

Chunk orders as diffusers': AdaLayerNormZero (shift, scale, gate) for the
attention and then for the MLP; the single blocks' (shift, scale, gate);
AdaLayerNormContinuous (scale, shift). The module tree follows the JAX
parameter tree (`convert.flux_from_jax`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.fp8 import compute_dtype as _kernel_dtype
from . import rope as rope_lib
from ._family import FF, MLP, Lin, attend, init_uniform_, linear
from .wan_dit import (_Weight, _layer_norm, _linear, _rms_norm, _row_linear,
                      _tp_enter, ffn_apply)


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    patch_size: int = 1
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19            # double-stream blocks
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = False
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 10000.0
    eps: float = 1e-6

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# JAX paths kept in high precision under fp8: the global embedders, the
# biases and the ``norm_*`` leaves (the head's modulation, the q/k RMS
# weights). Unlike Wan's, Flux's AdaLN linears (``norm1``,
# ``norm1_context``, the single blocks' ``norm``) are full d -> 6d (3d)
# matmuls, about a quarter of the weights, and are quantized.
FLUX_FP8_EXCLUDE = ("bias", "time_embed", "text_embed", "guidance_embed",
                    "norm_")

FLUX_DEV = FluxConfig(guidance_embeds=True)
FLUX_TINY = FluxConfig(in_channels=8, out_channels=8, num_layers=2,
                       num_single_layers=2, attention_head_dim=16,
                       num_attention_heads=4, joint_attention_dim=32,
                       pooled_projection_dim=16, axes_dims_rope=(4, 6, 6))


def rope_from_ids(cfg, ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position ids [L, n_axes] -> pairwise cos/sin [L, head_dim//2], fp32
    (FluxPosEmbed: each axis its ``axes_dims_rope`` channels)."""
    parts_c, parts_s = [], []
    for i, d in enumerate(cfg.axes_dims_rope):
        inv = 1.0 / cfg.rope_theta ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d)
        ang = ids[:, i].float()[:, None] * inv[None, :]
        parts_c.append(torch.cos(ang))
        parts_s.append(torch.sin(ang))
    return torch.cat(parts_c, dim=-1), torch.cat(parts_s, dim=-1)


def _sincos_256(t: torch.Tensor) -> torch.Tensor:
    """diffusers' Timesteps(256, flip_sin_to_cos=True, shift=0), fp32."""
    half = 128
    expo = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half
    ang = t.float()[:, None] * torch.exp(expo)[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# -------------------------------------------------------------------- modules

class JointAttn(nn.Module):
    """q, k, v (and o) of the image stream, ``add_*`` of the text stream,
    RMS weights of q and k per stream; the single blocks' has no ``o`` and
    no text stream."""

    def __init__(self, d, hd, dtype, device, joint: bool = True):
        super().__init__()
        names = ("q", "k", "v", "o", "add_q", "add_k", "add_v", "add_o") \
            if joint else ("q", "k", "v")
        for name in names:
            setattr(self, name, linear(d, d, dtype, device))
        norms = ("norm_q", "norm_k", "norm_added_q", "norm_added_k") \
            if joint else ("norm_q", "norm_k")
        for name in norms:
            setattr(self, name, _Weight(hd, dtype, device))


class DualBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, dtype, device):
        super().__init__()
        d = cfg.inner_dim
        self.norm1 = Lin(d, 6 * d, device)
        self.norm1_context = Lin(d, 6 * d, device)
        self.attn = JointAttn(d, cfg.attention_head_dim, dtype, device)
        self.ff = FF(d, dtype, device)
        self.ff_context = FF(d, dtype, device)


class SingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, dtype, device):
        super().__init__()
        d = cfg.inner_dim
        self.norm = Lin(d, 3 * d, device)
        self.attn = JointAttn(d, cfg.attention_head_dim, dtype, device,
                              joint=False)
        self.proj_mlp = linear(d, 4 * d, dtype, device)
        self.proj_out = linear(5 * d, d, dtype, device)


class Flux(nn.Module):
    """Velocity [B, L_img, out_channels] from packed latents."""

    def __init__(self, cfg: FluxConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.inner_dim
        f32 = torch.float32
        self.x_embedder = linear(cfg.in_channels, d, dtype, device)
        self.context_embedder = linear(cfg.joint_attention_dim, d, dtype,
                                       device)
        self.time_embed = MLP(256, d, f32, device)
        self.text_embed = MLP(cfg.pooled_projection_dim, d, f32, device)
        self.blocks = nn.ModuleList(DualBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, dtype, device)
            for _ in range(cfg.num_single_layers))
        self.norm_out = Lin(d, 2 * d, device)
        self.proj_out = linear(d, cfg.patch_size ** 2 * cfg.out_channels,
                               dtype, device)
        if cfg.guidance_embeds:
            self.guidance_embed = MLP(256, d, f32, device)

    def forward(self, hidden_states, encoder_hidden_states,
                pooled_projections, timestep, img_ids, txt_ids,
                guidance=None, attn_backend=None, sp=None):
        return flux_forward(self, hidden_states, encoder_hidden_states,
                            pooled_projections, timestep, img_ids, txt_ids,
                            guidance=guidance, attn_backend=attn_backend,
                            sp=sp)


@torch.no_grad()
def init_flux(cfg: FluxConfig, generator: torch.Generator,
              dtype=torch.float32, device=None) -> Flux:
    """Random weights drawn from ``generator`` on its device (or
    ``device``), as the JAX init draws them (`_family.init_uniform_`)."""
    model = Flux(cfg, dtype=dtype, device=device or generator.device)
    return init_uniform_(model, generator)


# --------------------------------------------------------------------- blocks

def adaln(m: nn.Module, temb, tp=None):
    """silu(temb) through an AdaLN's linear ``m.lin``, in fp32; one that
    `parallel.apply_tp` cut column-parallel (a contiguous slice of [shift
    | scale | gate | ...]) is all-gathered whole before it is chunked."""
    lin, x = m.lin, F.silu(temb)
    if tp is None or lin.weight.shape[0] == lin.out_features:
        return _linear(x, lin, torch.float32)
    return tp.gather_cols(_linear(_tp_enter(x, tp), lin, torch.float32))


def _ada_zero(m: Lin, temb, n_chunks, tp=None):
    return adaln(m, temb, tp).chunk(n_chunks, dim=1)


def _proj_heads(x, lin, norm, N, hd, eps):
    h = _linear(x, lin).view(x.shape[0], x.shape[1], N, hd)
    if norm is not None:
        h = _rms_norm(h, norm.weight, eps)
    return h


def _mod(x, shift, scale):
    return _layer_norm(x, 1e-6) * (1 + scale[:, None]) + shift[:, None]


def _local_heads(cfg, tp):
    return cfg.num_attention_heads // (1 if tp is None else tp.size)


def flux_dual_block(block: DualBlock, cfg: FluxConfig, img, txt, temb,
                    rope_cs, attn_backend=None, seq_mask=None):
    """One double-stream block; a block cut by `parallel.apply_tp` runs
    its heads and MLP shard (``block.tp``)."""
    eps, tp = cfg.eps, getattr(block, "tp", None)
    N, hd = _local_heads(cfg, tp), cfg.attention_head_dim
    B, Li, _ = img.shape
    Lt = txt.shape[1]
    at = block.attn
    cdtype = _kernel_dtype(at.q)

    sh, sc, g_msa, sh_m, sc_m, g_mlp = _ada_zero(block.norm1, temb, 6, tp)
    csh, csc, cg_msa, csh_m, csc_m, cg_mlp = _ada_zero(block.norm1_context,
                                                       temb, 6, tp)
    ni = _tp_enter(_mod(img, sh, sc).to(cdtype), tp)
    nt = _tp_enter(_mod(txt, csh, csc).to(cdtype), tp)

    q = torch.cat([_proj_heads(nt, at.add_q, at.norm_added_q, N, hd, eps),
                   _proj_heads(ni, at.q, at.norm_q, N, hd, eps)], dim=1)
    k = torch.cat([_proj_heads(nt, at.add_k, at.norm_added_k, N, hd, eps),
                   _proj_heads(ni, at.k, at.norm_k, N, hd, eps)], dim=1)
    v = torch.cat([_proj_heads(nt, at.add_v, None, N, hd, eps),
                   _proj_heads(ni, at.v, None, N, hd, eps)], dim=1)
    if rope_cs is not None:
        q = rope_lib.apply_rope(q, *rope_cs)
        k = rope_lib.apply_rope(k, *rope_cs)
    o = attend(q, k, v, seq_mask, attn_backend).reshape(B, Lt + Li, N * hd)
    o_txt = _row_linear(o[:, :Lt], at.add_o, tp).float()
    o_img = _row_linear(o[:, Lt:], at.o, tp).float()

    img = img + g_msa[:, None] * o_img
    img = img + g_mlp[:, None] * ffn_apply(
        block.ff, _mod(img, sh_m, sc_m).to(cdtype), tp).float()
    txt = txt + cg_msa[:, None] * o_txt
    txt = txt + cg_mlp[:, None] * ffn_apply(
        block.ff_context, _mod(txt, csh_m, csc_m).to(cdtype), tp).float()
    return img, txt


def flux_single_block(block: SingleBlock, cfg: FluxConfig, x, temb, rope_cs,
                      attn_backend=None, seq_mask=None):
    """One single-stream block; under ``block.tp`` the attention features
    and the MLP's are this rank's shards, which ``proj_out``'s split rows
    contract (`parallel.tp`)."""
    eps, tp = cfg.eps, getattr(block, "tp", None)
    N, hd = _local_heads(cfg, tp), cfg.attention_head_dim
    B, L, _ = x.shape
    at = block.attn
    cdtype = _kernel_dtype(at.q)

    sh, sc, gate = _ada_zero(block.norm, temb, 3, tp)
    nx = _tp_enter(_mod(x, sh, sc).to(cdtype), tp)
    q = _proj_heads(nx, at.q, at.norm_q, N, hd, eps)
    k = _proj_heads(nx, at.k, at.norm_k, N, hd, eps)
    v = _proj_heads(nx, at.v, None, N, hd, eps)
    if rope_cs is not None:
        q = rope_lib.apply_rope(q, *rope_cs)
        k = rope_lib.apply_rope(k, *rope_cs)
    att = attend(q, k, v, seq_mask, attn_backend).reshape(B, L, N * hd)
    mlp = F.gelu(_linear(nx, block.proj_mlp), approximate="tanh")
    out = _row_linear(torch.cat([att, mlp], dim=-1), block.proj_out,
                      tp).float()
    return x + gate[:, None] * out


# -------------------------------------------------------------------- forward

def _embed(mlp: MLP, x):
    h = _linear(x, mlp.fc1, torch.float32)
    return _linear(F.silu(h), mlp.fc2, torch.float32)


def flux_forward(model: Flux, hidden_states: torch.Tensor,
                 encoder_hidden_states: torch.Tensor,
                 pooled_projections: torch.Tensor, timestep: torch.Tensor,
                 img_ids: torch.Tensor, txt_ids: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None, attn_backend=None,
                 sp=None) -> torch.Tensor:
    """Packed latents [B, L_img, in_channels], text [B, L_txt,
    joint_attention_dim], pooled text [B, pooled_projection_dim],
    timesteps [B] in [0, 1], ids [L, 3] -> velocity [B, L_img,
    out_channels] fp32. With ``sp`` over more than one rank the forward is
    sequence-parallel over the joint sequence (each stream padded to the
    seq axis, zero ids for the padding: the identity rotation, the padded
    keys masked in the ranks' key order, `parallel.rank_major_mask`)."""
    cfg = model.cfg
    cdtype = _kernel_dtype(model.x_embedder)
    img = _linear(hidden_states.to(cdtype), model.x_embedder).float()
    txt = _linear(encoder_hidden_states.to(cdtype),
                  model.context_embedder).float()

    Lt_real, Li_real = txt.shape[1], img.shape[1]
    seq_mask = None
    sp_on = sp is not None and sp.size > 1
    if sp_on:
        from ..parallel import joint_pad_masks, pad_stream, rank_major_mask
        img = pad_stream(img, sp.size)
        txt = pad_stream(txt, sp.size)
        txt_ids = F.pad(txt_ids, (0, 0, 0, txt.shape[1] - Lt_real))
        img_ids = F.pad(img_ids, (0, 0, 0, img.shape[1] - Li_real))
        if txt.shape[1] != Lt_real or img.shape[1] != Li_real:
            seq_mask = rank_major_mask(joint_pad_masks(
                img.shape[0], Lt_real, txt.shape[1], Li_real,
                img.shape[1]).to(img.device), txt.shape[1], sp.size)
        img = sp.shard_tokens(img)
        txt = sp.shard_tokens(txt)

    temb = _embed(model.time_embed, _sincos_256(timestep * 1000.0))
    temb = temb + _embed(model.text_embed, pooled_projections.float())
    if guidance is not None and hasattr(model, "guidance_embed"):
        temb = temb + _embed(model.guidance_embed,
                             _sincos_256(guidance * 1000.0))

    if sp_on:
        # this rank's tokens are its text shard, then its image shard
        rope_cs = tuple(torch.cat([sp.shard_rope(t), sp.shard_rope(i)])
                        for t, i in zip(rope_from_ids(cfg, txt_ids),
                                        rope_from_ids(cfg, img_ids)))
    else:
        rope_cs = rope_from_ids(cfg, torch.cat([txt_ids, img_ids], dim=0))

    for block in model.blocks:
        img, txt = flux_dual_block(block, cfg, img, txt, temb, rope_cs,
                                   attn_backend=attn_backend,
                                   seq_mask=seq_mask)
    x = torch.cat([txt, img], dim=1)
    for block in model.single_blocks:
        x = flux_single_block(block, cfg, x, temb, rope_cs,
                              attn_backend=attn_backend, seq_mask=seq_mask)
    img = x[:, txt.shape[1]:]
    if sp_on:
        img = sp.gather(img)[:, :Li_real]

    # AdaLayerNormContinuous: chunks (scale, shift)
    scale, shift = _linear(F.silu(temb), model.norm_out.lin,
                           torch.float32).chunk(2, dim=1)
    img = _layer_norm(img, 1e-6) * (1 + scale[:, None]) + shift[:, None]
    return _linear(img.to(cdtype), model.proj_out).float()


# --------------------------------------------------------- checkpoint loading

def convert_flux_state_dict(sd: Dict[str, torch.Tensor], cfg: FluxConfig,
                            dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A diffusers-layout ``FluxTransformer2DModel`` state dict -> the
    port's, in JAX's converter's dtypes (the AdaLN and embedding MLPs in
    fp32, the rest in ``dtype``)."""
    out: Dict[str, torch.Tensor] = {}
    f32 = torch.float32

    def lin(dst, src, dt=dtype):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].to(dt)
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = sd[f"{src}.bias"].to(dt)

    def rms(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].to(dtype)

    lin("x_embedder", "x_embedder")
    lin("context_embedder", "context_embedder")
    tte = "time_text_embed"
    for dst, src in (("time_embed", "timestep_embedder"),
                     ("text_embed", "text_embedder"),
                     ("guidance_embed", "guidance_embedder")):
        if f"{tte}.{src}.linear_1.weight" in sd:
            lin(f"{dst}.fc1", f"{tte}.{src}.linear_1", f32)
            lin(f"{dst}.fc2", f"{tte}.{src}.linear_2", f32)
    for i in range(cfg.num_layers):
        pre, dst = f"transformer_blocks.{i}", f"blocks.{i}"
        lin(f"{dst}.norm1.lin", f"{pre}.norm1.linear", f32)
        lin(f"{dst}.norm1_context.lin", f"{pre}.norm1_context.linear", f32)
        for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                     ("o", "to_out.0"), ("add_q", "add_q_proj"),
                     ("add_k", "add_k_proj"), ("add_v", "add_v_proj"),
                     ("add_o", "to_add_out")):
            lin(f"{dst}.attn.{a}", f"{pre}.attn.{b}")
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            rms(f"{dst}.attn.{n}", f"{pre}.attn.{n}")
        for ff in ("ff", "ff_context"):
            lin(f"{dst}.{ff}.fc1", f"{pre}.{ff}.net.0.proj")
            lin(f"{dst}.{ff}.fc2", f"{pre}.{ff}.net.2")
    for i in range(cfg.num_single_layers):
        pre, dst = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        lin(f"{dst}.norm.lin", f"{pre}.norm.linear", f32)
        for a in ("q", "k", "v"):
            lin(f"{dst}.attn.{a}", f"{pre}.attn.to_{a}")
        for n in ("norm_q", "norm_k"):
            rms(f"{dst}.attn.{n}", f"{pre}.attn.{n}")
        lin(f"{dst}.proj_mlp", f"{pre}.proj_mlp")
        lin(f"{dst}.proj_out", f"{pre}.proj_out")
    lin("norm_out.lin", "norm_out.linear", f32)
    lin("proj_out", "proj_out")
    return out


_CONFIG_KEYS = ("patch_size", "in_channels", "out_channels", "num_layers",
                "num_single_layers", "attention_head_dim",
                "num_attention_heads", "joint_attention_dim",
                "pooled_projection_dim", "guidance_embeds", "axes_dims_rope")


def flux_config_from_checkpoint(model_dir: str) -> FluxConfig:
    from ._family import read_config
    kw = read_config(model_dir, _CONFIG_KEYS, tuples=("axes_dims_rope",))
    kw.setdefault("out_channels", kw.get("in_channels", 64))
    return FluxConfig(**kw)


def load_flux(model_dir: str, dtype=torch.bfloat16, quantize=None,
              device=None) -> Flux:
    """A diffusers-layout directory -> `Flux` on ``device``. With
    ``quantize="fp8"`` each matmul weight outside ``FLUX_FP8_EXCLUDE`` is
    shipped and quantized one at a time (the bf16 model never exists on the
    card), as JAX quantizes on the host before the ship."""
    from . import weights
    cfg = flux_config_from_checkpoint(model_dir)
    sd = convert_flux_state_dict(weights.load_state_dict(model_dir), cfg,
                                 dtype)
    return weights.module_from_state_dict(Flux, cfg, sd, dtype, device,
                                          quantize, exclude=FLUX_FP8_EXCLUDE)
