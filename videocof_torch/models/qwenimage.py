"""QwenImage 2D transformer, PyTorch.

Counterpart of `videocof_tpu/models/qwenimage.py` (the reference's
`videox_fun/models/qwenimage_transformer2d.py`): dual-stream blocks in
which each stream derives two (shift, scale, gate) modulations from one
silu + linear over the time embedding, joint attention with separate image
and text projections and RMS q/k norms (through ``ops.attention``, B1 on
the card), an RMS-normed text input, 3-axis RoPE (`flux.rope_from_ids`),
an AdaLayerNormContinuous head. A text mask folds into a joint key mask
(B1's key-masked path). The module tree follows the JAX parameter tree
(`convert.qwenimage_from_jax`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.fp8 import compute_dtype as _kernel_dtype
from . import rope as rope_lib
from ._family import FF, MLP, Lin, attend, init_uniform_, linear
from .flux import (JointAttn, adaln, _embed, _local_heads, _proj_heads,
                   _sincos_256, rope_from_ids)
from .wan_dit import (_Weight, _layer_norm, _linear, _rms_norm, _row_linear,
                      _tp_enter, ffn_apply)


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    patch_size: int = 2
    in_channels: int = 64
    out_channels: int = 16
    num_layers: int = 60
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 3584
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 10000.0
    eps: float = 1e-6

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# JAX paths kept in high precision under fp8 (as `flux.FLUX_FP8_EXCLUDE`):
# the per-stream AdaLN linears ``img_mod`` / ``txt_mod`` (d -> 6d, about a
# third of the weights) are quantized; the time embedding, the text norm,
# the biases and the ``norm_*`` leaves are not.
QWEN_FP8_EXCLUDE = ("bias", "time_embed", "txt_norm", "norm_")

QWENIMAGE = QwenImageConfig()
QWENIMAGE_TINY = QwenImageConfig(in_channels=8, out_channels=8, num_layers=2,
                                 attention_head_dim=16,
                                 num_attention_heads=4,
                                 joint_attention_dim=32,
                                 axes_dims_rope=(4, 6, 6))


class QwenBlock(nn.Module):
    def __init__(self, cfg: QwenImageConfig, dtype, device):
        super().__init__()
        d = cfg.inner_dim
        self.img_mod = Lin(d, 6 * d, device)
        self.txt_mod = Lin(d, 6 * d, device)
        self.attn = JointAttn(d, cfg.attention_head_dim, dtype, device)
        self.img_mlp = FF(d, dtype, device)
        self.txt_mlp = FF(d, dtype, device)


class QwenImage(nn.Module):
    """Velocity [B, L_img, p*p*out_channels] from packed latents."""

    def __init__(self, cfg: QwenImageConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.inner_dim
        self.img_in = linear(cfg.in_channels, d, dtype, device)
        self.txt_in = linear(cfg.joint_attention_dim, d, dtype, device)
        self.txt_norm = _Weight(cfg.joint_attention_dim, dtype, device)
        self.time_embed = MLP(256, d, torch.float32, device)
        self.blocks = nn.ModuleList(QwenBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.norm_out = Lin(d, 2 * d, device)
        self.proj_out = linear(d, cfg.patch_size ** 2 * cfg.out_channels,
                               dtype, device)

    def forward(self, hidden_states, encoder_hidden_states, timestep,
                img_ids, txt_ids, encoder_hidden_states_mask=None,
                attn_backend=None, sp=None):
        return qwenimage_forward(
            self, hidden_states, encoder_hidden_states, timestep, img_ids,
            txt_ids, encoder_hidden_states_mask=encoder_hidden_states_mask,
            attn_backend=attn_backend, sp=sp)


@torch.no_grad()
def init_qwenimage(cfg: QwenImageConfig, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> QwenImage:
    """Random weights drawn from ``generator`` on its device (or
    ``device``), as the JAX init draws them (`_family.init_uniform_`)."""
    model = QwenImage(cfg, dtype=dtype, device=device or generator.device)
    return init_uniform_(model, generator)


def qwen_position_ids(grid_fhw: Tuple[int, int, int], txt_len: int,
                      scale_rope: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image ids [f*h*w, 3], text ids [txt_len, 3]) float32, as the
    reference's `QwenEmbedRope`: image ids (frame, h, w), with
    ``scale_rope`` h and w centred on zero (index -k on the negative side);
    text ids on all three axes from ``max_vid_index`` up."""
    f, h, w = grid_fhw
    fi = np.arange(f)
    hi = (np.concatenate([np.arange(-(h - h // 2), 0), np.arange(h // 2)])
          if scale_rope else np.arange(h))
    wi = (np.concatenate([np.arange(-(w - w // 2), 0), np.arange(w // 2)])
          if scale_rope else np.arange(w))
    img = np.stack(np.meshgrid(fi, hi, wi, indexing="ij"),
                   axis=-1).reshape(f * h * w, 3)
    mx = max(h // 2, w // 2) if scale_rope else max(h, w)
    txt = mx + np.arange(txt_len)
    txt = np.stack([txt, txt, txt], axis=-1)
    return (torch.as_tensor(img, dtype=torch.float32),
            torch.as_tensor(txt, dtype=torch.float32))


def _modulate(x, mod, eps):
    """mod [B, 3D] -> (modulated x, gate): chunks (shift, scale, gate)."""
    shift, scale, gate = mod.chunk(3, dim=-1)
    return (_layer_norm(x, eps) * (1 + scale[:, None]) + shift[:, None],
            gate[:, None])


def qwen_block_apply(block: QwenBlock, cfg: QwenImageConfig, img, txt, temb,
                     rope_cs, txt_mask=None, attn_backend=None,
                     seq_mask=None):
    """One dual-stream block; a block cut by `parallel.apply_tp` runs its
    heads and MLP shard (``block.tp``), its AdaLN outputs gathered."""
    eps, tp = cfg.eps, getattr(block, "tp", None)
    N, hd = _local_heads(cfg, tp), cfg.attention_head_dim
    B, Li, _ = img.shape
    Lt = txt.shape[1]
    at = block.attn
    cdtype = _kernel_dtype(at.q)

    im1, im2 = adaln(block.img_mod, temb, tp).chunk(2, dim=-1)
    tm1, tm2 = adaln(block.txt_mod, temb, tp).chunk(2, dim=-1)
    ni, ig1 = _modulate(img, im1, eps)
    nt, tg1 = _modulate(txt, tm1, eps)
    ni, nt = _tp_enter(ni.to(cdtype), tp), _tp_enter(nt.to(cdtype), tp)

    q = torch.cat([_proj_heads(nt, at.add_q, at.norm_added_q, N, hd, eps),
                   _proj_heads(ni, at.q, at.norm_q, N, hd, eps)], dim=1)
    k = torch.cat([_proj_heads(nt, at.add_k, at.norm_added_k, N, hd, eps),
                   _proj_heads(ni, at.k, at.norm_k, N, hd, eps)], dim=1)
    v = torch.cat([_proj_heads(nt, at.add_v, None, N, hd, eps),
                   _proj_heads(ni, at.v, None, N, hd, eps)], dim=1)
    if rope_cs is not None:
        q = rope_lib.apply_rope(q, *rope_cs)
        k = rope_lib.apply_rope(k, *rope_cs)
    mask = seq_mask
    if mask is None and txt_mask is not None:
        mask = torch.cat([txt_mask.bool(),
                          torch.ones(B, Li, dtype=torch.bool,
                                     device=img.device)], dim=1)
    o = attend(q, k, v, mask, attn_backend).reshape(B, Lt + Li, N * hd)
    o_txt = _row_linear(o[:, :Lt], at.add_o, tp).float()
    o_img = _row_linear(o[:, Lt:], at.o, tp).float()
    img = img + ig1 * o_img
    txt = txt + tg1 * o_txt

    ni, ig2 = _modulate(img, im2, eps)
    img = img + ig2 * ffn_apply(block.img_mlp, ni.to(cdtype), tp).float()
    nt, tg2 = _modulate(txt, tm2, eps)
    txt = txt + tg2 * ffn_apply(block.txt_mlp, nt.to(cdtype), tp).float()
    return img, txt


def qwenimage_forward(model: QwenImage, hidden_states: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      timestep: torch.Tensor, img_ids: torch.Tensor,
                      txt_ids: torch.Tensor,
                      encoder_hidden_states_mask: Optional[
                          torch.Tensor] = None,
                      attn_backend=None, sp=None) -> torch.Tensor:
    """Packed latents [B, L_img, in_channels], text [B, L_txt,
    joint_attention_dim], timesteps [B] in [0, 1], ids [L, 3] -> velocity
    [B, L_img, p*p*out_channels] fp32. ``encoder_hidden_states_mask`` [B,
    L_txt] (True = a real token) takes the padded text keys out of the
    joint softmax. With ``sp`` over more than one rank the forward is
    sequence-parallel as `flux.flux_forward`, the text mask folded into
    the padding's."""
    cfg = model.cfg
    cdtype = _kernel_dtype(model.img_in)
    img = _linear(hidden_states.to(cdtype), model.img_in).float()
    txt = _rms_norm(encoder_hidden_states.to(cdtype), model.txt_norm.weight,
                    1e-6)
    txt = _linear(txt, model.txt_in).float()
    temb = _embed(model.time_embed, _sincos_256(timestep * 1000.0))

    Lt_real, Li_real = txt.shape[1], img.shape[1]
    seq_mask = None
    sp_on = sp is not None and sp.size > 1
    if sp_on:
        from ..parallel import joint_pad_masks, pad_stream, rank_major_mask
        img = pad_stream(img, sp.size)
        txt = pad_stream(txt, sp.size)
        txt_ids = F.pad(txt_ids, (0, 0, 0, txt.shape[1] - Lt_real))
        img_ids = F.pad(img_ids, (0, 0, 0, img.shape[1] - Li_real))
        padded = txt.shape[1] != Lt_real or img.shape[1] != Li_real
        if padded or encoder_hidden_states_mask is not None:
            lt = (encoder_hidden_states_mask
                  if encoder_hidden_states_mask is not None else Lt_real)
            seq_mask = rank_major_mask(joint_pad_masks(
                img.shape[0], lt, txt.shape[1], Li_real,
                img.shape[1]).to(img.device), txt.shape[1], sp.size)
        img = sp.shard_tokens(img)
        txt = sp.shard_tokens(txt)

    if sp_on:
        # this rank's tokens are its text shard, then its image shard
        rope_cs = tuple(torch.cat([sp.shard_rope(t), sp.shard_rope(i)])
                        for t, i in zip(rope_from_ids(cfg, txt_ids),
                                        rope_from_ids(cfg, img_ids)))
    else:
        rope_cs = rope_from_ids(cfg, torch.cat([txt_ids, img_ids], dim=0))

    for block in model.blocks:
        img, txt = qwen_block_apply(block, cfg, img, txt, temb, rope_cs,
                                    txt_mask=encoder_hidden_states_mask,
                                    attn_backend=attn_backend,
                                    seq_mask=seq_mask)
    if sp_on:
        img = sp.gather(img)[:, :Li_real]

    scale, shift = _linear(F.silu(temb), model.norm_out.lin,
                           torch.float32).chunk(2, dim=1)
    img = _layer_norm(img, 1e-6) * (1 + scale[:, None]) + shift[:, None]
    return _linear(img.to(cdtype), model.proj_out).float()


# --------------------------------------------------------- checkpoint loading

def convert_qwenimage_state_dict(sd: Dict[str, torch.Tensor],
                                 cfg: QwenImageConfig, dtype=torch.float32
                                 ) -> Dict[str, torch.Tensor]:
    """A diffusers-layout ``QwenImageTransformer2DModel`` state dict -> the
    port's (the per-stream modulation is ``nn.Sequential(SiLU, Linear)``,
    hence ``img_mod.1``); the AdaLN and time linears in fp32, the rest in
    ``dtype``."""
    out: Dict[str, torch.Tensor] = {}
    f32 = torch.float32

    def lin(dst, src, dt=dtype):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].to(dt)
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = sd[f"{src}.bias"].to(dt)

    lin("img_in", "img_in")
    lin("txt_in", "txt_in")
    out["txt_norm.weight"] = sd["txt_norm.weight"].to(dtype)
    lin("time_embed.fc1", "time_text_embed.timestep_embedder.linear_1", f32)
    lin("time_embed.fc2", "time_text_embed.timestep_embedder.linear_2", f32)
    for i in range(cfg.num_layers):
        pre, dst = f"transformer_blocks.{i}", f"blocks.{i}"
        lin(f"{dst}.img_mod.lin", f"{pre}.img_mod.1", f32)
        lin(f"{dst}.txt_mod.lin", f"{pre}.txt_mod.1", f32)
        for a, b in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                     ("o", "to_out.0"), ("add_q", "add_q_proj"),
                     ("add_k", "add_k_proj"), ("add_v", "add_v_proj"),
                     ("add_o", "to_add_out")):
            lin(f"{dst}.attn.{a}", f"{pre}.attn.{b}")
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            out[f"{dst}.attn.{n}.weight"] = sd[f"{pre}.attn.{n}.weight"].to(
                dtype)
        for mlp in ("img_mlp", "txt_mlp"):
            lin(f"{dst}.{mlp}.fc1", f"{pre}.{mlp}.net.0.proj")
            lin(f"{dst}.{mlp}.fc2", f"{pre}.{mlp}.net.2")
    lin("norm_out.lin", "norm_out.linear", f32)
    lin("proj_out", "proj_out")
    return out


_CONFIG_KEYS = ("patch_size", "in_channels", "out_channels", "num_layers",
                "attention_head_dim", "num_attention_heads",
                "joint_attention_dim", "axes_dims_rope")


def load_qwenimage(model_dir: str, dtype=torch.bfloat16, quantize=None,
                   device=None) -> QwenImage:
    """A diffusers-layout directory -> `QwenImage` on ``device``; with
    ``quantize="fp8"`` the weights outside ``QWEN_FP8_EXCLUDE`` are shipped
    and quantized one at a time. The full model (60 layers of 3072) is
    about 20B parameters: about 41 GB in bf16, which one 80 GB card
    holds."""
    from . import weights
    from ._family import read_config
    cfg = QwenImageConfig(**read_config(model_dir, _CONFIG_KEYS,
                                        tuples=("axes_dims_rope",)))
    sd = convert_qwenimage_state_dict(weights.load_state_dict(model_dir),
                                      cfg, dtype)
    return weights.module_from_state_dict(QwenImage, cfg, sd, dtype,
                                          device, quantize,
                                          exclude=QWEN_FP8_EXCLUDE)
