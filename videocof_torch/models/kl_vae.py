"""2D KL-VAE decoder (diffusers' ``AutoencoderKL`` layout): Flux's pixels.

Counterpart of `videocof_tpu/models/kl_vae.py`: the SD-architecture
decoder (conv_in; mid resnet, one-head attention over all channels,
resnet; up blocks of ``layers_per_block + 1`` resnets with nearest 2x
upsamplers; GroupNorm + silu + conv_out). Only the decoder, as in JAX. The
mid-block attention is plain fp32 matmul and softmax, as in JAX: one head
of 512 channels, which kernel B1 does not take. The convolutions are
cuDNN's (`F.conv2d`).

Flux's VAE (``FLUX_KL_VAE``): 16 latent channels, no quant convs, latents
mapped ``z / scaling_factor + shift_factor`` before the decode.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .wan_vae import Conv


@dataclasses.dataclass(frozen=True)
class KLVAEConfig:
    latent_channels: int = 16
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.3611
    shift_factor: Optional[float] = 0.1159
    use_post_quant_conv: bool = False
    mid_block_add_attention: bool = True

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


FLUX_KL_VAE = KLVAEConfig()
SD_KL_VAE = KLVAEConfig(latent_channels=4, scaling_factor=0.18215,
                        shift_factor=None, use_post_quant_conv=True)
KL_VAE_TINY = KLVAEConfig(latent_channels=4, block_out_channels=(8, 12),
                          layers_per_block=1, norm_num_groups=4,
                          scaling_factor=0.5, shift_factor=0.1)


# ----------------------------------------------------------------- primitives

def conv2d(x, conv: Conv, padding=1):
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=padding)


def group_norm2d(x, gn, groups: int, eps: float):
    out = F.group_norm(x.float(), groups, gn.scale.float(), gn.bias.float(),
                       eps)
    return out.to(x.dtype)


# -------------------------------------------------------------------- modules

class _GN(nn.Module):
    def __init__(self, c, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype, device=device))


class ResNet2D(nn.Module):
    def __init__(self, cin, cout, dtype, device):
        super().__init__()
        self.norm1 = _GN(cin, dtype, device)
        self.conv1 = Conv(cin, cout, (3, 3), dtype, device)
        self.norm2 = _GN(cout, dtype, device)
        self.conv2 = Conv(cout, cout, (3, 3), dtype, device)
        if cin != cout:
            self.shortcut = Conv(cin, cout, (1, 1), dtype, device)

    def forward(self, x, cfg: KLVAEConfig):
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        h = conv2d(F.silu(group_norm2d(x, self.norm1, g, eps)), self.conv1)
        h = conv2d(F.silu(group_norm2d(h, self.norm2, g, eps)), self.conv2)
        if hasattr(self, "shortcut"):
            x = conv2d(x, self.shortcut, padding=0)
        return x + h


class MidAttention(nn.Module):
    """GroupNorm, then one head over the whole channel dim with the
    spatial positions as tokens."""

    def __init__(self, c, dtype, device):
        super().__init__()
        self.norm = _GN(c, dtype, device)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, nn.Linear(c, c, dtype=dtype, device=device))

    def forward(self, x, cfg: KLVAEConfig):
        B, C, H, W = x.shape
        h = group_norm2d(x, self.norm, cfg.norm_num_groups, cfg.norm_eps)
        t = h.reshape(B, C, H * W).transpose(1, 2)            # [B, HW, C]

        def lin(m, v):
            return F.linear(v, m.weight.to(v.dtype), m.bias.to(v.dtype))

        q, k, v = lin(self.q, t), lin(self.k, t), lin(self.v, t)
        logits = (q.float() @ k.float().transpose(1, 2)) / math.sqrt(C)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        o = lin(self.proj, attn @ v)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


class _UpBlock(nn.Module):
    def __init__(self, resnets, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsample is not None:
            self.upsample = upsample


class KLVAEDecoder(nn.Module):
    def __init__(self, cfg: KLVAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = Conv(cfg.latent_channels, rev[0], (3, 3), dtype,
                            device)
        self.mid_resnet1 = ResNet2D(rev[0], rev[0], dtype, device)
        if cfg.mid_block_add_attention:
            self.mid_attn = MidAttention(rev[0], dtype, device)
        self.mid_resnet2 = ResNet2D(rev[0], rev[0], dtype, device)
        if cfg.use_post_quant_conv:
            self.post_quant_conv = Conv(cfg.latent_channels,
                                        cfg.latent_channels, (1, 1), dtype,
                                        device)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, ch in enumerate(rev):
            res = [ResNet2D(prev if j == 0 else ch, ch, dtype, device)
                   for j in range(cfg.layers_per_block + 1)]
            up = (Conv(ch, ch, (3, 3), dtype, device)
                  if i != len(rev) - 1 else None)
            self.up_blocks.append(_UpBlock(res, up))
            prev = ch
        self.norm_out = _GN(rev[-1], dtype, device)
        self.conv_out = Conv(rev[-1], cfg.out_channels, (3, 3), dtype, device)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, C_z, h, w], already unscaled -> [B, 3, 2^(n-1) h, ...],
        unclamped (as diffusers; `decode_latents` clips)."""
        cfg = self.cfg
        if cfg.use_post_quant_conv:
            z = conv2d(z, self.post_quant_conv, padding=0)
        h = conv2d(z, self.conv_in)
        h = self.mid_resnet1(h, cfg)
        if cfg.mid_block_add_attention:
            h = self.mid_attn(h, cfg)
        h = self.mid_resnet2(h, cfg)
        for blk in self.up_blocks:
            for rn in blk.resnets:
                h = rn(h, cfg)
            if hasattr(blk, "upsample"):
                h = conv2d(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                           blk.upsample)
        h = group_norm2d(h, self.norm_out, cfg.norm_num_groups, cfg.norm_eps)
        return conv2d(F.silu(h), self.conv_out)


def decode_latents(vae: KLVAEDecoder, z: torch.Tensor,
                   compute_dtype=None) -> torch.Tensor:
    """Model-space latents -> fp32 pixels clipped to [-1, 1], after the
    diffusers mapping ``z / scaling_factor + shift_factor``."""
    cfg = vae.cfg
    z = z.to(compute_dtype or z.dtype)
    z = z / cfg.scaling_factor
    if cfg.shift_factor is not None:
        z = z + cfg.shift_factor
    return vae.decode(z).float().clamp(-1.0, 1.0)


def make_decode_fn(vae: KLVAEDecoder, compute_dtype=None):
    """The ``decode_fn`` of a `FluxPipeline`: unpacked latents [B, C_z, h,
    w] -> pixels."""
    def decode_fn(z):
        with torch.no_grad():
            return decode_latents(vae, z, compute_dtype=compute_dtype)
    return decode_fn


@torch.no_grad()
def init_kl_vae_decoder(cfg: KLVAEConfig, generator: torch.Generator,
                        dtype=torch.float32, device=None) -> KLVAEDecoder:
    """Random weights as the JAX init scales them: conv kernels and
    attention projections normal / sqrt(fan_in), zero biases, unit norm
    scales, drawn from ``generator`` on its device."""
    model = KLVAEDecoder(cfg, dtype=dtype, device=device or generator.device)
    for name, p in model.named_parameters():
        if name.endswith(".weight"):
            r = torch.randn(p.shape, generator=generator,
                            device=generator.device)
            p.copy_(r / math.sqrt(p[0].numel()))
    return model


# ------------------------------------------------------- checkpoint reading

def config_from_checkpoint(vae_dir: str) -> KLVAEConfig:
    with open(os.path.join(vae_dir, "config.json")) as f:
        raw = json.load(f)
    return KLVAEConfig(
        latent_channels=raw.get("latent_channels", 4),
        out_channels=raw.get("out_channels", 3),
        block_out_channels=tuple(raw.get("block_out_channels",
                                         (128, 256, 512, 512))),
        layers_per_block=raw.get("layers_per_block", 2),
        norm_num_groups=raw.get("norm_num_groups", 32),
        scaling_factor=raw.get("scaling_factor", 0.18215),
        shift_factor=raw.get("shift_factor"),
        use_post_quant_conv=raw.get("use_post_quant_conv", True),
        mid_block_add_attention=raw.get("mid_block_add_attention", True))


def convert_kl_vae_state_dict(sd: Dict[str, torch.Tensor], cfg: KLVAEConfig,
                              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A diffusers ``AutoencoderKL`` state dict (``decoder.*``,
    ``post_quant_conv``) -> the port's decoder, every tensor in
    ``dtype``."""
    out: Dict[str, torch.Tensor] = {}

    def put(dst, src, names=("weight", "bias")):
        for a, b in zip(names, ("weight", "bias")):
            out[f"{dst}.{a}"] = sd[f"{src}.{b}"].to(dtype)

    def gn(dst, src):
        put(dst, src, ("scale", "bias"))

    def resnet(dst, src):
        gn(f"{dst}.norm1", f"{src}.norm1")
        put(f"{dst}.conv1", f"{src}.conv1")
        gn(f"{dst}.norm2", f"{src}.norm2")
        put(f"{dst}.conv2", f"{src}.conv2")
        if f"{src}.conv_shortcut.weight" in sd:
            put(f"{dst}.shortcut", f"{src}.conv_shortcut")

    d = "decoder"
    put("conv_in", f"{d}.conv_in")
    resnet("mid_resnet1", f"{d}.mid_block.resnets.0")
    resnet("mid_resnet2", f"{d}.mid_block.resnets.1")
    gn("norm_out", f"{d}.conv_norm_out")
    put("conv_out", f"{d}.conv_out")
    if cfg.mid_block_add_attention:
        a = f"{d}.mid_block.attentions.0"
        gn("mid_attn.norm", f"{a}.group_norm")
        for dst, src in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                         ("proj", "to_out.0")):
            put(f"mid_attn.{dst}", f"{a}.{src}")
    if cfg.use_post_quant_conv:
        put("post_quant_conv", "post_quant_conv")
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"up_blocks.{i}.resnets.{j}",
                   f"{d}.up_blocks.{i}.resnets.{j}")
        if f"{d}.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            put(f"up_blocks.{i}.upsample",
                f"{d}.up_blocks.{i}.upsamplers.0.conv")
    return out


def load_kl_vae(vae_dir: str, dtype=torch.bfloat16, device=None
                ) -> KLVAEDecoder:
    """A ``vae/`` directory (``config.json`` and safetensors) -> the
    decoder on ``device``."""
    from . import weights
    cfg = config_from_checkpoint(vae_dir)
    sd = convert_kl_vae_state_dict(weights.load_state_dict(vae_dir), cfg,
                                   dtype)
    return weights.module_from_state_dict(KLVAEDecoder, cfg, sd, dtype,
                                          device)
