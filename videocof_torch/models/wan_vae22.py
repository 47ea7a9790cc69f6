"""The Wan2.2 video VAE of the TI2V-5B, PyTorch, whole-sequence.

Counterpart of `videocof_tpu/models/wan_vae22.py` (the reference's
`wan_vae3_8.py`): a 2x2 pixel patchify in front of the encoder (3 -> 12
channels, so 2x of the 16x spatial compression is free), Down/Up stages whose
parameter-free AvgDown3D / DupUp3D shortcuts add a space-time pooled (or
duplicated) copy of the stage's input, channel-preserving resamples,
encoder dim 160 / decoder dim 256, 48 latent channels. Every block and
primitive is the port's Wan2.1 VAE's (`wan_vae.py`), as JAX reuses its own;
module names follow the JAX tree (`convert.vae_from_jax`). The streaming
twin is `wan_vae22_streaming.py`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Wan22VAEConfig
from . import wan_vae as W


# ----------------------------------------------------------------- primitives

def patchify2(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, C*p*p, T, H/p, W/p], channel order (c, r, q):
    r indexes within W, q within H ('b c f (h q) (w r) -> b (c r q) f h
    w')."""
    if p == 1:
        return x
    B, C, T, H, Wd = x.shape
    x = x.reshape(B, C, T, H // p, p, Wd // p, p).permute(0, 1, 6, 4, 2, 3, 5)
    return x.reshape(B, C * p * p, T, H // p, Wd // p)


def unpatchify2(x: torch.Tensor, p: int) -> torch.Tensor:
    """The inverse of `patchify2`."""
    if p == 1:
        return x
    B, CP, T, H, Wd = x.shape
    x = x.reshape(B, CP // (p * p), p, p, T, H, Wd).permute(0, 1, 4, 5, 3, 6,
                                                            2)
    return x.reshape(B, CP // (p * p), T, H * p, Wd * p)


def avg_down3d(x: torch.Tensor, out_channels: int, factor_t: int,
               factor_s: int) -> torch.Tensor:
    """Parameter-free space-time average pool with channel regrouping;
    time is front-padded with zeros to a multiple of ``factor_t``."""
    B, C, T, H, Wd = x.shape
    pad_t = (factor_t - T % factor_t) % factor_t
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        T += pad_t
    f = factor_t * factor_s * factor_s
    t, h, w = T // factor_t, H // factor_s, Wd // factor_s
    x = x.reshape(B, C, t, factor_t, h, factor_s, w, factor_s)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(B, C * f, t, h, w)
    return x.reshape(B, out_channels, C * f // out_channels, t, h, w).mean(2)


def dup_up3d(x: torch.Tensor, out_channels: int, factor_t: int,
             factor_s: int, trim_first: bool = True) -> torch.Tensor:
    """Channel-duplicating space-time unpool; ``trim_first`` drops the
    ``factor_t - 1`` duplicated leading frames (the first chunk's trim)."""
    B, C, T, H, Wd = x.shape
    x = x.repeat_interleave(out_channels * factor_t * factor_s * factor_s
                            // C, dim=1)
    x = x.reshape(B, out_channels, factor_t, factor_s, factor_s, T, H, Wd)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(
        B, out_channels, T * factor_t, H * factor_s, Wd * factor_s)
    if trim_first and factor_t > 1:
        x = x[:, :, factor_t - 1:]
    return x


# --------------------------------------------------------------------- stages

def _enc_dims(cfg: Wan22VAEConfig):
    return [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]


def _dec_dims(cfg: Wan22VAEConfig):
    return [cfg.dec_dim * u for u in
            (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]


def _flag(flags, i):
    return flags[i] if i < len(flags) else False


def down_stage(stage: W.Stage, x, tdown: bool, cout: int):
    """A Down stage: residual blocks and the resample, plus the
    AvgDown3D shortcut of the stage's input."""
    h = x
    for rb in stage.res:
        h = rb(h)
    down = hasattr(stage, "resample")
    if down:
        if tdown:
            h = W.encoder_downsample3d(h, stage.resample)
        else:
            h = W._spatial_down(h, stage.resample.conv)
    return h + avg_down3d(x, cout, factor_t=2 if (tdown and down) else 1,
                          factor_s=2 if down else 1)


def up_stage(stage: W.Stage, x, tup: bool, cout: int):
    """An Up stage: residual blocks and the resample, plus the DupUp3D
    shortcut of the stage's input (none on the last stage)."""
    h = x
    for rb in stage.res:
        h = rb(h)
    if not hasattr(stage, "resample"):
        return h
    if tup:
        h = W.decoder_upsample3d(h, stage.resample)
    else:
        h = W._spatial_up(h, stage.resample.conv)
    return h + dup_up3d(x, cout, factor_t=2 if tup else 1, factor_s=2)


# -------------------------------------------------------------------- modules

class Encoder22(nn.Module):
    def __init__(self, cfg: Wan22VAEConfig, dtype, device):
        super().__init__()
        dims, n = _enc_dims(cfg), len(cfg.dim_mult)
        p2 = cfg.patch_size ** 2
        self.conv1 = W.Conv(3 * p2, dims[0], (3, 3, 3), dtype, device)
        self.down = nn.ModuleList()
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            res = [W.ResBlock(cin if j == 0 else cout, cout, dtype, device)
                   for j in range(cfg.num_res_blocks)]
            rs = None
            if i != n - 1:
                rs = W.Resample(cout, cout, _flag(cfg.temporal_downsample, i),
                                cout, dtype, device)
            self.down.append(W.Stage(res, rs))
        self.mid_rb1 = W.ResBlock(dims[-1], dims[-1], dtype, device)
        self.mid_attn = W.AttnBlock(dims[-1], dtype, device)
        self.mid_rb2 = W.ResBlock(dims[-1], dims[-1], dtype, device)
        self.head_norm = W.Gamma((dims[-1], 1, 1, 1), dtype, device)
        self.head_conv = W.Conv(dims[-1], cfg.z_dim * 2, (3, 3, 3), dtype,
                                device)


class Decoder22(nn.Module):
    def __init__(self, cfg: Wan22VAEConfig, dtype, device):
        super().__init__()
        ddims, n = _dec_dims(cfg), len(cfg.dim_mult)
        t_up = tuple(reversed(cfg.temporal_downsample))
        self.conv1 = W.Conv(cfg.z_dim, ddims[0], (3, 3, 3), dtype, device)
        self.mid_rb1 = W.ResBlock(ddims[0], ddims[0], dtype, device)
        self.mid_attn = W.AttnBlock(ddims[0], dtype, device)
        self.mid_rb2 = W.ResBlock(ddims[0], ddims[0], dtype, device)
        self.up = nn.ModuleList()
        for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
            res = [W.ResBlock(cin if j == 0 else cout, cout, dtype, device)
                   for j in range(cfg.num_res_blocks + 1)]
            rs = None
            if i != n - 1:
                rs = W.Resample(cout, cout, _flag(t_up, i), cout * 2, dtype,
                                device)
            self.up.append(W.Stage(res, rs))
        self.head_norm = W.Gamma((ddims[-1], 1, 1, 1), dtype, device)
        self.head_conv = W.Conv(ddims[-1], 3 * cfg.patch_size ** 2,
                                (3, 3, 3), dtype, device)


class Wan22VAE(nn.Module):
    def __init__(self, cfg: Wan22VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        z2 = cfg.z_dim * 2
        self.encoder = Encoder22(cfg, dtype, device)
        self.quant_conv = W.Conv(z2, z2, (1, 1, 1), dtype, device)
        self.post_quant_conv = W.Conv(cfg.z_dim, cfg.z_dim, (1, 1, 1), dtype,
                                      device)
        self.decoder = Decoder22(cfg, dtype, device)

    _scale = W.WanVAE._scale

    def encode(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """video [B, 3, T, H, W] in [-1, 1] -> (mu, log_var), mu normalized
        per channel."""
        cfg, enc = self.cfg, self.encoder
        dims = _enc_dims(cfg)
        h = W.causal_conv3d(patchify2(video, cfg.patch_size), enc.conv1)
        for i, stage in enumerate(enc.down):
            h = down_stage(stage, h, _flag(cfg.temporal_downsample, i),
                           dims[i + 1])
        h = enc.mid_rb2(enc.mid_attn(enc.mid_rb1(h)))
        h = F.silu(W.channel_rms_norm(h, enc.head_norm.gamma))
        feats = W.causal_conv3d(W.causal_conv3d(h, enc.head_conv),
                                self.quant_conv)
        mu, log_var = feats.chunk(2, dim=1)
        mean, inv_std = self._scale(mu.dtype, mu.device)
        return (mu - mean) * inv_std, log_var

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents [B, z, T', H', W'] -> video [B, 3, T, H, W] in [-1, 1]."""
        cfg, dec = self.cfg, self.decoder
        ddims = _dec_dims(cfg)
        t_up = tuple(reversed(cfg.temporal_downsample))
        mean, inv_std = self._scale(z.dtype, z.device)
        h = W.causal_conv3d(W.causal_conv3d(z / inv_std + mean,
                                            self.post_quant_conv), dec.conv1)
        h = dec.mid_rb2(dec.mid_attn(dec.mid_rb1(h)))
        for i, stage in enumerate(dec.up):
            h = up_stage(stage, h, _flag(t_up, i), ddims[i + 1])
        h = F.silu(W.channel_rms_norm(h, dec.head_norm.gamma))
        h = W.causal_conv3d(h, dec.head_conv)
        return unpatchify2(h, cfg.patch_size).clamp(-1.0, 1.0)


@torch.no_grad()
def init_wan22_vae(cfg: Wan22VAEConfig, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> Wan22VAE:
    """Random weights drawn as `wan_vae.init_wan_vae` draws them (conv
    kernels uniform ±1/sqrt(fan_in), zero biases, unit gammas, zero
    attention proj), from ``generator`` on ``device``."""
    model = Wan22VAE(cfg, dtype=dtype, device=device or generator.device)
    for name, p in model.named_parameters():
        if name.endswith(".weight"):
            if name.endswith("mid_attn.proj.weight"):
                p.zero_()
                continue
            bound = 1.0 / math.sqrt(p[0].numel())
            r = torch.empty(p.shape, device=generator.device)
            p.copy_(r.uniform_(-bound, bound, generator=generator))
    return model


# ----------------------------------------------------------------- conversion

def wan22_vae_key_map(cfg: Wan22VAEConfig, keys) -> Dict[str, str]:
    """{published ``Wan2.2_VAE.pth`` key: the port's key}; ``keys`` (the
    file's, or `weights.AnyKey`) says which optional keys (shortcuts, time
    convs) exist."""
    from .weights import _vae_attn_names, _vae_conv, _vae_res_names
    n = len(cfg.dim_mult)
    names: Dict[str, str] = {}
    for part, seq, stage_name, per in (
            ("encoder", "downsamples", "down", cfg.num_res_blocks),
            ("decoder", "upsamples", "up", cfg.num_res_blocks + 1)):
        names.update(_vae_conv(f"{part}.conv1", f"{part}.conv1"))
        names.update(_vae_res_names(f"{part}.middle.0", f"{part}.mid_rb1",
                                    keys))
        names.update(_vae_attn_names(f"{part}.middle.1", f"{part}.mid_attn"))
        names.update(_vae_res_names(f"{part}.middle.2", f"{part}.mid_rb2",
                                    keys))
        names[f"{part}.head.0.gamma"] = f"{part}.head_norm.gamma"
        names.update(_vae_conv(f"{part}.head.2", f"{part}.head_conv"))
        # each stage is a residual block holding its own Sequential
        for i in range(n):
            pre, dst = f"{part}.{seq}.{i}.{seq}", f"{part}.{stage_name}.{i}"
            for j in range(per):
                names.update(_vae_res_names(f"{pre}.{j}", f"{dst}.res.{j}",
                                            keys))
            if i != n - 1:
                rs = f"{pre}.{per}"
                names.update(_vae_conv(rs + ".resample.1",
                                       dst + ".resample.conv"))
                if rs + ".time_conv.weight" in keys:
                    names.update(_vae_conv(rs + ".time_conv",
                                           dst + ".resample.time_conv"))
    names.update(_vae_conv("conv1", "quant_conv"))
    names.update(_vae_conv("conv2", "post_quant_conv"))
    return names


def convert_wan22_vae_state_dict(sd, cfg: Wan22VAEConfig,
                                 dtype: torch.dtype = torch.float32):
    """``Wan2.2_VAE.pth`` keys -> `Wan22VAE` state dict in ``dtype``. Each
    ``encoder.downsamples.{i}`` / ``decoder.upsamples.{i}`` is a residual
    stage holding its own ``.downsamples`` / ``.upsamples`` Sequential; the
    AvgDown3D / DupUp3D shortcuts have no parameters; the wrapper convs
    ``conv1`` / ``conv2`` are quant / post-quant. A ``model.`` prefix is
    taken too."""
    if not any(k.startswith("encoder.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    return {dst: sd[src].to(dtype)
            for src, dst in wan22_vae_key_map(cfg, sd).items()}
