"""CogVideoX causal 3D VAE, PyTorch, whole-sequence.

Counterpart of `videocof_tpu/models/cogvideox_vae.py` (the reference's
`AutoencoderKLCogVideoX`): 8x spatial and 4x temporal compression, 16
latent channels, with its four departures from the Wan VAE:

  * causal convolutions pad time by replicating the first frame;
  * GroupNorm statistics span (C/G, T, H, W), the whole clip;
  * the decoder's norms are SpatialNorm3D, conditioned on the latents zq
    resized (nearest) to each activation: norm(x) * conv_y(zq) + conv_b(zq);
  * temporal resampling keeps the first frame apart: the encoder averages
    frame pairs after it, the decoder repeats each frame after it.

As in JAX, the clip is encoded and decoded whole (no frame batching, no
tiling). The convolutions are cuDNN's (`F.conv3d`, `F.conv2d`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .wan_vae import Conv, _frames_conv2d


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    scaling_factor: float = 1.15258426

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


COGVIDEOX_VAE = CogVideoXVAEConfig()
COGVIDEOX_VAE_TINY = CogVideoXVAEConfig(latent_channels=4,
                                        block_out_channels=(8, 8, 16, 16),
                                        layers_per_block=1,
                                        norm_num_groups=4)


# ----------------------------------------------------------------- primitives

def causal_conv3d_first(x, conv: Conv, stride=(1, 1, 1)):
    """A causal convolution whose time padding repeats the first frame."""
    kt, kh, kw = conv.weight.shape[2:]
    if kt > 1:
        x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
    return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    stride=stride, padding=(0, (kh - 1) // 2, (kw - 1) // 2))


def group_norm(x, gn, groups: int, eps: float):
    """GroupNorm over (C/G, T, H, W) of [B, C, T, H, W], in fp32. Below
    fp32 one group at a time, its mean and variance by two fp32
    reductions (JAX's `jnp.mean` and `jnp.var`), into an output of x's
    dtype: no fp32 copy of a whole full-resolution activation (8.6 GB at
    49 x 480 x 720 x 128) exists, and each group's statistics run over
    the whole card (`F.group_norm` on one group reduces in one block)."""
    if x.dtype == torch.float32:
        return F.group_norm(x, groups, gn.scale.float(), gn.bias.float(),
                            eps)
    B, C = x.shape[:2]
    cpg = C // groups
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    xg, og = x.reshape(B, groups, cpg, -1), out.view(B, groups, cpg, -1)
    w = gn.scale.float().view(groups, cpg, 1)
    b = gn.bias.float().view(groups, cpg, 1)
    for g in range(groups):
        xf = xg[:, g].float()                               # [B, cpg, THW]
        mean = xf.mean(dim=(1, 2), keepdim=True)
        xf -= mean
        rstd = torch.rsqrt(xf.square().mean(dim=(1, 2), keepdim=True) + eps)
        og[:, g] = torch.addcmul(b[g], xf, rstd * w[g]).to(x.dtype)
    return out


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """The source rows of a nearest resize from ``n_in`` to ``n_out``, as
    ``jax.image.resize(..., "nearest")`` picks them: floor((i + 0.5) *
    n_in / n_out) in float32."""
    idx = np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                   * np.float32(n_in) / np.float32(n_out)).astype(np.int64)
    return torch.as_tensor(np.minimum(idx, n_in - 1), device=device)


def resize_nearest(x, shape):
    """Nearest resize of [B, C, T, H, W] to ``shape`` = (T, H, W)."""
    for axis, n in zip((2, 3, 4), shape):
        if x.shape[axis] != n:
            x = x.index_select(axis, _nearest_index(x.shape[axis], n,
                                                    x.device))
    return x


def _resize_zq(zq, shape):
    """zq resized to an activation's (T, H, W); with an odd T the first
    frame is resized apart from the rest."""
    T, H, W = shape
    if zq.shape[2] > 1 and T % 2 == 1:
        return torch.cat([resize_nearest(zq[:, :, :1], (1, H, W)),
                          resize_nearest(zq[:, :, 1:], (T - 1, H, W))], dim=2)
    return resize_nearest(zq, shape)


# -------------------------------------------------------------------- modules

class _GN(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))


class SpatialNorm3D(nn.Module):
    def __init__(self, c, zc, dtype, device):
        super().__init__()
        self.norm = _GN(c, device)
        self.conv_y = Conv(zc, c, (1, 1, 1), dtype, device)
        self.conv_b = Conv(zc, c, (1, 1, 1), dtype, device)


def spatial_norm3d(x, sn: SpatialNorm3D, zq, groups, eps=1e-6):
    """norm(x) * conv_y(zq) + conv_b(zq), zq resized to x; the product and
    the sum in place on the fresh norm."""
    zq = _resize_zq(zq, x.shape[2:])
    normed = group_norm(x, sn.norm, groups, eps)
    normed.mul_(causal_conv3d_first(zq, sn.conv_y))
    return normed.add_(causal_conv3d_first(zq, sn.conv_b))


class ResNet(nn.Module):
    def __init__(self, cin, cout, cfg: CogVideoXVAEConfig, spatial: bool,
                 dtype, device):
        super().__init__()
        zc = cfg.latent_channels

        def norm(c):
            return (SpatialNorm3D(c, zc, dtype, device) if spatial
                    else _GN(c, device))

        self.norm1 = norm(cin)
        self.conv1 = Conv(cin, cout, (3, 3, 3), dtype, device)
        self.norm2 = norm(cout)
        self.conv2 = Conv(cout, cout, (3, 3, 3), dtype, device)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, (1, 1, 1), dtype, device)

    def forward(self, x, cfg: CogVideoXVAEConfig, zq=None):
        g, eps = cfg.norm_num_groups, cfg.norm_eps

        def norm(y, n):
            return (spatial_norm3d(y, n, zq, g, eps) if zq is not None
                    else group_norm(y, n, g, eps))

        h = causal_conv3d_first(F.silu(norm(x, self.norm1)), self.conv1)
        h = causal_conv3d_first(F.silu(norm(h, self.norm2)), self.conv2)
        sc = x
        if hasattr(self, "conv_shortcut"):
            sc = F.conv3d(x, self.conv_shortcut.weight.to(x.dtype),
                          self.conv_shortcut.bias.to(x.dtype))
        return h + sc


class _Stage(nn.Module):
    def __init__(self, res, conv_name=None, conv=None):
        super().__init__()
        self.res = nn.ModuleList(res)
        if conv is not None:
            setattr(self, conv_name, conv)


class _Encoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, dtype, device):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = Conv(cfg.in_channels, ch[0], (3, 3, 3), dtype, device)
        self.down = nn.ModuleList()
        cur = ch[0]
        for i, c in enumerate(ch):
            res = []
            for _ in range(cfg.layers_per_block):
                res.append(ResNet(cur, c, cfg, False, dtype, device))
                cur = c
            down = (Conv(cur, cur, (3, 3), dtype, device)
                    if i != len(ch) - 1 else None)
            self.down.append(_Stage(res, "down_conv", down))
        self.mid = nn.ModuleList(ResNet(cur, cur, cfg, False, dtype, device)
                                 for _ in range(2))
        self.norm_out = _GN(cur, device)
        self.conv_out = Conv(cur, 2 * cfg.latent_channels, (3, 3, 3), dtype,
                             device)


class _Decoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, dtype, device):
        super().__init__()
        rch = list(reversed(cfg.block_out_channels))
        zc = cfg.latent_channels
        self.conv_in = Conv(zc, rch[0], (3, 3, 3), dtype, device)
        self.mid = nn.ModuleList(ResNet(rch[0], rch[0], cfg, True, dtype,
                                        device) for _ in range(2))
        self.up = nn.ModuleList()
        cur = rch[0]
        for i, c in enumerate(rch):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResNet(cur, c, cfg, True, dtype, device))
                cur = c
            up = (Conv(cur, cur, (3, 3), dtype, device)
                  if i != len(rch) - 1 else None)
            self.up.append(_Stage(res, "up_conv", up))
        self.norm_out = SpatialNorm3D(cur, zc, dtype, device)
        self.conv_out = Conv(cur, cfg.in_channels, (3, 3, 3), dtype, device)


def _downsample(x, conv: Conv, compress_time: bool):
    if compress_time:
        T = x.shape[2]
        if T % 2 == 1 and T > 1:
            rest = x[:, :, 1:]
            x = torch.cat([x[:, :, :1],
                           0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])], dim=2)
        elif T > 1:
            x = 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])
    return _frames_conv2d(x, conv, 2, (0, 1, 0, 1))


def _upsample(x, conv: Conv, compress_time: bool):
    """Nearest 2x in space (and in time after the first frame with
    ``compress_time``), then the 3x3 conv, a chunk of frames at a time."""
    T = x.shape[2]
    if compress_time and T > 1:
        if T % 2 == 1:
            x = torch.cat([x[:, :, :1],
                           x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
        else:
            x = x.repeat_interleave(2, dim=2)
    return _frames_conv2d(x, conv, 1, (1, 1, 1, 1), upsample=True)


class CogVideoXVAE(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg, dtype, device)
        self.decoder = _Decoder(cfg, dtype, device)

    def encode(self, video: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """video [B, 3, T, H, W] -> (mu, log_var) (CogVideoX has no quant
        conv)."""
        cfg, enc = self.cfg, self.encoder
        tlevel = int(math.log2(cfg.temporal_compression_ratio))
        h = causal_conv3d_first(video, enc.conv_in)
        for i, stage in enumerate(enc.down):
            for rb in stage.res:
                h = rb(h, cfg)
            if hasattr(stage, "down_conv"):
                h = _downsample(h, stage.down_conv, compress_time=i < tlevel)
        for rb in enc.mid:
            h = rb(h, cfg)
        h = group_norm(h, enc.norm_out, cfg.norm_num_groups, 1e-6)
        h = causal_conv3d_first(F.silu(h), enc.conv_out)
        mu, log_var = h.chunk(2, dim=1)
        return mu, log_var

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents [B, C, T', h, w] (already divided by the scaling factor)
        -> video [B, 3, T, H, W] clipped to [-1, 1]."""
        cfg, dec = self.cfg, self.decoder
        tlevel = int(math.log2(cfg.temporal_compression_ratio))
        h = causal_conv3d_first(z, dec.conv_in)
        for rb in dec.mid:
            h = rb(h, cfg, zq=z)
        for i, stage in enumerate(dec.up):
            for rb in stage.res:
                h = rb(h, cfg, zq=z)
            if hasattr(stage, "up_conv"):
                h = _upsample(h, stage.up_conv, compress_time=i < tlevel)
        h = spatial_norm3d(h, dec.norm_out, z, cfg.norm_num_groups, 1e-6)
        h = causal_conv3d_first(F.silu(h), dec.conv_out)
        return h.clamp(-1.0, 1.0)


@torch.no_grad()
def init_cogvideox_vae(cfg: CogVideoXVAEConfig, generator: torch.Generator,
                       dtype=torch.float32, device=None) -> CogVideoXVAE:
    """Random weights: conv kernels uniform ±1/sqrt(fan_in), zero biases,
    unit norm scales, drawn from ``generator`` on its device."""
    model = CogVideoXVAE(cfg, dtype=dtype, device=device or generator.device)
    for name, p in model.named_parameters():
        if name.endswith(".weight"):
            bound = 1.0 / math.sqrt(p[0].numel())
            r = torch.empty(p.shape, device=generator.device)
            p.copy_(r.uniform_(-bound, bound, generator=generator))
    return model


# -------------------------------------------------------- checkpoint loading

def convert_cogvideox_vae_state_dict(sd: Dict[str, torch.Tensor],
                                     cfg: CogVideoXVAEConfig,
                                     dtype=torch.float32
                                     ) -> Dict[str, torch.Tensor]:
    """A diffusers-layout ``AutoencoderKLCogVideoX`` state dict -> the
    port's: causal convs under ``.conv``, 1x1x1 shortcuts bare, spatial
    norms as ``norm_layer`` / ``conv_y.conv`` / ``conv_b.conv``; GroupNorm
    parameters in fp32, convs in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}

    def conv(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].to(dtype)
        out[f"{dst}.bias"] = sd[f"{src}.bias"].to(dtype)

    def gn(dst, src):
        out[f"{dst}.scale"] = sd[f"{src}.weight"].float()
        out[f"{dst}.bias"] = sd[f"{src}.bias"].float()

    def spatial(dst, src):
        gn(f"{dst}.norm", f"{src}.norm_layer")
        conv(f"{dst}.conv_y", f"{src}.conv_y.conv")
        conv(f"{dst}.conv_b", f"{src}.conv_b.conv")

    def resnet(dst, src, sp):
        (spatial if sp else gn)(f"{dst}.norm1", f"{src}.norm1")
        conv(f"{dst}.conv1", f"{src}.conv1.conv")
        (spatial if sp else gn)(f"{dst}.norm2", f"{src}.norm2")
        conv(f"{dst}.conv2", f"{src}.conv2.conv")
        if f"{src}.conv_shortcut.weight" in sd:
            conv(f"{dst}.conv_shortcut", f"{src}.conv_shortcut")

    n = len(cfg.block_out_channels)
    conv("encoder.conv_in", "encoder.conv_in.conv")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down.{i}.res.{j}",
                   f"encoder.down_blocks.{i}.resnets.{j}", False)
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            conv(f"encoder.down.{i}.down_conv",
                 f"encoder.down_blocks.{i}.downsamplers.0.conv")
    for j in range(2):
        resnet(f"encoder.mid.{j}", f"encoder.mid_block.resnets.{j}", False)
    gn("encoder.norm_out", "encoder.norm_out")
    conv("encoder.conv_out", "encoder.conv_out.conv")
    conv("decoder.conv_in", "decoder.conv_in.conv")
    for j in range(2):
        resnet(f"decoder.mid.{j}", f"decoder.mid_block.resnets.{j}", True)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up.{i}.res.{j}",
                   f"decoder.up_blocks.{i}.resnets.{j}", True)
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            conv(f"decoder.up.{i}.up_conv",
                 f"decoder.up_blocks.{i}.upsamplers.0.conv")
    spatial("decoder.norm_out", "decoder.norm_out")
    conv("decoder.conv_out", "decoder.conv_out.conv")
    return out


_CONFIG_KEYS = ("in_channels", "latent_channels", "block_out_channels",
                "layers_per_block", "norm_num_groups", "norm_eps",
                "temporal_compression_ratio", "scaling_factor")


def load_cogvideox_vae(model_dir: str, dtype=torch.float32, device=None
                       ) -> CogVideoXVAE:
    """A diffusers-layout VAE directory -> `CogVideoXVAE` on ``device``."""
    from . import weights
    from ._family import read_config
    cfg = CogVideoXVAEConfig(**read_config(model_dir, _CONFIG_KEYS,
                                           tuples=("block_out_channels",)))
    sd = convert_cogvideox_vae_state_dict(weights.load_state_dict(model_dir),
                                          cfg, dtype)
    return weights.module_from_state_dict(CogVideoXVAE, cfg, sd, dtype,
                                          device)
