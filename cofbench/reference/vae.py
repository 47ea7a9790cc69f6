"""The Wan2.1 causal video VAE (Wan's ``wan/modules/vae.py``) over the whole
clip at once, in float32: causal 3D convolutions (time padded on the left
only), channel RMS norms, per-frame single-head attention in the middle,
the temporal resamples with their first-frame rules (the encoder's frame 0
skips the stride-2 time conv; the decoder's frame 0 is not doubled), which
is what Wan's chunked feature-cache loop computes."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Weights:
    """float32 views of the VAE's published weights; ``quant`` rounds both
    operands of every convolution (the control: `fp8`)."""

    def __init__(self, sd, device, quant=None):
        self.sd, self.device = sd, device
        self.q = quant or (lambda t: t)

    def __call__(self, key: str) -> torch.Tensor:
        return self.sd[key].to(self.device, torch.float32)

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def conv(self, fn, name, x, **kw):
        return fn(self.q(x), self.q(self(name + ".weight")),
                  self(name + ".bias"), **kw)


def conv3d(W, name, x, stride=1):
    kt, kh, kw = W.sd[name + ".weight"].shape[2:]
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(x, (pw, pw, ph, ph, 2 * pt, 0))
    return W.conv(F.conv3d, name, x, stride=stride)


def rms(x, gamma):
    return F.normalize(x, dim=1) * math.sqrt(x.shape[1]) * gamma


def per_frame(x, fn, chunk: int = 8):
    """fn over the [B*T, C, H, W] frames of x [B, C, T, H, W], ``chunk``
    frames a call (a full-resolution stack of every frame would pass 2**31
    elements)."""
    B, _, T = x.shape[:3]
    frames = x.transpose(1, 2).flatten(0, 1)
    y = torch.cat([fn(frames[i:i + chunk])
                   for i in range(0, frames.shape[0], chunk)])
    return y.unflatten(0, (B, T)).transpose(1, 2)


def residual(W, p, x):
    h = conv3d(W, p + ".shortcut", x) if p + ".shortcut.weight" in W else x
    y = conv3d(W, p + ".residual.2",
               F.silu(rms(x, W(p + ".residual.0.gamma"))))
    y = conv3d(W, p + ".residual.6",
               F.silu(rms(y, W(p + ".residual.3.gamma"))))
    return y + h


def attention(W, p, x):
    C = x.shape[1]

    def frames(f):
        n, _, H, Wd = f.shape
        y = rms(f, W(p + ".norm.gamma"))
        qkv = W.conv(F.conv2d, p + ".to_qkv", y)
        q, k, v = qkv.flatten(2).transpose(1, 2).chunk(3, dim=-1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), -1) @ v
        o = att.transpose(1, 2).reshape(n, C, H, Wd)
        return W.conv(F.conv2d, p + ".proj", o)

    return per_frame(x, frames) + x


def middle(W, p, x):
    x = residual(W, p + ".middle.0", x)
    x = attention(W, p + ".middle.1", x)
    return residual(W, p + ".middle.2", x)


def encoder(W, cfg, x):
    x = conv3d(W, "encoder.conv1", x)
    n = 0
    stages = len(cfg["dim_mult"])
    for i in range(stages):
        for _ in range(cfg["num_res_blocks"]):
            x = residual(W, f"encoder.downsamples.{n}", x)
            n += 1
        if i != stages - 1:
            p = f"encoder.downsamples.{n}"
            x = per_frame(x, lambda f: W.conv(
                F.conv2d, p + ".resample.1", F.pad(f, (0, 1, 0, 1)),
                stride=2))
            if cfg["temporal_downsample"][i] and x.shape[2] >= 3:
                tail = W.conv(F.conv3d, p + ".time_conv", x,
                              stride=(2, 1, 1))
                x = torch.cat([x[:, :, :1], tail], dim=2)
            elif cfg["temporal_downsample"][i]:
                x = x[:, :, :1]
            n += 1
    x = middle(W, "encoder", x)
    x = F.silu(rms(x, W("encoder.head.0.gamma")))
    return conv3d(W, "encoder.head.2", x)


def decoder(W, cfg, x):
    x = conv3d(W, "decoder.conv1", x)
    x = middle(W, "decoder", x)
    n = 0
    stages = len(cfg["dim_mult"])
    upsample = list(reversed(cfg["temporal_downsample"]))
    for i in range(stages):
        for _ in range(cfg["num_res_blocks"] + 1):
            x = residual(W, f"decoder.upsamples.{n}", x)
            n += 1
        if i != stages - 1:
            p = f"decoder.upsamples.{n}"
            B, C, T, H, Wd = x.shape
            if upsample[i] and T > 1:
                y = conv3d(W, p + ".time_conv", x[:, :, 1:])
                y = y.reshape(B, 2, C, T - 1, H, Wd).permute(0, 2, 3, 1, 4, 5)
                x = torch.cat([x[:, :, :1], y.reshape(B, C, 2 * (T - 1), H,
                                                      Wd)], dim=2)
            x = per_frame(x, lambda f: W.conv(
                F.conv2d, p + ".resample.1",
                F.interpolate(f, scale_factor=2.0, mode="nearest-exact"),
                padding=1))
            n += 1
    x = F.silu(rms(x, W("decoder.head.0.gamma")))
    return conv3d(W, "decoder.head.2", x)


def _scale(cfg, device):
    shape = (1, -1, 1, 1, 1)
    mean = torch.tensor(cfg["latent_mean"], device=device).view(shape)
    std = torch.tensor(cfg["latent_std"], device=device).view(shape)
    return mean, std


def encode(W, cfg, video: torch.Tensor) -> torch.Tensor:
    """Frames [1, 3, T, H, W] in [-1, 1] -> the normalised latent mean."""
    mu = conv3d(W, "conv1", encoder(W, cfg, video)).chunk(2, dim=1)[0]
    mean, std = _scale(cfg, video.device)
    return (mu - mean) / std


def decode(W, cfg, z: torch.Tensor) -> torch.Tensor:
    """Normalised latents -> frames in [-1, 1]."""
    mean, std = _scale(cfg, z.device)
    x = conv3d(W, "conv2", z * std + mean)
    return decoder(W, cfg, x).clamp(-1.0, 1.0)
