"""The Wan2.1 causal video VAE (Wan's ``wan/modules/vae.py``) in float32:
causal 3D convolutions (time padded on the left only), channel RMS norms,
per-frame single-head attention in the middle, the temporal resamples with
their first-frame rules (the encoder's frame 0 skips the stride-2 time
conv; the decoder's frame 0 is not doubled). Over the whole clip at once,
or streamed as Wan's chunked loop runs it (``streamed``: the encoder one
frame and then four a chunk, the decoder one latent frame a chunk), each
causal time conv taking the last frames of its input stream from the
chunk before (Wan's feature cache), so that a long clip holds one chunk's
activations; both compute the same."""

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


class Stream:
    """The state a streamed encode or decode carries from chunk to chunk:
    ``tails`` holds, for each causal time conv, the last frames of its
    input stream (the encoder's stride-2 time conv: the frames it has not
    consumed); ``first`` is true while the chunk holds the clip's frame
    0."""

    def __init__(self):
        self.tails = {}
        self.first = True


def conv3d(W, name, x, stride=1, stream=None):
    kt, kh, kw = W.sd[name + ".weight"].shape[2:]
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    if stream is None or not pt:
        x = F.pad(x, (pw, pw, ph, ph, 2 * pt, 0))
    else:
        past = stream.tails.get(name)
        if past is None:            # the stream starts on zeros
            past = x.new_zeros(*x.shape[:2], 2 * pt, *x.shape[3:])
        x = torch.cat([past, x], dim=2)
        stream.tails[name] = x[:, :, -2 * pt:].clone()
        x = F.pad(x, (pw, pw, ph, ph))
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


def residual(W, p, x, stream=None):
    h = conv3d(W, p + ".shortcut", x) if p + ".shortcut.weight" in W else x
    y = conv3d(W, p + ".residual.2",
               F.silu(rms(x, W(p + ".residual.0.gamma"))), stream=stream)
    y = conv3d(W, p + ".residual.6",
               F.silu(rms(y, W(p + ".residual.3.gamma"))), stream=stream)
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


def middle(W, p, x, stream=None):
    x = residual(W, p + ".middle.0", x, stream)
    x = attention(W, p + ".middle.1", x)
    return residual(W, p + ".middle.2", x, stream)


def time_down(W, name, x, stream):
    """A streamed chunk through the stride-2 time conv: windows of three
    frames at every second frame of the stream from frame 0, which passes
    as it is (the whole clip's ``cat([x[:, :, :1], tail])``)."""
    head = [x[:, :, :1]] if stream.first else []
    past = stream.tails.get(name)
    buf = x if past is None else torch.cat([past, x], dim=2)
    n = (buf.shape[2] - 1) // 2
    if n:
        head.append(W.conv(F.conv3d, name, buf[:, :, :2 * n + 1],
                           stride=(2, 1, 1)))
    stream.tails[name] = buf[:, :, 2 * n:].clone()
    return torch.cat(head, dim=2)


def encoder(W, cfg, x, stream=None):
    x = conv3d(W, "encoder.conv1", x, stream=stream)
    n = 0
    stages = len(cfg["dim_mult"])
    for i in range(stages):
        for _ in range(cfg["num_res_blocks"]):
            x = residual(W, f"encoder.downsamples.{n}", x, stream)
            n += 1
        if i != stages - 1:
            p = f"encoder.downsamples.{n}"
            x = per_frame(x, lambda f: W.conv(
                F.conv2d, p + ".resample.1", F.pad(f, (0, 1, 0, 1)),
                stride=2))
            if cfg["temporal_downsample"][i] and stream is not None:
                x = time_down(W, p + ".time_conv", x, stream)
            elif cfg["temporal_downsample"][i] and x.shape[2] >= 3:
                tail = W.conv(F.conv3d, p + ".time_conv", x,
                              stride=(2, 1, 1))
                x = torch.cat([x[:, :, :1], tail], dim=2)
            elif cfg["temporal_downsample"][i]:
                x = x[:, :, :1]
            n += 1
    x = middle(W, "encoder", x, stream)
    x = F.silu(rms(x, W("encoder.head.0.gamma")))
    return conv3d(W, "encoder.head.2", x, stream=stream)


def decoder(W, cfg, x, stream=None):
    x = conv3d(W, "decoder.conv1", x, stream=stream)
    x = middle(W, "decoder", x, stream)
    n = 0
    stages = len(cfg["dim_mult"])
    upsample = list(reversed(cfg["temporal_downsample"]))
    for i in range(stages):
        for _ in range(cfg["num_res_blocks"] + 1):
            x = residual(W, f"decoder.upsamples.{n}", x, stream)
            n += 1
        if i != stages - 1:
            p = f"decoder.upsamples.{n}"
            B, C, T, H, Wd = x.shape
            # frame 0 of the clip is not doubled; a later chunk has none
            k = 1 if stream is None or stream.first else 0
            if upsample[i] and T > k:
                y = conv3d(W, p + ".time_conv", x[:, :, k:], stream=stream)
                y = y.reshape(B, 2, C, T - k, H, Wd).permute(0, 2, 3, 1, 4, 5)
                x = torch.cat([x[:, :, :k], y.reshape(B, C, 2 * (T - k), H,
                                                      Wd)], dim=2)
            x = per_frame(x, lambda f: W.conv(
                F.conv2d, p + ".resample.1",
                F.interpolate(f, scale_factor=2.0, mode="nearest-exact"),
                padding=1))
            n += 1
    x = F.silu(rms(x, W("decoder.head.0.gamma")))
    return conv3d(W, "decoder.head.2", x, stream=stream)


def _scale(cfg, device):
    shape = (1, -1, 1, 1, 1)
    mean = torch.tensor(cfg["latent_mean"], device=device).view(shape)
    std = torch.tensor(cfg["latent_std"], device=device).view(shape)
    return mean, std


def _streamed(fn, x, bounds):
    """fn(chunk, stream) over the chunks of x [B, C, T, H, W] between
    ``bounds``, one stream carried through, the outputs joined in time."""
    stream, out = Stream(), []
    for a, b in zip(bounds[:-1], bounds[1:]):
        out.append(fn(x[:, :, a:b], stream))
        stream.first = False
    return torch.cat(out, dim=2)


def encode(W, cfg, video: torch.Tensor, streamed: bool = False
           ) -> torch.Tensor:
    """Frames [1, 3, T, H, W] in [-1, 1] -> the normalised latent mean;
    ``streamed``: frame 0, then four frames a chunk."""
    if streamed:
        T = video.shape[2]
        h = _streamed(lambda c, s: encoder(W, cfg, c, s), video,
                      [0] + list(range(1, T, 4)) + [T])
    else:
        h = encoder(W, cfg, video)
    mu = conv3d(W, "conv1", h).chunk(2, dim=1)[0]
    mean, std = _scale(cfg, video.device)
    return (mu - mean) / std


def decode(W, cfg, z: torch.Tensor, streamed: bool = False) -> torch.Tensor:
    """Normalised latents -> frames in [-1, 1]; ``streamed``: one latent
    frame a chunk."""
    mean, std = _scale(cfg, z.device)
    x = conv3d(W, "conv2", z * std + mean)
    if streamed:
        x = _streamed(lambda c, s: decoder(W, cfg, c, s), x,
                      list(range(x.shape[2] + 1)))
    else:
        x = decoder(W, cfg, x)
    return x.clamp(-1.0, 1.0)
