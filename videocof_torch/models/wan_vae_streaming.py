"""Streaming (cache-carrying) causal VAE encode and decode, PyTorch.

Counterpart of `videocof_tpu/models/wan_vae_streaming.py`, on the blocks of
the port's whole-sequence VAE (`wan_vae.py`). The whole-sequence VAE holds
the activations of every frame at once, so its memory grows with the clip
(the decoder's full-resolution stages most). Streaming holds one chunk's
activations and, for each causal time conv, a cache of the frames the next
chunk needs. The first chunk (one
frame) takes the temporal resamples' frame-0 rules (see `wan_vae.py`);
every later chunk runs the same blocks on [cache | chunk].

Cache rule: for a causal time-k conv, keep the last (k-1) frames of the
concatenated input stream; chunk input = concat(cache, chunk); valid conv;
new cache = last (k-1) frames of that concatenation. Zero caches reproduce
the left zero padding of the first chunk. Streaming computes what the
whole-sequence VAE computes (`tests/test_torch_vae_streaming.py`).

JAX's one-compiled-program variants (`encode_streaming_fused`,
`make_fused_decode_fn`) are not ported: they fold the chunk loop into one
XLA program to save dispatches, and the port runs the loop eagerly.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import wan_vae as W


class _Tape:
    """The conv caches in the static conv order: ``pull`` reads the previous
    chunk's cache of the next conv (None on the first chunk), ``push`` keeps
    this chunk's. A cache is a copy, not a view: a view of a conv's input
    would keep the whole input, and so every conv input of the chunk, alive
    until the next chunk."""

    def __init__(self, caches: Optional[List[torch.Tensor]] = None):
        self.caches = caches
        self.idx = 0
        self.out: List[torch.Tensor] = []

    def pull(self) -> Optional[torch.Tensor]:
        if self.caches is None:
            return None
        c = self.caches[self.idx]
        self.idx += 1
        return c

    def push(self, c: torch.Tensor) -> None:
        self.out.append(c)


def _causal_conv_stream(x, conv: W.Conv, tape: _Tape):
    """A causal conv over a chunk: [cache | chunk], time kernel k, cache of
    k - 1 frames (zeros on the first chunk, the left zero pad)."""
    kt, kh, kw = conv.weight.shape[2:]
    hist = kt - 1
    if hist == 0:
        return W.causal_conv3d(x, conv)
    cache = tape.pull()
    if cache is None:
        cache = x.new_zeros(x.shape[:2] + (hist,) + x.shape[3:])
    inp = torch.cat([cache, x], dim=2)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    out = F.conv3d(F.pad(inp, (pw, pw, ph, ph)), conv.weight.to(x.dtype),
                   conv.bias.to(x.dtype))
    tape.push(inp[:, :, -hist:].clone())
    return out


def _res_block_stream(rb: W.ResBlock, x, tape: _Tape):
    h = W.causal_conv3d(x, rb.shortcut) if hasattr(rb, "shortcut") else x
    y = F.silu(W.channel_rms_norm(x, rb.norm1.gamma))
    y = _causal_conv_stream(y, rb.conv1, tape)
    y = F.silu(W.channel_rms_norm(y, rb.norm2.gamma))
    y = _causal_conv_stream(y, rb.conv2, tape)
    return y + h


# -------------------------------------------------------------------- decoder

def _upsample3d_stream(x, rs: W.Resample, tape: _Tape, first: bool):
    """The temporal upsample: on the first chunk frame 0 bypasses the time
    conv and primes a zero cache; later chunks run the causal conv of 2C
    output channels and interleave them into doubled frames."""
    B, C, T, H, Wd = x.shape
    if first:
        tape.pull()
        tape.push(x.new_zeros((B, C, 2, H, Wd)))
        return W._spatial_up(x, rs.conv)
    y = _causal_conv_stream(x, rs.time_conv, tape)       # [B, 2C, T, H, W]
    y = y.reshape(B, 2, C, T, H, Wd).permute(0, 2, 3, 1, 4, 5)
    return W._spatial_up(y.reshape(B, C, 2 * T, H, Wd), rs.conv)


def _decoder_stream(dec: W.Decoder, x, tape: _Tape, first: bool):
    h = _causal_conv_stream(x, dec.conv1, tape)
    h = _res_block_stream(dec.mid_rb1, h, tape)
    h = dec.mid_attn(h)
    h = _res_block_stream(dec.mid_rb2, h, tape)
    for stage in dec.up:
        for rb in stage.res:
            h = _res_block_stream(rb, h, tape)
        if hasattr(stage, "resample"):
            if stage.resample.temporal:
                h = _upsample3d_stream(h, stage.resample, tape, first)
            else:
                h = W._spatial_up(h, stage.resample.conv)
    h = F.silu(W.channel_rms_norm(h, dec.head_norm.gamma))
    return _causal_conv_stream(h, dec.head_conv, tape)


def _decode_chunks(vae: W.WanVAE, z: torch.Tensor, chunk_latent: int,
                   dtype: torch.dtype) -> Iterator[torch.Tensor]:
    """Unclipped pixel chunks of latent ``z``: frame 0, then
    ``chunk_latent`` latent frames a step, the remainder last; the latents
    are unnormalized in ``dtype`` chunk by chunk."""
    mean, inv_std = vae._scale(dtype, z.device)
    tape, t, T = None, 0, z.shape[2]
    while t < T:
        k = 1 if t == 0 else min(chunk_latent, T - t)
        x = W.causal_conv3d(z[:, :, t:t + k].to(dtype) / inv_std + mean,
                            vae.post_quant_conv)
        tape = _Tape(None if tape is None else tape.out)
        yield _decoder_stream(vae.decoder, x, tape, first=t == 0)
        t += k


def decode_streaming_chunks(vae: W.WanVAE, z: torch.Tensor,
                            chunk_latent: int = 4) -> Iterator[torch.Tensor]:
    """Yield the decoded pixel chunks (unclipped, in order) of latent
    [B, z, T', H', W'], ``chunk_latent`` latent frames a step after the
    first frame."""
    return _decode_chunks(vae, z, chunk_latent, z.dtype)


def decode_streaming(vae: W.WanVAE, z: torch.Tensor,
                     chunk_latent: int = 4) -> torch.Tensor:
    """Latent [B, z, T', H', W'] -> video [B, 3, 1 + 4 (T' - 1), H, W] in
    [-1, 1], ``chunk_latent`` latent frames a step; a smaller last chunk
    takes the remainder."""
    outs = list(decode_streaming_chunks(vae, z, chunk_latent))
    return torch.cat(outs, dim=2).clamp(-1.0, 1.0)


def decode_streaming_u8(vae: W.WanVAE, z: torch.Tensor, chunk_latent: int = 4,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The streaming decode to uint8 frames on z's device, each chunk
    clipped and quantized as it comes, clip(round(x * 127.5 + 127.5)), so
    only uint8 frames accumulate. The decode runs in ``compute_dtype``
    (default z's dtype), the latents cast to it chunk by chunk."""
    cd = z.dtype if compute_dtype is None else compute_dtype
    parts = []
    for y in _decode_chunks(vae, z, chunk_latent, cd):
        y = y.clamp(-1.0, 1.0).float()
        parts.append(torch.round(y * 127.5 + 127.5).clamp(0, 255)
                     .to(torch.uint8))
    return torch.cat(parts, dim=2)


# -------------------------------------------------------------------- encoder

def _downsample3d_stream(x, rs: W.Resample, tape: _Tape, first: bool):
    """The temporal downsample: the first chunk passes frame 0 through and
    primes a one-frame cache; later chunks run the stride-2 time conv over
    [cache | chunk]."""
    x = W._spatial_down(x, rs.conv)
    cache = tape.pull()
    if first:
        tape.push(x[:, :, -1:].clone())
        return x
    inp = torch.cat([cache, x], dim=2)
    out = F.conv3d(inp, rs.time_conv.weight.to(x.dtype),
                   rs.time_conv.bias.to(x.dtype), stride=(2, 1, 1))
    tape.push(inp[:, :, -1:].clone())
    return out


def _encoder_stream(enc: W.Encoder, x, tape: _Tape, first: bool):
    h = _causal_conv_stream(x, enc.conv1, tape)
    for stage in enc.down:
        for rb in stage.res:
            h = _res_block_stream(rb, h, tape)
        if hasattr(stage, "resample"):
            if stage.resample.temporal:
                h = _downsample3d_stream(h, stage.resample, tape, first)
            else:
                h = W._spatial_down(h, stage.resample.conv)
    h = _res_block_stream(enc.mid_rb1, h, tape)
    h = enc.mid_attn(h)
    h = _res_block_stream(enc.mid_rb2, h, tape)
    h = F.silu(W.channel_rms_norm(h, enc.head_norm.gamma))
    return _causal_conv_stream(h, enc.head_conv, tape)


def encode_streaming(vae: W.WanVAE, video: torch.Tensor,
                     chunk_latent: int = 4
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """video [B, 3, T, H, W] in [-1, 1], T = 1 + 4k -> (mu, log_var), mu
    normalized per channel: frame 0, then ``chunk_latent`` latent frames'
    worth of pixel frames a step (a shorter last step stays a whole number
    of latent frames)."""
    tc = vae.cfg.temporal_compression_ratio
    T = video.shape[2]
    if (T - 1) % tc:
        raise ValueError(f"streaming encode needs T = 1 + {tc}k frames, "
                         f"got {T}")
    tape = _Tape()
    outs = [_encoder_stream(vae.encoder, video[:, :, :1], tape, first=True)]
    s = 1
    while s < T:
        k = min(tc * chunk_latent, T - s)
        k -= k % tc                       # stay latent-frame aligned
        tape = _Tape(tape.out)
        outs.append(_encoder_stream(vae.encoder, video[:, :, s:s + k], tape,
                                    first=False))
        s += k
    feats = W.causal_conv3d(torch.cat(outs, dim=2), vae.quant_conv)
    mu, log_var = feats.chunk(2, dim=1)
    mean, inv_std = vae._scale(mu.dtype, mu.device)
    return (mu - mean) * inv_std, log_var
