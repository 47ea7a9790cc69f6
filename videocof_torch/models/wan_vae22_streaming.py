"""Streaming (cache-carrying) encode and decode of the Wan2.2 VAE, PyTorch.

Counterpart of `videocof_tpu/models/wan_vae22_streaming.py`, on the Wan2.1
streaming machinery of the port (`wan_vae_streaming.py`: `_Tape`, whose
caches are copies of the last frames each causal conv needs, never views
that would keep a chunk's conv inputs alive) and the Wan2.2 VAE's stages
(`wan_vae22.py`):

  * the 2x2 pixel patchify / unpatchify is frame-local and stateless;
  * the AvgDown3D / DupUp3D shortcuts are parameter-free and applied to each
    chunk alone, as the reference does: the first chunk is one frame (it
    pairs with the front zero pad) and later chunks stay even through every
    temporal stage, so the pairing equals the whole-sequence one;
  * DupUp3D trims its duplicated leading frame on the first chunk only.

Streaming computes what the whole-sequence VAE computes
(`tests/test_torch_vae22.py`).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from . import wan_vae as W
from . import wan_vae22 as V
from .wan_vae_streaming import (_Tape, _causal_conv_stream,
                                _downsample3d_stream, _res_block_stream,
                                _upsample3d_stream)


def _encoder_stream(vae: V.Wan22VAE, x, tape: _Tape, first: bool):
    cfg, enc = vae.cfg, vae.encoder
    dims = V._enc_dims(cfg)
    h = _causal_conv_stream(x, enc.conv1, tape)
    for i, stage in enumerate(enc.down):
        tdown = V._flag(cfg.temporal_downsample, i)
        down = hasattr(stage, "resample")
        y = h
        for rb in stage.res:
            y = _res_block_stream(rb, y, tape)
        if down:
            if tdown:
                y = _downsample3d_stream(y, stage.resample, tape, first)
            else:
                y = W._spatial_down(y, stage.resample.conv)
        h = y + V.avg_down3d(h, dims[i + 1],
                             factor_t=2 if (tdown and down) else 1,
                             factor_s=2 if down else 1)
    h = _res_block_stream(enc.mid_rb1, h, tape)
    h = enc.mid_attn(h)
    h = _res_block_stream(enc.mid_rb2, h, tape)
    h = F.silu(W.channel_rms_norm(h, enc.head_norm.gamma))
    return _causal_conv_stream(h, enc.head_conv, tape)


def encode_streaming(vae: V.Wan22VAE, video: torch.Tensor,
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
    x = V.patchify2(video, vae.cfg.patch_size)
    tape = _Tape()
    outs = [_encoder_stream(vae, x[:, :, :1], tape, first=True)]
    s = 1
    while s < T:
        k = min(tc * chunk_latent, T - s)
        k -= k % tc
        tape = _Tape(tape.out)
        outs.append(_encoder_stream(vae, x[:, :, s:s + k], tape,
                                    first=False))
        s += k
    feats = W.causal_conv3d(torch.cat(outs, dim=2), vae.quant_conv)
    mu, log_var = feats.chunk(2, dim=1)
    mean, inv_std = vae._scale(mu.dtype, mu.device)
    return (mu - mean) * inv_std, log_var


def _decoder_stream(vae: V.Wan22VAE, x, tape: _Tape, first: bool):
    cfg, dec = vae.cfg, vae.decoder
    ddims = V._dec_dims(cfg)
    t_up = tuple(reversed(cfg.temporal_downsample))
    h = _causal_conv_stream(x, dec.conv1, tape)
    h = _res_block_stream(dec.mid_rb1, h, tape)
    h = dec.mid_attn(h)
    h = _res_block_stream(dec.mid_rb2, h, tape)
    for i, stage in enumerate(dec.up):
        tup = V._flag(t_up, i)
        y = h
        for rb in stage.res:
            y = _res_block_stream(rb, y, tape)
        if hasattr(stage, "resample"):
            if tup:
                y = _upsample3d_stream(y, stage.resample, tape, first)
            else:
                y = W._spatial_up(y, stage.resample.conv)
            y = y + V.dup_up3d(h, ddims[i + 1], factor_t=2 if tup else 1,
                               factor_s=2, trim_first=first and tup)
        h = y
    h = F.silu(W.channel_rms_norm(h, dec.head_norm.gamma))
    h = _causal_conv_stream(h, dec.head_conv, tape)
    return V.unpatchify2(h, cfg.patch_size)


def _decode_chunks(vae: V.Wan22VAE, z: torch.Tensor, chunk_latent: int,
                   dtype: torch.dtype) -> Iterator[torch.Tensor]:
    """Unclipped, unpatchified pixel chunks of latent ``z``: frame 0, then
    ``chunk_latent`` latent frames a step, the remainder last; the latents
    are unnormalized in ``dtype`` chunk by chunk."""
    mean, inv_std = vae._scale(dtype, z.device)
    tape, t, T = None, 0, z.shape[2]
    while t < T:
        k = 1 if t == 0 else min(chunk_latent, T - t)
        x = W.causal_conv3d(z[:, :, t:t + k].to(dtype) / inv_std + mean,
                            vae.post_quant_conv)
        tape = _Tape(None if tape is None else tape.out)
        yield _decoder_stream(vae, x, tape, first=t == 0)
        t += k


def decode_streaming_chunks(vae: V.Wan22VAE, z: torch.Tensor,
                            chunk_latent: int = 2) -> Iterator[torch.Tensor]:
    """Yield the decoded pixel chunks (unclipped, in order) of latent
    [B, z, T', H', W'], ``chunk_latent`` latent frames a step after the
    first frame."""
    return _decode_chunks(vae, z, chunk_latent, z.dtype)


def decode_streaming(vae: V.Wan22VAE, z: torch.Tensor,
                     chunk_latent: int = 2) -> torch.Tensor:
    """Latent [B, z, T', H', W'] -> video [B, 3, 1 + 4 (T' - 1), H, W] in
    [-1, 1], ``chunk_latent`` latent frames a step."""
    return torch.cat(list(decode_streaming_chunks(vae, z, chunk_latent)),
                     dim=2).clamp(-1.0, 1.0)


def decode_streaming_u8(vae: V.Wan22VAE, z: torch.Tensor,
                        chunk_latent: int = 2,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The streaming decode to uint8 frames on z's device, each chunk
    clipped and quantized as it comes, clip(round(x * 127.5 + 127.5)); the
    decode runs in ``compute_dtype`` (default z's dtype)."""
    cd = z.dtype if compute_dtype is None else compute_dtype
    parts = []
    for y in _decode_chunks(vae, z, chunk_latent, cd):
        y = y.clamp(-1.0, 1.0).float()
        parts.append(torch.round(y * 127.5 + 127.5).clamp(0, 255)
                     .to(torch.uint8))
    return torch.cat(parts, dim=2)
