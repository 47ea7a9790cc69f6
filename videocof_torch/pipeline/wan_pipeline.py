"""Chain-of-frames editing pipeline, PyTorch (the stepwise path).

Counterpart of `videocof_tpu/pipeline/wan_pipeline.py` (`WanPipeline.__call__`
with ``cot=True``, no CFG, and the uint8 RGB output of
``VIDEOCOF_FETCH_YUV420=0``): umT5 prompt encoding with zero-padded
embeddings and no cross-attention mask; CoT latents ``[mu | noise(ground +
target)]``; CoF repeat-RoPE as per-token tables; Flow-UniPC steps, each one
DiT forward followed by the source freeze ``v[:, :, :condition_count] = 0``;
separate decodes of the ground and edit segments, quantized to uint8.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..data.tokenizer import WanTokenizer
from ..models import wan_dit
from ..models.t5_encoder import T5Encoder
from ..models.wan_dit import WanDiT
from ..models.wan_vae import WanVAE
from ..schedulers import FlowUniPCScheduler


@dataclasses.dataclass
class WanPipelineOutput:
    """Decoded videos as float numpy arrays in [0, 1], [B, C, T, H, W]."""
    videos: np.ndarray
    ground_videos: Optional[np.ndarray] = None
    edit_videos: Optional[np.ndarray] = None
    # final denoised latents, attached when __call__(output_latents=True)
    latents: Optional[np.ndarray] = None


def latent_frame_count(pixel_frames: int, ratio: int = 4) -> int:
    """(F - 1) // ratio + 1; F <= 1 -> 1."""
    if pixel_frames <= 1:
        return 1
    return (pixel_frames - 1) // ratio + 1


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device


class WanPipeline:
    def __init__(self, dit: WanDiT, vae: WanVAE, t5: T5Encoder,
                 tokenizer: Optional[WanTokenizer] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_backend: Optional[str] = None, device=None):
        self.device = _resolve_device(device)
        self.dit = dit.to(self.device)
        self.vae = vae.to(self.device)
        self.t5 = t5.to(self.device)
        self.tokenizer = tokenizer or WanTokenizer(vocab_size=t5.cfg.vocab)
        self.dtype = dtype
        self.attn_backend = attn_backend

    # ------------------------------------------------------------------ text
    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str], max_length: int = 512
                      ) -> torch.Tensor:
        """Prompts -> [B, text_len, text_dim] embeddings, zeroed past each
        prompt's length."""
        ids, mask = self.tokenizer(list(prompts), max_length=max_length)
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        e = self.t5(ids, mask)
        return e * mask[..., None].to(e.dtype)

    # ---------------------------------------------------------------- latents
    def _prepare_video(self, video) -> torch.Tensor:
        """uint8 [0, 255] or float [-1, 1] [B, 3, T, H, W] -> self.dtype in
        [-1, 1] on the device."""
        video = torch.as_tensor(video).to(self.device)
        if video.dtype == torch.uint8:
            return video.to(self.dtype) * (2.0 / 255.0) - 1.0
        return video.to(self.dtype)

    @torch.no_grad()
    def prepare_cot_latents(self, video: torch.Tensor, ground_latent_count: int,
                            generator: Optional[torch.Generator] = None,
                            noise=None) -> torch.Tensor:
        """[mu(src) | noise(ground + tgt)], fp32. ``noise`` overrides the
        draw from ``generator``."""
        mu, _ = self.vae.encode(video.to(self.dtype))
        B, C, Tl, H, W = mu.shape
        shape = (B, C, Tl + ground_latent_count, H, W)
        if noise is None:
            noise = torch.randn(shape, generator=generator,
                                device=self.device, dtype=torch.float32)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32,
                                    device=self.device)
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise {tuple(noise.shape)} != {shape}")
        return torch.cat([mu.float(), noise], dim=2)

    @torch.no_grad()
    def decode_to_u8(self, z: torch.Tensor) -> torch.Tensor:
        """Latents -> device uint8 frames: clip(round(x * 127.5 + 127.5))."""
        x = self.vae.decode(z.to(self.dtype)).float()
        return torch.round(x * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)

    # ------------------------------------------------------------------- call
    @torch.no_grad()
    def __call__(self, video, prompt: Union[str, Sequence[str]],
                 source_frames: int = 33, reasoning_frames: int = 4,
                 num_inference_steps: int = 4, guidance_scale: float = 1.0,
                 shift: float = 3.0, sampler: str = "unipc",
                 repeat_rope: bool = True, cot: bool = True, seed: int = 0,
                 max_sequence_length: int = 512,
                 prompt_embeds=None, noise=None, latents=None,
                 output_latents: bool = False,
                 timings: Optional[Dict[str, float]] = None
                 ) -> WanPipelineOutput:
        """Edit ``video`` ([B, 3, T, H, W], uint8 or float in [-1, 1]) per
        ``prompt``.

        ``noise`` replaces the latent noise draw; ``latents`` skips latent
        preparation; ``prompt_embeds`` skips the text encoder;
        ``output_latents`` attaches the final latents. A dict passed as
        ``timings`` receives the wall seconds of each stage (the device is
        synchronized at each stage boundary only then)."""
        if guidance_scale > 1.0:
            raise NotImplementedError("classifier-free guidance is not ported")
        if not cot:
            raise NotImplementedError("only the chain-of-frames path is ported")
        if sampler != "unipc":
            raise NotImplementedError(f"sampler {sampler!r} is not ported")
        t0 = time.perf_counter()

        def tick(label):
            nonlocal t0
            if timings is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                timings[label] = now - t0
                t0 = now

        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        video = self._prepare_video(video)
        if len(prompts) != video.shape[0]:
            raise ValueError(f"got {len(prompts)} prompts for batch of "
                             f"{video.shape[0]}")
        tc = self.vae.cfg.temporal_compression_ratio
        condition_count = latent_frame_count(source_frames, tc)
        ground_latent_count = latent_frame_count(reasoning_frames, tc)

        if prompt_embeds is not None:
            context = torch.as_tensor(prompt_embeds, device=self.device)
        else:
            context = self.encode_prompt(prompts, max_sequence_length)
        context = context.to(self.dtype)
        tick("text")

        if latents is not None:
            latents = torch.as_tensor(latents, dtype=torch.float32,
                                      device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            latents = self.prepare_cot_latents(video, ground_latent_count,
                                               gen, noise=noise)
        _, _, Tl, Hl, Wl = latents.shape
        tick("encode+latents")

        ph, pw = self.dit.cfg.patch_size[1:]
        f_src = condition_count if repeat_rope else None
        f_ground = ground_latent_count if repeat_rope else 0
        cos, sin = wan_dit.make_rope_for_geometry(
            self.dit.cfg, (Tl, Hl // ph, Wl // pw), f_src=f_src,
            f_ground=f_ground)
        cos = torch.as_tensor(cos, device=self.device)
        sin = torch.as_tensor(sin, device=self.device)

        sched = FlowUniPCScheduler()
        sched.set_timesteps(num_inference_steps, shift=shift)
        state = sched.init_state(latents)
        B = latents.shape[0]
        for i in range(num_inference_steps):
            t = torch.full((B,), float(sched.timesteps[i]), dtype=torch.float32,
                           device=self.device)
            v = self.dit(latents.to(self.dtype), t, context, cos, sin,
                         attn_backend=self.attn_backend)
            v[:, :, :condition_count] = 0.0      # freeze the source latents
            latents, state = sched.step(v, i, latents, state)
            tick(f"step{i}")

        g0, g1 = condition_count, condition_count + ground_latent_count
        parts = []
        if g1 > g0:
            parts.append(self.decode_to_u8(latents[:, :, g0:g1]))
        parts.append(self.decode_to_u8(latents[:, :, g1:]))
        host = torch.cat(parts, dim=2).cpu().numpy().astype(np.float32) / 255.0
        tick("decode")
        gf = 1 + (g1 - g0 - 1) * tc if g1 > g0 else 0   # ground pixel frames
        return WanPipelineOutput(
            videos=host, ground_videos=host[:, :, :gf] if gf else None,
            edit_videos=host[:, :, gf:],
            latents=latents.cpu().numpy() if output_latents else None)
