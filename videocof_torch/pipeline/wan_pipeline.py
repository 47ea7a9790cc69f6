"""Chain-of-frames editing pipeline, PyTorch (the stepwise path).

Counterpart of `videocof_tpu/pipeline/wan_pipeline.py` (`WanPipeline.__call__`
with ``cot=True`` on its stepwise loop, ``VIDEOCOF_STEPWISE=1``, and the uint8
RGB output of ``VIDEOCOF_FETCH_YUV420=0``): umT5 prompt encoding with
zero-padded embeddings and no cross-attention mask; CoT latents ``[mu |
noise(ground + target)]``; CoF repeat-RoPE as per-token tables; the sampler's
steps (Flow-UniPC, Euler or DPM++), each one DiT forward followed by the
source freeze ``v[:, :, :condition_count] = 0``; separate decodes of the
ground and edit segments, quantized to uint8.

Classifier-free guidance (``guidance_scale > 1``) encodes the negative
prompt and runs the uncond and cond rows as one batch (uncond first), or as
two batch-B forwards with ``cfg_sequential``, combined as ``vu + g (vc -
vu)``; ``cfg_skip_ratio`` drops the uncond rows in the last fraction of the
steps. TeaCache plans its skipped steps once from the timestep schedule and
replays the cached residual of the block stack on them. JAX's fused and
segmented samplers compute the same trajectory as this loop in one compiled
program; the port stays stepwise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..data.tokenizer import WanTokenizer
from ..models import teacache, wan_dit
from ..models.t5_encoder import T5Encoder
from ..models.wan_dit import WanDiT
from ..models.wan_vae import WanVAE
from ..schedulers import get_scheduler
from ..utils import colorspace


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
        # CFG as two batch-B DiT forwards instead of one batch-2B forward:
        # half the activations, the same result
        self.cfg_sequential = False

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
        """uint8 [0, 255] or float [-1, 1] [B, 3, T, H, W], or uint8 I420
        planes [B, T, H*3//2, W] (codec-native 4:2:0, half the bytes of
        uint8 RGB; the chroma is upsampled on the device) -> self.dtype in
        [-1, 1] on the device."""
        video = torch.as_tensor(video).to(self.device)
        if video.dtype == torch.uint8:
            if video.dim() == 4:
                return colorspace.i420_to_rgbm11(video).to(self.dtype)
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

    # ------------------------------------------------------------------ step
    def _dit(self, x, t_i, context, cos, sin, residual, skip):
        t = torch.full((x.shape[0],), t_i, dtype=torch.float32,
                       device=self.device)
        return self.dit.forward_with_residual(
            x.to(self.dtype), t, context, cos, sin,
            attn_backend=self.attn_backend, residual=residual,
            skip_blocks=skip)

    def _denoise_step(self, latents, t_i, context, cos, sin, cfg: bool,
                      guidance_scale: float, condition_count: int,
                      residual=None, skip: bool = False):
        """One step's velocity and the DiT's TeaCache residual: with ``cfg``
        the latents are doubled against ``context`` = [uncond | cond] and
        combined as ``vu + g (vc - vu)``; then the source freeze. With
        ``cfg_sequential`` the two halves run as two batch-B forwards (the
        freeze is linear, so it commutes with the combine) and the residual
        is [uncond | cond] as the batched one."""
        if cfg and self.cfg_sequential:
            B = latents.shape[0]
            res = (None, None) if residual is None else residual.split(B)
            vu, res_u = self._dit(latents, t_i, context[:B], cos, sin,
                                  res[0], skip)
            vc, res_c = self._dit(latents, t_i, context[B:], cos, sin,
                                  res[1], skip)
            v, res = vu + guidance_scale * (vc - vu), torch.cat([res_u, res_c])
        else:
            x = torch.cat([latents, latents]) if cfg else latents
            v, res = self._dit(x, t_i, context, cos, sin, residual, skip)
            if cfg:
                vu, vc = v.chunk(2)
                v = vu + guidance_scale * (vc - vu)
        v[:, :, :condition_count] = 0.0      # freeze the source latents
        return v, res

    # ------------------------------------------------------------------- call
    @torch.no_grad()
    def __call__(self, video, prompt: Union[str, Sequence[str]],
                 negative_prompt: str = "",
                 source_frames: int = 33, reasoning_frames: int = 4,
                 num_inference_steps: int = 4, guidance_scale: float = 1.0,
                 shift: float = 3.0, sampler: str = "unipc",
                 repeat_rope: bool = True, cot: bool = True, seed: int = 0,
                 max_sequence_length: int = 512,
                 prompt_embeds=None, negative_prompt_embeds=None,
                 enable_teacache: bool = False,
                 teacache_threshold: float = 0.10,
                 teacache_skip_start_steps: int = 5,
                 teacache_coefficients: Optional[Sequence[float]] = None,
                 teacache_forced_plan: Optional[Sequence[bool]] = None,
                 cfg_skip_ratio: float = 0.0,
                 noise=None, latents=None, output_latents: bool = False,
                 solver_order: Optional[int] = None,
                 timings: Optional[Dict[str, float]] = None
                 ) -> WanPipelineOutput:
        """Edit ``video`` ([B, 3, T, H, W], uint8 or float in [-1, 1], or
        uint8 I420 planes [B, T, H*3//2, W]) per ``prompt``, with the JAX
        pipeline's defaults and semantics.

        ``guidance_scale > 1`` turns on CFG against ``negative_prompt`` (or
        ``negative_prompt_embeds``); ``cfg_skip_ratio`` runs the last
        ``round(steps * ratio)`` steps on the cond rows only. TeaCache
        (``enable_teacache``) plans its skips from ``teacache_coefficients``
        (default: Wan2.1 T2V 14B's), ``teacache_threshold`` and
        ``teacache_skip_start_steps``; ``teacache_forced_plan`` pins the
        plan instead (step 0 is always computed). ``solver_order`` reaches
        UniPC and DPM++ only. ``noise`` replaces the latent noise draw;
        ``latents`` skips latent preparation; ``prompt_embeds`` skips the
        text encoder; ``output_latents`` attaches the final latents. A dict
        passed as ``timings`` receives the wall seconds of each stage, one
        entry a step (``stepI``, or ``stepI skipped`` where TeaCache replayed
        the residual); the device is synchronized at each stage boundary
        only then."""
        if not cot:
            raise NotImplementedError("only the chain-of-frames path is ported")
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

        do_cfg = guidance_scale > 1.0
        if prompt_embeds is not None:
            context = torch.as_tensor(prompt_embeds, device=self.device)
        else:
            context = self.encode_prompt(prompts, max_sequence_length)
        if do_cfg:
            if negative_prompt_embeds is not None:
                neg = torch.as_tensor(negative_prompt_embeds,
                                      device=self.device)
            else:
                neg = self.encode_prompt([negative_prompt] * len(prompts),
                                         max_sequence_length)
            context = torch.cat([neg.to(context.dtype), context])  # uncond first
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

        sched_kw = ({"solver_order": solver_order}
                    if solver_order is not None
                    and sampler in ("unipc", "dpm++") else {})
        sched = get_scheduler(sampler, **sched_kw)
        sched.set_timesteps(num_inference_steps, shift=shift)
        state = sched.init_state(latents)

        skips = [False] * num_inference_steps
        if enable_teacache and teacache_forced_plan is not None:
            if len(teacache_forced_plan) != num_inference_steps:
                raise ValueError(f"teacache_forced_plan has "
                                 f"{len(teacache_forced_plan)} entries for "
                                 f"{num_inference_steps} steps")
            skips = [bool(x) for x in teacache_forced_plan]
            skips[0] = False   # step 0 has no residual to replay
        elif enable_teacache:
            skips = teacache.plan_teacache_skips(
                self.dit, sched.timesteps,
                teacache_coefficients
                or teacache.TEACACHE_COEFFICIENTS["wan2.1-t2v-14b"],
                teacache_threshold, teacache_skip_start_steps)
        # cfg-skip: the uncond rows leave the last fraction of the steps
        cfg_off_after = num_inference_steps - int(
            round(num_inference_steps * cfg_skip_ratio))

        residual = None
        for i in range(num_inference_steps):
            step_cfg = do_cfg and i < cfg_off_after
            ctx_i = context
            if do_cfg and not step_cfg:
                ctx_i = context[context.shape[0] // 2:]   # cond rows only
            res_in = None
            if skips[i]:
                need = latents.shape[0] * (2 if step_cfg else 1)
                res_in = residual[-need:]   # cfg-skip keeps the cond rows
            v, res = self._denoise_step(
                latents, float(sched.timesteps[i]), ctx_i, cos, sin, step_cfg,
                guidance_scale, condition_count, res_in, skips[i])
            if not skips[i]:
                residual = res
            latents, state = sched.step(v, i, latents, state)
            tick(f"step{i} skipped" if skips[i] else f"step{i}")

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
