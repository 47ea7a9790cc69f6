"""Chain-of-frames editing pipeline, PyTorch (the stepwise path).

Counterpart of `videocof_tpu/pipeline/wan_pipeline.py` (`WanPipeline.__call__`
on its stepwise loop, ``VIDEOCOF_STEPWISE=1``, and the uint8 RGB output of
``VIDEOCOF_FETCH_YUV420=0``): umT5 prompt encoding with zero-padded
embeddings and no cross-attention mask; CoT latents ``[mu | noise(ground +
target)]`` (``cot=False``: the paired ``[mu | noise(target)]``); CoF
repeat-RoPE as per-token tables, with RIFLEx's temporal table on request;
the sampler's steps (Flow-UniPC, Euler or DPM++), each one DiT forward
followed by the source freeze ``v[:, :, :condition_count] = 0``; separate
decodes of the ground and edit segments, quantized to uint8. The VAE
streams every clip longer than ``vae_streaming_threshold_frames``
(`models/wan_vae_streaming.py`), as JAX's does, and runs whole below it.

Classifier-free guidance (``guidance_scale > 1``) encodes the negative
prompt and runs the uncond and cond rows as one batch (uncond first), or as
two batch-B forwards with ``cfg_sequential``, combined as ``vu + g (vc -
vu)``; ``cfg_skip_ratio`` drops the uncond rows in the last fraction of the
steps. TeaCache plans its skipped steps once from the timestep schedule and
replays the cached residual of the block stack on them. JAX's fused and
segmented samplers compute the same trajectory as this loop in one compiled
program; the port stays stepwise.

`text_to_video` denoises pure noise with standard RoPE and no source
freeze (JAX's stepwise t2v branch); `set_runtime_lora` attaches LoRA files
as runtime adapters, the LoRA path over fp8 weights. The VAE's type picks
the streaming module: the Wan2.2 VAE (`Wan22VAEConfig`) streams through
`wan_vae22_streaming`, the Wan2.1 one through `wan_vae_streaming`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import Wan22VAEConfig
from ..data.tokenizer import WanTokenizer
from ..models import teacache, wan_dit, wan_vae22_streaming, wan_vae_streaming
from ..models.rope import riflex_angle_table
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
        # the VAE streams clips longer than this (bounded activations: one
        # chunk's), in chunks of these many latent frames (JAX's defaults)
        self.vae_streaming_threshold_frames = 2
        self.vae_decode_chunk = 3
        self.vae_encode_chunk = 4

    # --------------------------------------------------------- runtime LoRA
    def set_runtime_lora(self, runtime) -> None:
        """Attach runtime LoRA adapters (`lora.load_runtime_lora`'s
        ``(adapters, scale)``) to every DiT of the pipeline, on its device:
        each block fuses its delta inside its call and the weights stay
        as stored (fp8 included). ``None`` detaches."""
        for dit in self._dits():
            dit.runtime_lora = (None if runtime is None else
                                (runtime[0].to(self.device), runtime[1]))

    def _dits(self) -> List[WanDiT]:
        return [self.dit]

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

    # -------------------------------------------------------------------- VAE
    def _vae_streaming(self):
        """The streaming module of this pipeline's VAE, chosen by its
        config's type (JAX's `_vae_mods`)."""
        if isinstance(self.vae.cfg, Wan22VAEConfig):
            return wan_vae22_streaming
        return wan_vae_streaming

    @torch.no_grad()
    def vae_encode(self, video: torch.Tensor) -> torch.Tensor:
        """[B, 3, T, H, W] in [-1, 1] -> mu in self.dtype, streamed when
        T > vae_streaming_threshold_frames."""
        video = video.to(self.dtype)
        if video.shape[2] > self.vae_streaming_threshold_frames:
            mu, _ = self._vae_streaming().encode_streaming(
                self.vae, video, chunk_latent=self.vae_encode_chunk)
        else:
            mu, _ = self.vae.encode(video)
        return mu

    @torch.no_grad()
    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents -> frames in [-1, 1], streamed above the threshold."""
        z = z.to(self.dtype)
        if z.shape[2] > self.vae_streaming_threshold_frames:
            return self._vae_streaming().decode_streaming(
                self.vae, z, chunk_latent=self.vae_decode_chunk)
        return self.vae.decode(z)

    @torch.no_grad()
    def decode_to_u8(self, z: torch.Tensor) -> torch.Tensor:
        """Latents -> device uint8 frames: clip(round(x * 127.5 + 127.5)),
        streamed chunk by chunk above the threshold."""
        if z.shape[2] > self.vae_streaming_threshold_frames:
            return self._vae_streaming().decode_streaming_u8(
                self.vae, z, chunk_latent=self.vae_decode_chunk,
                compute_dtype=self.dtype)
        x = self.vae.decode(z.to(self.dtype)).float()
        return torch.round(x * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)

    def _noise(self, shape, generator, noise) -> torch.Tensor:
        if noise is None:
            return torch.randn(shape, generator=generator,
                               device=self.device, dtype=torch.float32)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise {tuple(noise.shape)} != {tuple(shape)}")
        return noise

    @torch.no_grad()
    def prepare_cot_latents(self, video: torch.Tensor, ground_latent_count: int,
                            generator: Optional[torch.Generator] = None,
                            noise=None) -> torch.Tensor:
        """[mu(src) | noise(ground + tgt)], fp32. ``noise`` overrides the
        draw from ``generator``."""
        mu = self.vae_encode(video)
        B, C, Tl, H, W = mu.shape
        noise = self._noise((B, C, Tl + ground_latent_count, H, W), generator,
                            noise)
        return torch.cat([mu.float(), noise], dim=2)

    @torch.no_grad()
    def prepare_paired_latents(self, video: torch.Tensor,
                               generator: Optional[torch.Generator] = None,
                               noise=None) -> torch.Tensor:
        """[mu(src) | noise(tgt)], fp32, the target as long as the source
        (``cot=False``)."""
        mu = self.vae_encode(video)
        return torch.cat([mu.float(), self._noise(mu.shape, generator, noise)],
                         dim=2)

    # ------------------------------------------------------------------ step
    def _dit(self, dit, x, t_i, context, cos, sin, residual, skip):
        t = torch.full((x.shape[0],), t_i, dtype=torch.float32,
                       device=self.device)
        return dit.forward_with_residual(
            x.to(self.dtype), t, context, cos, sin,
            attn_backend=self.attn_backend, residual=residual,
            skip_blocks=skip)

    def _denoise_step(self, dit, latents, t_i, context, cos, sin, cfg: bool,
                      guidance_scale: float, condition_count: int,
                      residual=None, skip: bool = False):
        """One step's velocity and ``dit``'s TeaCache residual: with ``cfg``
        the latents are doubled against ``context`` = [uncond | cond] and
        combined as ``vu + g (vc - vu)``; then the source freeze. With
        ``cfg_sequential`` the two halves run as two batch-B forwards (the
        freeze is linear, so it commutes with the combine) and the residual
        is [uncond | cond] as the batched one."""
        if cfg and self.cfg_sequential:
            B = latents.shape[0]
            res = (None, None) if residual is None else residual.split(B)
            vu, res_u = self._dit(dit, latents, t_i, context[:B], cos, sin,
                                  res[0], skip)
            vc, res_c = self._dit(dit, latents, t_i, context[B:], cos, sin,
                                  res[1], skip)
            v, res = vu + guidance_scale * (vc - vu), torch.cat([res_u, res_c])
        else:
            x = torch.cat([latents, latents]) if cfg else latents
            v, res = self._dit(dit, x, t_i, context, cos, sin, residual,
                               skip)
            if cfg:
                vu, vc = v.chunk(2)
                v = vu + guidance_scale * (vc - vu)
        v[:, :, :condition_count] = 0.0      # freeze the source latents
        return v, res

    # ------------------------------------------------------------ trajectory
    def _stage_timer(self, timings: Optional[Dict[str, float]]
                     ) -> Callable[[str], None]:
        """``tick(label)`` records the wall seconds since the last tick into
        ``timings`` (synchronizing the device), a no-op without it."""
        t0 = time.perf_counter()

        def tick(label):
            nonlocal t0
            if timings is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                timings[label] = now - t0
                t0 = now
        return tick

    def _context(self, prompts, do_cfg, negative_prompt, max_sequence_length,
                 prompt_embeds, negative_prompt_embeds) -> torch.Tensor:
        """The text context in self.dtype: the prompts' embeddings, behind
        the negative prompt's (uncond first) with CFG."""
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
            context = torch.cat([neg.to(context.dtype), context])
        return context.to(self.dtype)

    @staticmethod
    def _scheduler(sampler, num_inference_steps, shift, solver_order):
        sched_kw = ({"solver_order": solver_order}
                    if solver_order is not None
                    and sampler in ("unipc", "dpm++") else {})
        sched = get_scheduler(sampler, **sched_kw)
        sched.set_timesteps(num_inference_steps, shift=shift)
        return sched

    def _plan_t2v_teacache(self, sched, num_inference_steps,
                           enable_teacache, teacache_threshold,
                           teacache_skip_start_steps, teacache_coefficients,
                           teacache_forced_plan, do_cfg, cfg_skip_ratio
                           ) -> Tuple[List[bool], int]:
        """(skipped steps, the first step without the uncond rows): the
        TeaCache plan (``teacache_forced_plan`` pinned, step 0 computed; or
        planned from the DiT's timestep modulations with
        ``teacache_coefficients``, default Wan2.1 T2V 14B's) and the
        cfg-skip cut, shared by the edit and text-to-video."""
        skips = [False] * num_inference_steps
        if enable_teacache and teacache_forced_plan is not None:
            skips = self._forced_plan(teacache_forced_plan,
                                      num_inference_steps)
        elif enable_teacache:
            skips = teacache.plan_teacache_skips(
                self.dit, sched.timesteps,
                teacache_coefficients
                or teacache.TEACACHE_COEFFICIENTS["wan2.1-t2v-14b"],
                teacache_threshold, teacache_skip_start_steps)
        cfg_off = num_inference_steps
        if do_cfg:
            cfg_off -= int(round(num_inference_steps * cfg_skip_ratio))
        return skips, cfg_off

    @staticmethod
    def _forced_plan(plan, num_inference_steps) -> List[bool]:
        if len(plan) != num_inference_steps:
            raise ValueError(f"teacache_forced_plan has {len(plan)} entries "
                             f"for {num_inference_steps} steps")
        skips = [bool(x) for x in plan]
        skips[0] = False   # step 0 has no residual to replay
        return skips

    def _expert_plan(self, sched, guidance_scale: float
                     ) -> List[Tuple[WanDiT, float]]:
        """(DiT, guidance scale) of each step: one DiT here; Wan2.2's MoE
        routes the high-noise steps to its second expert."""
        return [(self.dit, guidance_scale)] * len(sched.timesteps)

    def _t2v_denoise(self, latents, context, cos, sin, sched, do_cfg: bool,
                     guidance_scale: float, skips: Sequence[bool],
                     cfg_off: int, condition_count: int = 0,
                     tick: Optional[Callable[[str], None]] = None
                     ) -> torch.Tensor:
        """The stepwise trajectory from ``latents`` (JAX's stepwise branch of
        `_t2v_denoise` and of `__call__`): each step's DiT and guidance
        from `_expert_plan`, CFG until ``cfg_off``, TeaCache's cached
        residual replayed where ``skips``, the first ``condition_count``
        latent frames frozen (0: text-to-video). ``tick`` labels each
        step's wall time."""
        state = sched.init_state(latents)
        residual = None
        for i, (dit, g) in enumerate(self._expert_plan(sched,
                                                       guidance_scale)):
            step_cfg = do_cfg and i < cfg_off
            ctx_i = context
            if do_cfg and not step_cfg:
                ctx_i = context[context.shape[0] // 2:]   # cond rows only
            res_in = None
            if skips[i]:
                need = latents.shape[0] * (2 if step_cfg else 1)
                res_in = residual[-need:]   # cfg-skip keeps the cond rows
            v, res = self._denoise_step(
                dit, latents, float(sched.timesteps[i]), ctx_i, cos, sin,
                step_cfg, g, condition_count, res_in, skips[i])
            if not skips[i]:
                residual = res
            latents, state = sched.step(v, i, latents, state)
            if tick is not None:
                tick(f"step{i} skipped" if skips[i] else f"step{i}")
        return latents

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
                 riflex_k: Optional[int] = None,
                 riflex_L_test: Optional[int] = None,
                 riflex_L_test_scale: Optional[float] = None,
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
        plan instead (step 0 is always computed). ``riflex_k`` replaces the
        temporal RoPE's intrinsic frequency k by RIFLEx's (for
        ``riflex_L_test`` latent frames, default 66, optionally divided by
        ``riflex_L_test_scale``). ``cot=False`` edits paired latents [src |
        tgt] with no reasoning frames. ``solver_order`` reaches UniPC and
        DPM++ only. ``noise`` replaces the latent noise draw;
        ``latents`` skips latent preparation; ``prompt_embeds`` skips the
        text encoder; ``output_latents`` attaches the final latents. A dict
        passed as ``timings`` receives the wall seconds of each stage, one
        entry a step (``stepI``, or ``stepI skipped`` where TeaCache replayed
        the residual); the device is synchronized at each stage boundary
        only then."""
        tick = self._stage_timer(timings)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        video = self._prepare_video(video)
        if len(prompts) != video.shape[0]:
            raise ValueError(f"got {len(prompts)} prompts for batch of "
                             f"{video.shape[0]}")
        tc = self.vae.cfg.temporal_compression_ratio
        condition_count = latent_frame_count(source_frames, tc)
        ground_latent_count = (latent_frame_count(reasoning_frames, tc)
                               if cot else 0)

        do_cfg = guidance_scale > 1.0
        context = self._context(prompts, do_cfg, negative_prompt,
                                max_sequence_length, prompt_embeds,
                                negative_prompt_embeds)
        tick("text")

        if latents is not None:
            latents = torch.as_tensor(latents, dtype=torch.float32,
                                      device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            if cot:
                latents = self.prepare_cot_latents(video, ground_latent_count,
                                                   gen, noise=noise)
            else:
                latents = self.prepare_paired_latents(video, gen, noise=noise)
        _, _, Tl, Hl, Wl = latents.shape
        tick("encode+latents")

        ph, pw = self.dit.cfg.patch_size[1:]
        f_src = condition_count if repeat_rope else None
        f_ground = ground_latent_count if repeat_rope else 0
        temporal_table = None
        if riflex_k is not None:
            dcfg = self.dit.cfg
            temporal_table = riflex_angle_table(
                dcfg.head_dim, riflex_k, riflex_L_test or 66,
                riflex_L_test_scale, max_pos=dcfg.rope_max_pos,
                theta=dcfg.rope_theta)
        cos, sin = wan_dit.make_rope_for_geometry(
            self.dit.cfg, (Tl, Hl // ph, Wl // pw), f_src=f_src,
            f_ground=f_ground, temporal_table=temporal_table)
        cos = torch.as_tensor(cos, device=self.device)
        sin = torch.as_tensor(sin, device=self.device)

        sched = self._scheduler(sampler, num_inference_steps, shift,
                                solver_order)
        skips, cfg_off = self._plan_t2v_teacache(
            sched, num_inference_steps, enable_teacache, teacache_threshold,
            teacache_skip_start_steps, teacache_coefficients,
            teacache_forced_plan, do_cfg, cfg_skip_ratio)
        latents = self._t2v_denoise(latents, context, cos, sin, sched, do_cfg,
                                    guidance_scale, skips, cfg_off,
                                    condition_count, tick)

        out = self._decode_outputs(latents, condition_count,
                                   ground_latent_count)
        tick("decode")
        if output_latents:
            out.latents = latents.cpu().numpy()
        return out

    def _decode_outputs(self, latents: torch.Tensor, condition_count: int,
                        ground_latent_count: int) -> WanPipelineOutput:
        """Decode the ground segment (if any) and the edit segment
        separately to uint8, and hand them to the host as one array in
        [0, 1]."""
        g0, g1 = condition_count, condition_count + ground_latent_count
        parts = []
        if g1 > g0:
            parts.append(self.decode_to_u8(latents[:, :, g0:g1]))
        parts.append(self.decode_to_u8(latents[:, :, g1:]))
        host = torch.cat(parts, dim=2).cpu().numpy().astype(np.float32) / 255.0
        tc = self.vae.cfg.temporal_compression_ratio
        gf = 1 + (g1 - g0 - 1) * tc if g1 > g0 else 0   # ground pixel frames
        return WanPipelineOutput(
            videos=host, ground_videos=host[:, :, :gf] if gf else None,
            edit_videos=host[:, :, gf:])

    # -------------------------------------------------------- text-to-video
    @torch.no_grad()
    def text_to_video(self, prompt: Union[str, Sequence[str]], *,
                      negative_prompt: str = "", height: int = 480,
                      width: int = 832, num_frames: int = 81,
                      num_inference_steps: int = 50,
                      guidance_scale: float = 5.0, shift: float = 5.0,
                      sampler: str = "unipc", seed: int = 0,
                      max_sequence_length: int = 512,
                      prompt_embeds=None, negative_prompt_embeds=None,
                      noise=None, output_latents: bool = False,
                      solver_order: Optional[int] = None,
                      enable_teacache: bool = False,
                      teacache_threshold: float = 0.10,
                      teacache_skip_start_steps: int = 5,
                      teacache_coefficients: Optional[Sequence[float]] = None,
                      teacache_forced_plan: Optional[Sequence[bool]] = None,
                      cfg_skip_ratio: float = 0.0,
                      timings: Optional[Dict[str, float]] = None
                      ) -> WanPipelineOutput:
        """Text-to-video with JAX's defaults (the reference's
        `Wan2_2Pipeline` flow): noise latents [B, z_dim, (F - 1) // 4 + 1,
        H / s, W / s] from ``seed`` (or ``noise``), standard RoPE, no
        source freeze, CFG against ``negative_prompt`` when
        ``guidance_scale > 1``, TeaCache and cfg-skip as in `__call__`, and
        the whole clip decoded to uint8 (streamed above the threshold).
        ``timings`` receives the stage walls as `__call__`'s does."""
        tick = self._stage_timer(timings)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        do_cfg = guidance_scale > 1.0
        context = self._context(prompts, do_cfg, negative_prompt,
                                max_sequence_length, prompt_embeds,
                                negative_prompt_embeds)
        tick("text")
        vcfg = self.vae.cfg
        sc = vcfg.spatial_compression_ratio
        shape = (len(prompts), vcfg.z_dim,
                 latent_frame_count(num_frames,
                                    vcfg.temporal_compression_ratio),
                 height // sc, width // sc)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        latents = self._noise(shape, gen, noise)
        ph, pw = self.dit.cfg.patch_size[1:]
        cos, sin = wan_dit.make_rope_for_geometry(
            self.dit.cfg, (shape[2], shape[3] // ph, shape[4] // pw))
        cos = torch.as_tensor(cos, device=self.device)
        sin = torch.as_tensor(sin, device=self.device)
        tick("latents")
        sched = self._scheduler(sampler, num_inference_steps, shift,
                                solver_order)
        skips, cfg_off = self._plan_t2v_teacache(
            sched, num_inference_steps, enable_teacache, teacache_threshold,
            teacache_skip_start_steps, teacache_coefficients,
            teacache_forced_plan, do_cfg, cfg_skip_ratio)
        latents = self._t2v_denoise(latents, context, cos, sin, sched, do_cfg,
                                    guidance_scale, skips, cfg_off, 0, tick)
        host = self.decode_to_u8(latents).cpu().numpy().astype(
            np.float32) / 255.0
        tick("decode")
        out = WanPipelineOutput(videos=host, edit_videos=host)
        if output_latents:
            out.latents = latents.cpu().numpy()
        return out
