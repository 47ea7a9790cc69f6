"""Speech-to-video, PyTorch.

Counterpart of the JAX package's `pipeline/s2v_pipeline.py`: a text prompt and
precomputed per-latent-frame audio features [B, T_latent, audio_dim] ->
video. The stepwise text-to-video trajectory with
`wan_dit_s2v.wan_s2v_forward` as the velocity model: one token segment
(``seg_ids`` 0, so the segment AdaLN is the plain modulation), per-sample
RoPE tables broadcast from the grid's, and CFG doubling the audio
features beside the latents. JAX has no factory or CLI entry for S2V, and
neither has the port.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Union

import torch

from ..models.wan_dit_s2v import WanS2V, wan_s2v_forward
from ..utils.profiling import spanned
from .wan_pipeline import WanPipeline, WanPipelineOutput, latent_frame_count


class S2VPipeline(WanPipeline):
    """`WanPipeline` + audio injection (`models/wan_dit_s2v.py`)."""

    def __init__(self, *args, s2v: Optional[WanS2V] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if s2v is None:
            raise ValueError("S2VPipeline needs its audio modules (s2v=, "
                             "from init_s2v_params)")
        self.s2v = s2v.to(self.device)

    def _s2v_velocity(self, seg_ids, dit, x, t, context, cos, sin, residual,
                      skip, sp, cond):
        B = x.shape[0]
        cos, sin = cos.expand(B, *cos.shape), sin.expand(B, *sin.shape)
        v = wan_s2v_forward(dit, self.s2v, x.to(self.dtype), t, context, cos,
                            sin, seg_ids, audio_feats=cond.get("audio"),
                            attn_backend=self.attn_backend)
        return v, None

    @torch.no_grad()
    @spanned("videocof.edit")
    def speech_to_video(self, prompt: Union[str, Sequence[str]], audio_feats,
                        *, negative_prompt: str = "", height: int = 480,
                        width: int = 832, num_frames: int = 81,
                        num_inference_steps: int = 50,
                        guidance_scale: float = 5.0, shift: float = 5.0,
                        sampler: str = "unipc", seed: int = 0,
                        max_sequence_length: int = 512, noise=None,
                        solver_order: Optional[int] = None,
                        output_latents: bool = False,
                        timings: Optional[Dict[str, float]] = None
                        ) -> WanPipelineOutput:
        """Text + audio features aligned to the latent frames (or None) ->
        video, with JAX's defaults; ``timings`` receives the stage walls."""
        tick = self._stage_timer(timings)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompts)
        do_cfg = guidance_scale > 1.0
        context = self._context(prompts, do_cfg, negative_prompt,
                                max_sequence_length, None, None)
        tick("text")
        vcfg = self.vae.cfg
        sc = vcfg.spatial_compression_ratio
        Tl = latent_frame_count(num_frames, vcfg.temporal_compression_ratio)
        Hl, Wl = height // sc, width // sc
        gen = torch.Generator(device=self.device).manual_seed(seed)
        latents = self._noise((B, vcfg.z_dim, Tl, Hl, Wl), gen, noise)
        cond = {}
        if audio_feats is not None:
            audio = torch.as_tensor(audio_feats, device=self.device)
            if audio.shape[1] != Tl:
                raise ValueError(f"audio_feats must align to {Tl} latent "
                                 f"frames, got {audio.shape[1]}")
            cond["audio"] = audio
        ph, pw = self.dit.cfg.patch_size[1:]
        grid = (Tl, Hl // ph, Wl // pw)
        cos, sin = self._rope(grid)
        seg_ids = torch.zeros(grid[0] * grid[1] * grid[2], dtype=torch.long,
                              device=self.device)
        tick("latents")
        sched = self._scheduler(sampler, num_inference_steps, shift,
                                solver_order)
        latents = self._t2v_denoise(
            latents, context, cos, sin, sched, do_cfg, guidance_scale,
            [False] * num_inference_steps, num_inference_steps, 0, tick, cond,
            functools.partial(self._s2v_velocity, seg_ids))
        return self._decode_whole(latents, output_latents, tick)
