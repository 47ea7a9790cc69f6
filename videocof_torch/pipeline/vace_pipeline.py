"""VACE control-to-video, PyTorch.

Counterpart of the JAX package's `pipeline/vace_pipeline.py`. The control
context is the 96-channel layout the VACE transformer takes (16 inactive
latent + 16 reactive latent + 64 mask channels): ``frames * (1 - mask)``
and ``frames * mask`` VAE-encoded apart, and the binary mask folded 8 x 8
into channels and resampled to the latent frames. Full generation under a
control map (depth, pose, scribble) is ``mask = 1`` everywhere. The denoise
is the stepwise text-to-video trajectory with `wan_dit_vace.vace_forward`
as the velocity model; CFG doubles the control context beside the latents.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..models.wan_dit_vace import WanVace, vace_forward
from ..utils.profiling import spanned
from .wan_pipeline import WanPipeline, WanPipelineOutput, latent_frame_count


def patchify_mask(mask: torch.Tensor, sc: int, t_latent: int) -> torch.Tensor:
    """[B, 1, F, H, W] binary mask -> [B, sc*sc, T_latent, H/sc, W/sc]: each
    sc x sc block becomes channels, and the frames are resampled to the
    latent frame count at nearest-exact indices."""
    B, _, F, H, W = mask.shape
    m = mask.reshape(B, F, H // sc, sc, W // sc, sc)
    m = m.permute(0, 3, 5, 1, 2, 4).reshape(B, sc * sc, F, H // sc, W // sc)
    idx = np.clip(np.round((np.arange(t_latent) + 0.5) * (F / t_latent)
                           - 0.5), 0, F - 1).astype(np.int64)
    return m[:, :, torch.as_tensor(idx, device=mask.device)]


class VacePipeline(WanPipeline):
    """`WanPipeline` + the VACE hint branch (`models/wan_dit_vace.py`)."""

    def __init__(self, *args, vace: Optional[WanVace] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if vace is None:
            raise ValueError("VacePipeline needs its control branch (vace=, "
                             "from init_vace_params or "
                             "convert_vace_state_dict)")
        self.vace = vace.to(self.device)

    @torch.no_grad()
    def prepare_vace_context(self, control_video, mask=None) -> torch.Tensor:
        """[B, 2*z + sc^2, T', H', W'] fp32 control context of
        ``control_video`` ([B, 3, F, H, W], uint8 or float in [-1, 1]) and
        ``mask`` ([B, 1, F, H, W] in {0, 1}, 1 = generate; default all
        ones)."""
        video = torch.as_tensor(control_video, device=self.device)
        if video.dtype == torch.uint8:
            video = video.float() * (2.0 / 255.0) - 1.0
        video = video.float()
        B, _, F, H, W = video.shape
        vcfg = self.vae.cfg
        t_latent = latent_frame_count(F, vcfg.temporal_compression_ratio)
        if mask is None:
            mask = torch.ones((B, 1, F, H, W), device=self.device)
        else:
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=self.device)
        inactive = self.vae_encode(video * (1.0 - mask)).float()
        reactive = self.vae_encode(video * mask).float()
        return torch.cat([inactive, reactive,
                          patchify_mask(mask, vcfg.spatial_compression_ratio,
                                        t_latent)], dim=1)

    def _vace_velocity(self, context_scale, dit, x, t, context, cos, sin,
                       residual, skip, sp, cond):
        v = vace_forward(dit, self.vace, x.to(self.dtype),
                         cond["vace_context"].to(self.dtype), t, context,
                         cos, sin, context_scale=context_scale,
                         attn_backend=self.attn_backend)
        return v, None

    @torch.no_grad()
    @spanned("videocof.edit")
    def control_to_video(self, prompt: Union[str, Sequence[str]],
                         control_video, *, mask=None,
                         negative_prompt: str = "",
                         num_inference_steps: int = 50,
                         guidance_scale: float = 5.0,
                         context_scale: float = 1.0, shift: float = 5.0,
                         sampler: str = "unipc", seed: int = 0,
                         max_sequence_length: int = 512, noise=None,
                         solver_order: Optional[int] = None,
                         output_latents: bool = False,
                         timings: Optional[Dict[str, float]] = None
                         ) -> WanPipelineOutput:
        """Text + control video (+ an optional region mask) -> video, with
        JAX's defaults; ``context_scale`` weighs the hints. Noise of the
        control context's latent shape from ``seed`` (or ``noise``);
        ``timings`` receives the stage walls."""
        tick = self._stage_timer(timings)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        do_cfg = guidance_scale > 1.0
        context = self._context(prompts, do_cfg, negative_prompt,
                                max_sequence_length, None, None)
        tick("text")
        vctx = self.prepare_vace_context(self._prepare_video(control_video),
                                         mask)
        if vctx.shape[0] != len(prompts):
            raise ValueError(f"got {len(prompts)} prompts for a control "
                             f"batch of {vctx.shape[0]}")
        B, _, Tl, Hl, Wl = vctx.shape
        gen = torch.Generator(device=self.device).manual_seed(seed)
        latents = self._noise((B, self.vae.cfg.z_dim, Tl, Hl, Wl), gen, noise)
        ph, pw = self.dit.cfg.patch_size[1:]
        cos, sin = self._rope((Tl, Hl // ph, Wl // pw))
        tick("encode+latents")
        sched = self._scheduler(sampler, num_inference_steps, shift,
                                solver_order)
        latents = self._t2v_denoise(
            latents, context, cos, sin, sched, do_cfg, guidance_scale,
            [False] * num_inference_steps, num_inference_steps, 0, tick,
            {"vace_context": vctx},
            functools.partial(self._vace_velocity, float(context_scale)))
        return self._decode_whole(latents, output_latents, tick)
