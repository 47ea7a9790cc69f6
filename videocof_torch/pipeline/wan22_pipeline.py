"""Wan2.2 dual-expert (MoE) pipeline, PyTorch (the stepwise path).

Counterpart of `videocof_tpu/pipeline/wan22_pipeline.py` (the reference's
`pipeline_wan2_2.py`): two DiT experts split by noise level. The high-noise
expert ``dit_2`` runs the steps whose timestep is at least ``boundary *
num_train_timesteps`` (0.875 x 1000), at ``guidance_scale_2``; the base
expert ``dit`` runs the rest at ``guidance_scale``. The schedule decreases
monotonically, so the high-noise steps are a leading run of
``_split_idx`` steps. TeaCache is planned per expert, with a forced
recompute at the boundary (a residual of one expert is never replayed into
the other). Both experts are the t2v Wan DiT (`wan_dit.py`). JAX's fused
and segmented dual-expert samplers are not ported: the port runs the steps
one by one, as JAX's ``VIDEOCOF_STEPWISE=1`` does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..models import teacache
from ..models.wan_dit import WanDiT
from .wan_pipeline import WanPipeline, WanPipelineOutput


class Wan22Pipeline(WanPipeline):
    def __init__(self, *args, dit_2: Optional[WanDiT] = None,
                 boundary: float = 0.875, num_train_timesteps: int = 1000,
                 **kwargs):
        super().__init__(*args, **kwargs)
        # the high-noise expert (None: the base expert runs every step)
        self.dit_2 = None if dit_2 is None else dit_2.to(self.device)
        self.boundary = boundary
        self.num_train_timesteps = num_train_timesteps
        # guidance of the high-noise steps during a call (None: the base's)
        self._guidance_scale_2: Optional[float] = None
        if dit_2 is not None:
            # beside two experts' weights JAX keeps the smaller decode chunk
            self.vae_decode_chunk = 2

    def _dits(self) -> List[WanDiT]:
        return [self.dit] + ([] if self.dit_2 is None else [self.dit_2])

    def _split_idx(self, sched) -> int:
        """The leading steps routed to the high-noise expert."""
        if self.dit_2 is None:
            return 0
        thr = self.boundary * self.num_train_timesteps
        return int(sum(float(t) >= thr for t in sched.timesteps))

    def expert_for_timestep(self, t: float) -> WanDiT:
        """The high-noise expert at or above the boundary, the base expert
        below."""
        if (self.dit_2 is not None
                and t >= self.boundary * self.num_train_timesteps):
            return self.dit_2
        return self.dit

    def _expert_plan(self, sched, guidance_scale: float
                     ) -> List[Tuple[WanDiT, float]]:
        g2 = (guidance_scale if self._guidance_scale_2 is None
              else self._guidance_scale_2)
        split = self._split_idx(sched)
        return [(self.dit_2, g2) if i < split else (self.dit, guidance_scale)
                for i in range(len(sched.timesteps))]

    def _plan_t2v_teacache(self, sched, num_inference_steps,
                           enable_teacache, teacache_threshold,
                           teacache_skip_start_steps, teacache_coefficients,
                           teacache_forced_plan, do_cfg, cfg_skip_ratio):
        """The plan per expert: each expert's steps planned from its own
        timestep modulations (default coefficients Wan2.1 I2V 14B 720p's,
        the reference's Wan2.2 alias), the boundary step computed."""
        skips, cfg_off = super()._plan_t2v_teacache(
            sched, num_inference_steps, False, teacache_threshold,
            teacache_skip_start_steps, teacache_coefficients, None, do_cfg,
            cfg_skip_ratio)
        split = self._split_idx(sched)
        if enable_teacache and teacache_forced_plan is not None:
            skips = self._forced_plan(teacache_forced_plan,
                                      num_inference_steps)
            if 0 < split < num_inference_steps:
                skips[split] = False
        elif enable_teacache:
            coeffs = (teacache_coefficients or
                      teacache.TEACACHE_COEFFICIENTS["wan2.1-i2v-14b-720p"])
            ts = [float(t) for t in sched.timesteps]
            hi = self.dit_2 if self.dit_2 is not None else self.dit
            plan_hi = teacache.plan_teacache_skips(
                hi, ts[:split], coeffs, teacache_threshold,
                teacache_skip_start_steps) if split else []
            plan_lo = teacache.plan_teacache_skips(
                self.dit, ts[split:], coeffs, teacache_threshold,
                max(0, teacache_skip_start_steps - split)
            ) if split < num_inference_steps else []
            skips = list(plan_hi) + list(plan_lo)
        return skips, cfg_off

    def text_to_video(self, prompt, *, guidance_scale: float = 5.0,
                      guidance_scale_2: Optional[float] = None, **kw
                      ) -> WanPipelineOutput:
        """`WanPipeline.text_to_video` with the high-noise steps on
        ``dit_2`` at ``guidance_scale_2`` (default ``guidance_scale``)."""
        self._guidance_scale_2 = guidance_scale_2
        try:
            return super().text_to_video(prompt,
                                         guidance_scale=guidance_scale, **kw)
        finally:
            self._guidance_scale_2 = None

    def __call__(self, video, prompt, *, num_inference_steps: int = 50,
                 guidance_scale: float = 5.0,
                 guidance_scale_2: Optional[float] = None,
                 shift: float = 5.0, **kw) -> WanPipelineOutput:
        """The chain-of-frames (or, with ``cot=False``, the paired) edit of
        `WanPipeline.__call__` with JAX's Wan2.2 defaults (50 steps,
        guidance 5, shift 5) and the high-noise steps on ``dit_2`` at
        ``guidance_scale_2`` (default ``guidance_scale``)."""
        self._guidance_scale_2 = guidance_scale_2
        try:
            return super().__call__(
                video, prompt, num_inference_steps=num_inference_steps,
                guidance_scale=guidance_scale, shift=shift, **kw)
        finally:
            self._guidance_scale_2 = None
