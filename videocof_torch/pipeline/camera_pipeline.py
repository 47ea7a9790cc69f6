"""Camera-controlled text-to-video, PyTorch.

Counterpart of the JAX package's `pipeline/camera_pipeline.py`: RealEstate10K
pose rows -> Plücker-ray maps (`data/camera.py`) -> latent-frame-aligned
24-channel maps (`pack_camera_frames`: frame 0 repeated 4 times, then every
4 frames folded into the channels) -> `CameraAdapter` -> the DiT's
``y_camera`` through the stepwise text-to-video trajectory.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..data.camera import pose_params_to_embedding
from ..models.camera_adapter import CameraAdapter
from ..utils.profiling import spanned
from .wan_pipeline import WanPipeline, WanPipelineOutput, latent_frame_count

_PREFIX = "control_adapter."


def convert_camera_adapter_state_dict(sd, dtype: torch.dtype = torch.float32
                                      ) -> Dict[str, torch.Tensor]:
    """The reference's ``control_adapter.*`` keys
    (`wan_camera_adapter.py:5-41`) -> `CameraAdapter` state dict."""
    out = {}
    for k, v in sd.items():
        if k.startswith(_PREFIX):
            k = k[len(_PREFIX):].replace("residual_blocks.", "res.")
            out[k] = torch.as_tensor(v).to(dtype)
    return out


def export_camera_adapter_state_dict(sd) -> Dict[str, torch.Tensor]:
    """`CameraAdapter` state dict -> the published ``control_adapter.*``
    keys (the inverse of `convert_camera_adapter_state_dict`)."""
    return {_PREFIX + k.replace("res.", "residual_blocks."): v
            for k, v in sd.items()}


def camera_adapter_from_state_dict(sd: Dict[str, torch.Tensor], dtype,
                                   device) -> CameraAdapter:
    """A `CameraAdapter` shaped by (and holding) a converted state dict."""
    w = sd["conv.weight"]
    n_res = sum(1 for k in sd if k.endswith(".conv1.weight"))
    adapter = CameraAdapter(w.shape[1] // 64, w.shape[0], w.shape[-1],
                            num_residual_blocks=n_res, dtype=dtype,
                            device="meta")
    adapter.load_state_dict(sd, strict=True, assign=True)
    return adapter.to(device)


def pack_camera_frames(rays: torch.Tensor, tc: int = 4) -> torch.Tensor:
    """[B, 6, F, H, W] ray maps -> [B, 6*tc, F', H, W], F' = (F-1)//tc + 1:
    frame 0 repeated ``tc`` times, then groups of ``tc`` frames folded into
    the channels."""
    B, C, F, H, W = rays.shape
    if (F - 1) % tc != 0:
        raise ValueError(
            f"camera stream has {F} frames; need (F-1) % {tc} == 0 "
            f"(latent-frame alignment): pass 1 + k*{tc} pose rows, e.g. "
            f"{(F - 1) // tc * tc + 1} or {((F - 1) // tc + 1) * tc + 1}")
    x = torch.cat([rays[:, :, :1].repeat(1, 1, tc, 1, 1), rays[:, :, 1:]],
                  dim=2)                                 # [B, C, tc*F', H, W]
    Fp = x.shape[2] // tc
    x = x.reshape(B, C, Fp, tc, H, W)
    return x.permute(0, 3, 1, 2, 4, 5).reshape(B, tc * C, Fp, H, W)


class CameraPipeline(WanPipeline):
    """`WanPipeline` + Plücker-ray camera control (`models/camera_adapter`)."""

    def __init__(self, *args, camera: Optional[CameraAdapter] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if camera is None:
            raise ValueError("CameraPipeline needs its adapter (camera=, from "
                             "init_camera_adapter or "
                             "convert_camera_adapter_state_dict)")
        self.camera = camera.to(self.device)

    @torch.no_grad()
    def prepare_camera_features(self, cam_params, height: int, width: int
                                ) -> torch.Tensor:
        """Pose rows (or a [T, H, W, 6] embedding) -> ``y_camera``
        [1, dim, T', H/16, W/16] on the DiT's patch grid."""
        arr = np.asarray(cam_params, np.float32)
        emb = (arr if arr.ndim == 4 and arr.shape[-1] == 6
               else pose_params_to_embedding(arr, width, height))
        rays = torch.as_tensor(emb, device=self.device).permute(3, 0, 1,
                                                                2)[None]
        packed = pack_camera_frames(rays,
                                    self.vae.cfg.temporal_compression_ratio)
        return self.camera(packed.to(self.dtype))

    @torch.no_grad()
    @spanned("videocof.edit")
    def camera_to_video(self, prompt: Union[str, Sequence[str]], cam_params,
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
        """Text + camera trajectory (``num_frames`` pose rows, or their
        embedding) -> a video following the camera, with JAX's defaults;
        ``timings`` receives the stage walls."""
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
        y_camera = self.prepare_camera_features(cam_params, height, width)
        if y_camera.shape[2] != Tl:
            raise ValueError(
                f"camera trajectory covers {y_camera.shape[2]} latent "
                f"frames, video needs {Tl}: pass {num_frames} pose rows")
        y_camera = y_camera.expand(B, *y_camera.shape[1:])
        ph, pw = self.dit.cfg.patch_size[1:]
        cos, sin = self._rope((Tl, Hl // ph, Wl // pw))
        tick("camera+latents")
        sched = self._scheduler(sampler, num_inference_steps, shift,
                                solver_order)
        latents = self._t2v_denoise(latents, context, cos, sin, sched, do_cfg,
                                    guidance_scale,
                                    [False] * num_inference_steps,
                                    num_inference_steps, 0, tick,
                                    {"y_camera": y_camera})
        return self._decode_whole(latents, output_latents, tick)
