"""Generation pipelines of the non-Wan families: CogVideoX, QwenImage, Flux.

Counterpart of `videocof_tpu/pipeline/image_pipelines.py`. Text encoders
are out of scope, as in JAX and the reference (T5-XXL, CLIP + T5,
Qwen2.5-VL): each pipeline takes precomputed text embeddings.

  * `CogVideoXPipeline`: text-to-video, DDIM (v-prediction, zero-terminal
    SNR) with classifier-free guidance as one batch of 2, decoded whole by
    `models.cogvideox_vae`.
  * `QwenImagePipeline`: text-to-image, flow-matching Euler with the
    resolution-aware mu shift and true CFG (two forwards a step), decoded
    as one frame by the Wan2.1 VAE (`models.qwenimage_vae`), or latents
    without a VAE.
  * `FluxPipeline`: text-to-image, guidance-distilled flow Euler; pixels
    through ``decode_fn`` (`models.kl_vae.make_decode_fn`), else latents.

The starting latents are drawn from a ``torch.Generator`` seeded with
``seed`` on the pipeline's device, in the shape JAX draws them ([B, F, C,
h, w] for CogVideoX, [B, C, h, w] before packing for the image families);
``latents=`` hands in a draw instead (the one keyword beyond JAX's
signatures: the tests give both packages JAX's draw). Every pipeline runs
its sampler stepwise. The entry points run on CUDA unless ``device`` names
the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models import cogvideox as cog
from ..models import cogvideox_vae as cvae
from ..models import flux as flux_lib
from ..models import qwenimage as qwen_lib
from ..schedulers import get_scheduler
from .wan_pipeline import _resolve_device


def calculate_mu_shift(seq_len: int, base_seq_len: int = 256,
                       max_seq_len: int = 4096, base_shift: float = 0.5,
                       max_shift: float = 1.15) -> float:
    """Flux's and Qwen's dynamic timestep shift: mu linear in the image
    token count (diffusers' `calculate_shift`)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    return seq_len * m + (base_shift - m * base_seq_len)


def _pack_latents(z: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, (h/2)(w/2), C*4]: 2x2 patches, features (C, 2,
    2) (diffusers' `_pack_latents`)."""
    B, C, h, w = z.shape
    z = z.reshape(B, C, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return z.reshape(B, (h // 2) * (w // 2), C * 4)


def _unpack_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    B, L, Fe = x.shape
    C = Fe // 4
    x = x.reshape(B, h // 2, w // 2, C, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, C, h, w)


class _SPMixin:
    """Sequence parallelism of the family pipelines (the reference's
    per-family xfuser adapters, `dist/cogvideox_xfuser.py`,
    `flux_xfuser.py`, `qwen_xfuser.py`): the whole forward runs over the
    mesh's seq axis, both joint streams token-sharded (each padded apart)
    and the attention the Ulysses or ring one. Every rank runs each call
    with the same arguments and seed and gets the whole output."""

    attn_backend = None
    sp_ctx = None

    def enable_sequence_parallel(self, mesh=None, data: int = 1,
                                 seq: Optional[int] = None,
                                 mode: str = "ulysses") -> None:
        from ..parallel import (SPContext, make_mesh, make_ring_attention,
                                make_ulysses_attention)
        if mesh is None:
            world = torch.distributed.get_world_size()
            mesh = make_mesh(data=data, seq=seq or max(1, world // data))
        maker = {"ulysses": make_ulysses_attention,
                 "ring": make_ring_attention}[mode]
        self._local_backend = self.attn_backend
        self.attn_backend = maker(mesh)
        self.sp_ctx = SPContext(mesh)

    def disable_sequence_parallel(self) -> None:
        if self.sp_ctx is not None:
            self.attn_backend = self._local_backend
        self.sp_ctx = None


def _tensor(a, device) -> torch.Tensor:
    """An embedding (numpy or tensor) on ``device``; numpy as fp32."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(np.asarray(a, np.float32))
    return a.to(device)


def _start(latents, shape, seed, device) -> torch.Tensor:
    """The starting latents: ``latents`` as given (fp32), or a draw from a
    generator seeded with ``seed`` on ``device``."""
    if latents is not None:
        got = _tensor(latents, device).float()
        if tuple(got.shape) != tuple(shape):
            raise ValueError(f"latents {tuple(got.shape)}, expected "
                             f"{tuple(shape)}")
        return got
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


# ------------------------------------------------------------------ CogVideoX

class CogVideoXPipeline(_SPMixin):
    def __init__(self, dit: cog.CogVideoX, vae: cvae.CogVideoXVAE,
                 dtype=torch.float32, device=None):
        self.dit, self.vae, self.dtype = dit, vae, dtype
        self.device = _resolve_device(device)

    @property
    def dit_cfg(self) -> cog.CogVideoXConfig:
        return self.dit.cfg

    @classmethod
    def from_pretrained(cls, transformer_dir: str, vae_dir: str,
                        dtype=torch.bfloat16, quantize=None,
                        device=None) -> "CogVideoXPipeline":
        device = _resolve_device(device)
        dit = cog.load_cogvideox(transformer_dir, dtype=dtype,
                                 quantize=quantize, device=device)
        vae = cvae.load_cogvideox_vae(vae_dir, dtype=dtype, device=device)
        return cls(dit, vae, dtype=dtype, device=device)

    @torch.no_grad()
    def __call__(self, text_embeddings, negative_embeddings=None,
                 height: int = 480, width: int = 720, num_frames: int = 49,
                 num_inference_steps: int = 50, guidance_scale: float = 6.0,
                 seed: int = 0, scheduler: str = "ddim", fused: bool = False,
                 latents=None) -> np.ndarray:
        """Text embeddings [B, Lt, text_embed_dim] -> video [B, 3, F, H, W]
        in [0, 1] (numpy fp32). Guidance runs as one batch of 2 (uncond
        first) when ``guidance_scale`` > 1 and ``negative_embeddings`` are
        given. ``fused`` (JAX's one ``lax.scan`` over the DDIM plan, equal to
        its stepwise loop) is taken and the loop runs stepwise: the port
        has no fused samplers. ``latents`` [B, F', C, h, w]: the starting
        noise instead of the seed's draw."""
        cfg, dev = self.dit.cfg, self.device
        vr = self.vae.cfg.spatial_compression_ratio
        tc = self.vae.cfg.temporal_compression_ratio
        f_lat = (num_frames - 1) // tc + 1
        h_lat, w_lat = height // vr, width // vr
        txt = _tensor(text_embeddings, dev)
        B = txt.shape[0]
        do_cfg = guidance_scale > 1.0 and negative_embeddings is not None
        neg = (txt if negative_embeddings is None
               else _tensor(negative_embeddings, dev))
        ctx = torch.cat([neg, txt]) if do_cfg else txt

        sched = get_scheduler(scheduler)
        sched.set_timesteps(num_inference_steps)
        x = _start(latents, (B, f_lat, cfg.in_channels, h_lat, w_lat), seed,
                   dev)
        state = sched.init_state(x)
        for i, t in enumerate(sched.timesteps):
            xin = torch.cat([x, x]) if do_cfg else x
            tt = torch.full((xin.shape[0],), float(t), dtype=torch.float32,
                            device=dev)
            v = cog.cogvideox_forward(self.dit, xin, ctx, tt,
                                      attn_backend=self.attn_backend,
                                      sp=self.sp_ctx)
            if do_cfg:
                vu, vc = v.chunk(2)
                v = vu + guidance_scale * (vc - vu)
            x, state = sched.step(v, i, x, state)

        # [B, F, C, h, w] -> [B, C, F, h, w], divided by the scaling factor
        z = x.permute(0, 2, 1, 3, 4) / self.vae.cfg.scaling_factor
        video = self.vae.decode(z.to(self.dtype))
        return ((video + 1.0) / 2.0).float().cpu().numpy()


# ------------------------------------------------------------------ QwenImage

class QwenImagePipeline(_SPMixin):
    def __init__(self, dit: qwen_lib.QwenImage, vae=None,
                 dtype=torch.float32, device=None):
        """``vae``: a `WanVAE` read by `models.qwenimage_vae`, or None
        (the call returns latents)."""
        self.dit, self.vae, self.dtype = dit, vae, dtype
        self.device = _resolve_device(device)

    @property
    def dit_cfg(self) -> qwen_lib.QwenImageConfig:
        return self.dit.cfg

    @classmethod
    def from_pretrained(cls, transformer_dir: str,
                        vae_path: Optional[str] = None,
                        dtype=torch.bfloat16, quantize=None,
                        device=None) -> "QwenImagePipeline":
        from ..models.qwenimage_vae import load_qwenimage_vae
        device = _resolve_device(device)
        dit = qwen_lib.load_qwenimage(transformer_dir, dtype=dtype,
                                      quantize=quantize, device=device)
        vae = (load_qwenimage_vae(vae_path, dtype=dtype, device=device)
               if vae_path else None)
        return cls(dit, vae, dtype=dtype, device=device)

    def _forward(self, x, txt, t, img_ids, txt_ids):
        return qwen_lib.qwenimage_forward(self.dit, x, txt, t, img_ids,
                                          txt_ids,
                                          attn_backend=self.attn_backend,
                                          sp=self.sp_ctx)

    @torch.no_grad()
    def __call__(self, text_embeddings, negative_embeddings=None,
                 height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 30, true_cfg_scale: float = 4.0,
                 seed: int = 0, latents=None) -> np.ndarray:
        """Text embeddings [B, Lt, joint_attention_dim] -> images [B, 3, H,
        W] in [0, 1] (numpy fp32), or latents [B, z, h, w] without a VAE.
        True CFG (a conditional and an unconditional forward a step) when
        ``true_cfg_scale`` > 1 and ``negative_embeddings`` are given.
        ``latents`` [B, in_channels/4, h, w]: the starting noise before
        packing instead of the seed's draw."""
        cfg, dev = self.dit.cfg, self.device
        h_lat, w_lat = height // 8, width // 8
        L = (h_lat // 2) * (w_lat // 2)
        txt = _tensor(text_embeddings, dev)
        B, Lt = txt.shape[:2]
        do_cfg = true_cfg_scale > 1.0 and negative_embeddings is not None
        neg = _tensor(negative_embeddings, dev) if do_cfg else None

        sched = get_scheduler("euler")
        sched.set_timesteps(num_inference_steps, mu=calculate_mu_shift(L))
        z0 = _start(latents, (B, cfg.in_channels // 4, h_lat, w_lat), seed,
                    dev)
        x = _pack_latents(z0)
        img_ids, txt_ids = (a.to(dev) for a in qwen_lib.qwen_position_ids(
            (1, h_lat // 2, w_lat // 2), Lt))
        state = sched.init_state(x)
        for i, t in enumerate(sched.timesteps):
            tt = torch.full((B,), float(t) / 1000.0, dtype=torch.float32,
                            device=dev)
            v = self._forward(x, txt, tt, img_ids, txt_ids)
            if do_cfg:
                vu = self._forward(x, neg, tt, img_ids, txt_ids)
                v = vu + true_cfg_scale * (v - vu)
            x, state = sched.step(v, i, x, state)

        z = _unpack_latents(x, h_lat, w_lat)
        if self.vae is None:
            return z.float().cpu().numpy()
        img = self.vae.decode(z[:, :, None].to(self.dtype))
        return ((img[:, :, 0] + 1.0) / 2.0).float().cpu().numpy()


# ----------------------------------------------------------------------- Flux

class FluxPipeline(_SPMixin):
    def __init__(self, dit: flux_lib.Flux,
                 decode_fn: Optional[Callable] = None, dtype=torch.float32,
                 device=None):
        self.dit, self.decode_fn, self.dtype = dit, decode_fn, dtype
        self.device = _resolve_device(device)

    @property
    def dit_cfg(self) -> flux_lib.FluxConfig:
        return self.dit.cfg

    @classmethod
    def from_pretrained(cls, transformer_dir: str, decode_fn=None,
                        vae_path=None, dtype=torch.bfloat16, quantize=None,
                        device=None) -> "FluxPipeline":
        device = _resolve_device(device)
        dit = flux_lib.load_flux(transformer_dir, dtype=dtype,
                                 quantize=quantize, device=device)
        if decode_fn is None and vae_path is not None:
            from ..models import kl_vae
            vae = kl_vae.load_kl_vae(vae_path, dtype=dtype, device=device)
            decode_fn = kl_vae.make_decode_fn(vae, compute_dtype=dtype)
        return cls(dit, decode_fn=decode_fn, dtype=dtype, device=device)

    @torch.no_grad()
    def __call__(self, text_embeddings, pooled_projections,
                 height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 28, guidance: float = 3.5,
                 seed: int = 0, latents=None) -> np.ndarray:
        """Text embeddings [B, Lt, joint_attention_dim] and pooled ones [B,
        pooled_projection_dim] -> ``decode_fn``'s pixels, or the unpacked
        latents [B, in_channels/4, h, w] (numpy fp32). ``guidance`` feeds
        the guidance embedding of a guidance-distilled model (Flux-dev).
        ``latents``: the starting noise before packing."""
        cfg, dev = self.dit.cfg, self.device
        h_lat, w_lat = height // 8, width // 8
        L = (h_lat // 2) * (w_lat // 2)
        txt = _tensor(text_embeddings, dev)
        pooled = _tensor(pooled_projections, dev)
        B, Lt = txt.shape[:2]

        sched = get_scheduler("euler")
        sched.set_timesteps(num_inference_steps, mu=calculate_mu_shift(L))
        z0 = _start(latents, (B, cfg.in_channels // 4, h_lat, w_lat), seed,
                    dev)
        x = _pack_latents(z0)
        yy, xx = np.meshgrid(np.arange(h_lat // 2), np.arange(w_lat // 2),
                             indexing="ij")
        img_ids = torch.as_tensor(np.stack(
            [np.zeros_like(yy), yy, xx], axis=-1).reshape(L, 3),
            dtype=torch.float32, device=dev)
        txt_ids = torch.zeros(Lt, 3, device=dev)
        g = (torch.full((B,), guidance, dtype=torch.float32, device=dev)
             if cfg.guidance_embeds else None)
        state = sched.init_state(x)
        for i, t in enumerate(sched.timesteps):
            tt = torch.full((B,), float(t) / 1000.0, dtype=torch.float32,
                            device=dev)
            v = flux_lib.flux_forward(self.dit, x, txt, pooled, tt, img_ids,
                                      txt_ids, guidance=g,
                                      attn_backend=self.attn_backend,
                                      sp=self.sp_ctx)
            x, state = sched.step(v, i, x, state)

        z = _unpack_latents(x, h_lat, w_lat)
        if self.decode_fn is not None:
            out = self.decode_fn(z)
            return (out.float().cpu().numpy() if isinstance(out, torch.Tensor)
                    else np.asarray(out, np.float32))
        return z.float().cpu().numpy()
