"""Typed configuration layer of the PyTorch/CUDA port.

The same frozen dataclasses and published geometries as
`videocof_tpu/configs.py`, minus the fields whose behaviour the port does not
carry yet (i2v, fp8, remat, FFN chunking).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class WanDiTConfig:
    """Wan2.1 3D diffusion-transformer geometry (t2v)."""

    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    cross_attn_norm: bool = True
    eps: float = 1e-6
    rope_max_pos: int = 1024
    rope_theta: float = 10000.0
    # Pad the token stream to a multiple of this right after patch embed;
    # padded keys are masked out of self-attention inside the kernel.
    token_pad_multiple: int = 1
    # RoPE rotation arithmetic dtype (the angle tables are float64-derived).
    rope_dtype: str = "float32"
    # Residual-stream storage dtype between blocks.
    stream_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        assert self.dim % self.num_heads == 0
        return self.dim // self.num_heads

    def replace(self, **kw) -> "WanDiTConfig":
        return dataclasses.replace(self, **kw)


WAN21_T2V_1_3B = WanDiTConfig(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30)
WAN21_T2V_14B = WanDiTConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)
# Tiny config for tests.
WAN_TINY = WanDiTConfig(dim=96, ffn_dim=256, num_heads=4, num_layers=2,
                        text_dim=64, text_len=16, freq_dim=32)


@dataclass(frozen=True)
class WanVAEConfig:
    """Causal 3D VAE: 8x8 spatial / 4x temporal compression, 16 latent
    channels, dim 96 backbone."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    latent_mean: Tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    )
    latent_std: Tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
    )

    def replace(self, **kw) -> "WanVAEConfig":
        return dataclasses.replace(self, **kw)


VAE_TINY = WanVAEConfig(dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                        latent_mean=(0.0,) * 4, latent_std=(1.0,) * 4)


@dataclass(frozen=True)
class T5Config:
    """umT5-XXL encoder."""

    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    rel_max_dist: int = 128

    @property
    def head_dim(self) -> int:
        return self.dim_attn // self.num_heads

    def replace(self, **kw) -> "T5Config":
        return dataclasses.replace(self, **kw)


T5_TINY = T5Config(vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                   num_layers=2, num_buckets=8)


@dataclass(frozen=True)
class GenerationConfig:
    """Knobs of a chain-of-frames edit; the defaults are the 4-step edit
    (the main path). The standard edit sets 50 steps, guidance 5 and
    TeaCache."""

    height: int = 480
    width: int = 832
    source_frames: int = 33
    reasoning_frames: int = 4
    num_inference_steps: int = 4
    guidance_scale: float = 1.0
    shift: float = 3.0
    sampler: str = "unipc"  # unipc | euler | dpm++
    repeat_rope: bool = True
    cot: bool = True
    seed: int = 0
    negative_prompt: str = (
        "Bright tones, overexposed, static, blurred details, subtitles, style,"
        " works, paintings, images, static, overall gray, worst quality, low"
        " quality, JPEG compression residue, ugly, incomplete, extra fingers,"
        " poorly drawn hands, poorly drawn faces, deformed, disfigured,"
        " misshapen limbs, fused fingers, still picture, messy background,"
        " three legs, many people in the background, walking backwards"
    )
    # TeaCache (reference `inference.py:106-109`)
    enable_teacache: bool = False
    teacache_threshold: float = 0.10
    teacache_skip_start_steps: int = 5
    cfg_skip_ratio: float = 0.0
