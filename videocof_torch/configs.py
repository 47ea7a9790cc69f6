"""Typed configuration layer of the PyTorch/CUDA port.

The same frozen dataclasses and published geometries as
`videocof_tpu/configs.py` (and the Wan2.2 VAE's config of
`videocof_tpu/models/wan_vae22.py`), minus the fields whose behaviour the
port does not carry yet (i2v, remat, FFN chunking).
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
# Wan2.2 transformers are the t2v DiT with plain cross-attention; the A14B
# MoE runs two of these experts, the TI2V-5B one DiT over the Wan2.2 VAE's
# 48 latent channels.
WAN22_T2V_A14B = WanDiTConfig(dim=5120, ffn_dim=13824, num_heads=40,
                              num_layers=40)
WAN22_TI2V_5B = WanDiTConfig(dim=3072, ffn_dim=14336, num_heads=24,
                             num_layers=30, in_dim=48, out_dim=48)
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

# the Wan2.2 VAE's 48-channel latent normalization
WAN22_LATENT_MEAN = (
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
)
WAN22_LATENT_STD = (
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
)


@dataclass(frozen=True)
class Wan22VAEConfig:
    """The Wan2.2 VAE of the TI2V-5B: a 2x2 pixel patchify in front of the
    encoder, 16x spatial / 4x temporal compression, 48 latent channels,
    encoder dim 160, decoder dim 256."""

    dim: int = 160
    dec_dim: int = 256
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    patch_size: int = 2
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 16
    latent_mean: Tuple[float, ...] = WAN22_LATENT_MEAN
    latent_std: Tuple[float, ...] = WAN22_LATENT_STD

    def replace(self, **kw) -> "Wan22VAEConfig":
        return dataclasses.replace(self, **kw)


WAN22_VAE_TINY = Wan22VAEConfig(dim=8, dec_dim=8, z_dim=4,
                                dim_mult=(1, 2, 2, 2), num_res_blocks=1,
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
