"""videocof_torch: the PyTorch/CUDA port of videocof_tpu.

The chain-of-frames video editing pipeline (umT5 text encoder, Wan2.1 causal
VAE, Wan2.1 DiT under Flow-UniPC) and its LoRA / full fine-tuning trainer on an
NVIDIA Hopper GPU. Plain tensor code is PyTorch; the flash-attention kernels
(forward, forward with LSE, backward) are hand-written CUDA under `csrc/`. The
package imports neither JAX nor `videocof_tpu`.
"""

from .configs import (GenerationConfig, T5Config, T5_TINY, VAE_TINY,
                      WAN21_T2V_14B, WAN21_T2V_1_3B, WAN_TINY, WanDiTConfig,
                      WanVAEConfig)

__all__ = [
    "GenerationConfig", "T5Config", "T5_TINY", "VAE_TINY", "WAN21_T2V_14B",
    "WAN21_T2V_1_3B", "WAN_TINY", "WanDiTConfig", "WanVAEConfig",
]
