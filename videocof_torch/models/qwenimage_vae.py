"""QwenImage's VAE: the Wan2.1 causal video VAE under diffusers' names.

Counterpart of `videocof_tpu/models/qwenimage_vae.py`. The reference's
`AutoencoderKLQwenImage` has the Wan2.1 VAE's geometry and latent
statistics under diffusers' module names (``down_blocks``,
``mid_block.resnets``, ``up_blocks[i].resnets`` / ``upsamplers``,
``conv_in`` / ``conv_out``), so the compute is `wan_vae.WanVAE`'s (a
one-frame decode for an image) and this module is the key converter.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs import WanVAEConfig
from .wan_vae import WanVAE

QWENIMAGE_VAE_CONFIG = WanVAEConfig()     # the Wan2.1 geometry and statistics


def convert_qwenimage_vae_state_dict(sd: Dict[str, torch.Tensor],
                                     cfg: WanVAEConfig = QWENIMAGE_VAE_CONFIG,
                                     dtype=torch.float32
                                     ) -> Dict[str, torch.Tensor]:
    """diffusers-layout keys -> `WanVAE`'s state dict in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}

    def conv(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].to(dtype)
        out[f"{dst}.bias"] = sd[f"{src}.bias"].to(dtype)

    def gamma(dst, src):
        out[f"{dst}.gamma"] = sd[f"{src}.gamma"].to(dtype)

    def res(dst, src):
        gamma(f"{dst}.norm1", f"{src}.norm1")
        conv(f"{dst}.conv1", f"{src}.conv1")
        gamma(f"{dst}.norm2", f"{src}.norm2")
        conv(f"{dst}.conv2", f"{src}.conv2")
        if f"{src}.conv_shortcut.weight" in sd:
            conv(f"{dst}.shortcut", f"{src}.conv_shortcut")

    def attn(dst, src):
        gamma(f"{dst}.norm", f"{src}.norm")
        conv(f"{dst}.qkv", f"{src}.to_qkv")
        conv(f"{dst}.proj", f"{src}.proj")

    def resample(dst, pre):
        conv(f"{dst}.conv", f"{pre}.resample.1")
        if f"{pre}.time_conv.weight" in sd:
            conv(f"{dst}.time_conv", f"{pre}.time_conv")

    n = len(cfg.dim_mult)
    conv("encoder.conv1", "encoder.conv_in")
    seq = 0
    for i in range(n):
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{i}.res.{j}", f"encoder.down_blocks.{seq}")
            seq += 1
        if i != n - 1:
            resample(f"encoder.down.{i}.resample",
                     f"encoder.down_blocks.{seq}")
            seq += 1
    for part in ("encoder", "decoder"):
        res(f"{part}.mid_rb1", f"{part}.mid_block.resnets.0")
        attn(f"{part}.mid_attn", f"{part}.mid_block.attentions.0")
        res(f"{part}.mid_rb2", f"{part}.mid_block.resnets.1")
        gamma(f"{part}.head_norm", f"{part}.norm_out")
        conv(f"{part}.head_conv", f"{part}.conv_out")
    conv("decoder.conv1", "decoder.conv_in")
    for i in range(n):
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.res.{j}",
                f"decoder.up_blocks.{i}.resnets.{j}")
        pre = f"decoder.up_blocks.{i}.upsamplers.0"
        if f"{pre}.resample.1.weight" in sd:
            resample(f"decoder.up.{i}.resample", pre)
    conv("quant_conv", "quant_conv")
    conv("post_quant_conv", "post_quant_conv")
    return out


def load_qwenimage_vae(vae_path: str, cfg: Optional[WanVAEConfig] = None,
                       dtype=torch.float32, device=None) -> WanVAE:
    """A diffusers-layout ``vae/`` directory (or file) -> `WanVAE` on
    ``device``, at ``QWENIMAGE_VAE_CONFIG`` unless ``cfg`` is given."""
    from . import weights
    cfg = cfg or QWENIMAGE_VAE_CONFIG
    sd = convert_qwenimage_vae_state_dict(weights.load_state_dict(vae_path),
                                          cfg, dtype)
    return weights.module_from_state_dict(WanVAE, cfg, sd, dtype, device)
