"""The Wan family's FLOP: of a DiT forward and of its linears (a frozen
copy of `chip_smoke.py`'s ``dit_step_flops``), one forward's attention
calls, and the VAE's convolution FLOP counted from the reference's own
layer shapes."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from cofbench.families import wan_layouts as layouts


def dit_linear_flops(cfg: dict, L: int, Lt: int) -> float:
    """FLOP of one DiT forward's linears at L tokens and Lt text tokens:
    the blocks' projections and FFN, patch embedding, head, the text MLP
    and the time MLP (one row)."""
    d, f = cfg["dim"], cfg["ffn_dim"]
    pt, ph, pw = cfg["patch_size"]
    per_block = (2 * L * d * d * 4 + 2 * L * d * d * 2 + 2 * Lt * d * d * 2
                 + 2 * L * d * f * 2)
    io = 2 * L * d * pt * ph * pw * (cfg["in_dim"] + cfg["out_dim"])
    text = 2 * Lt * d * (cfg["text_dim"] + d)
    time = 2 * d * (cfg["freq_dim"] + d + 6 * d)
    return float(cfg["num_layers"] * per_block + io + text + time)


def dit_step_flops(cfg: dict, L: int, Lt: int) -> float:
    """FLOP of one DiT forward: the matmuls and attention of the blocks,
    patch embedding and head (`chip_smoke.dit_step_flops`)."""
    d, f = cfg["dim"], cfg["ffn_dim"]
    per_block = (2 * L * d * d * 4 + 2 * L * d * d * 2 + 2 * Lt * d * d * 2
                 + 2 * L * d * f * 2 + 4 * L * L * d + 4 * L * Lt * d)
    pt, ph, pw = cfg["patch_size"]
    io = 2 * L * d * pt * ph * pw * (cfg["in_dim"] + cfg["out_dim"])
    return float(cfg["num_layers"] * per_block + io)


def attention_calls(cfg: dict, L: int, Lt: int) -> List[Tuple]:
    """(B, Lq, Lk, N, D) of each attention call of one DiT forward."""
    N = cfg["num_heads"]
    D = cfg["dim"] // N
    return [(1, L, L, N, D), (1, L, Lt, N, D)] * cfg["num_layers"]


def vae_flops(config: dict, mix) -> Dict[str, float]:
    """FLOP of the VAE's work in one edit, counted by torch's FLOP counter
    over the reference VAE on the meta device at the mix's shapes: the
    source clip's encode, and the reasoning and edit segments' decodes."""
    from torch.utils.flop_counter import FlopCounterMode

    from cofbench.reference import vae
    vcfg = config["vae"]
    sd = {k: torch.empty(shape, device="meta")
          for k, shape, _, _ in layouts.vae(vcfg)}
    W = vae.Weights(sd, "meta")
    src, ground, _, h, w = mix.latent_grid()
    z = vcfg["z_dim"]

    def count(fn, x):
        with FlopCounterMode(display=False) as counter:
            fn(W, vcfg, x)
        return float(counter.get_total_flops())

    clip = torch.empty(1, 3, mix.source_frames, mix.height, mix.width,
                       device="meta")
    return {"encode": count(vae.encode, clip),
            "decode": (count(vae.decode, torch.empty(1, z, ground, h, w,
                                                     device="meta"))
                       + count(vae.decode, torch.empty(1, z, src, h, w,
                                                       device="meta")))}


def edit_flops(config: dict, mix) -> Dict[str, float]:
    """Model FLOP of one edit by layer: the DiT's forwards, the VAE's
    encode and decodes (the text encoder is left out)."""
    dcfg = config["dit"]
    out = {"dit": mix.steps * dit_step_flops(dcfg, mix.tokens(
        dcfg["patch_size"]), mix.text_len)}
    out.update(vae_flops(config, mix))
    return out
