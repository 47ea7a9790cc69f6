"""A seeded kohya LoRA file over every block linear of a Wan DiT, and the
port's runtime adapters of it (the VACE and S2V runtime-LoRA tests)."""

import numpy as np
import torch


def kohya_lora(cfg, seed, rank=4):
    """A kohya LoRA state dict (numpy float32, alpha 2) over every linear
    of every block of ``cfg`` (a JAX or a port `WanDiTConfig`)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.dim, cfg.ffn_dim
    dims = {**{f"{a}.{n}": (d, d) for a in ("self_attn", "cross_attn")
               for n in "qkvo"}, "ffn.0": (d, f), "ffn.2": (f, d)}
    sd = {}
    for i in range(cfg.num_layers):
        for name, (din, dout) in dims.items():
            base = "lora_unet_" + f"blocks.{i}.{name}".replace(".", "_")
            sd[base + ".lora_down.weight"] = (
                0.3 * rng.standard_normal((rank, din))).astype(np.float32)
            sd[base + ".lora_up.weight"] = (
                0.3 * rng.standard_normal((dout, rank))).astype(np.float32)
            sd[base + ".alpha"] = np.array(2.0, np.float32)
    return sd


def runtime_lora(sd, cfg, multiplier):
    """The port's runtime adapters (adapters, scale) of the file ``sd``."""
    from videocof_torch.models.lora import load_runtime_lora
    runtime, left = load_runtime_lora(
        [({k: torch.from_numpy(v) for k, v in sd.items()}, multiplier)], cfg)
    assert not left
    return runtime
