"""Tiny CPU training parts shared by the port's training tests: the tiny
DiT, VAE and umT5 drawn from a seed, the trainer config that fits them, and
synthetic triplets."""

import numpy as np
import torch

from videocof_torch.configs import T5_TINY, VAE_TINY, WAN_TINY
from videocof_torch.models.t5_encoder import init_t5_encoder
from videocof_torch.models.wan_dit import init_wan_dit
from videocof_torch.models.wan_vae import init_wan_vae

DIT_CFG = WAN_TINY.replace(in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                           text_dim=T5_TINY.dim)
TCFG = dict(height=16, width=16, source_frames=5, target_frames=5,
            reasoning_frames=4, batch_size=1, log_every=1, save_every=0,
            learning_rate=1e-3)


def tiny_models(seed=0):
    """(dit, vae, t5) on the CPU, fp32, from one generator."""
    gen = torch.Generator().manual_seed(seed)
    return (init_wan_dit(DIT_CFG, gen), init_wan_vae(VAE_TINY, gen),
            init_t5_encoder(T5_TINY, gen))


def triplet(seed, hw=16, frames=(5, 4, 5), text="remove the cube"):
    rng = np.random.default_rng(seed)
    return {key: rng.uniform(-1, 1, (3, t, hw, hw)).astype(np.float32)
            for key, t in zip(("pixel_src", "pixel_ground", "pixel_tgt"),
                              frames)} | {"text": text}


def triplets(seed=0):
    """An endless stream of distinct triplets."""
    i = seed
    while True:
        yield triplet(i)
        i += 1
