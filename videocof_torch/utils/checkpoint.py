"""Writing weights back to the published Wan layouts.

Counterpart of the safetensors half of `videocof_tpu/utils/checkpoint.py`
(`export_dit_state_dict`, `save_dit_safetensors`): the inverse of
`models.weights.convert_dit_state_dict`, so that weights made or trained by
the port load in the reference and back; and the inverses of the VAE and
umT5 converters, with which `save_wan_checkpoint_dir` writes a whole
checkpoint directory (Wan2.1, the Wan2.2 A14B MoE or the TI2V-5B). The writer is the port's own (no
``safetensors`` package): tensors keep their dtype (bf16 included; JAX's
writer widens everything to fp32), ordered by element size, then name, so
that each starts aligned, behind a header padded to 8 bytes. Train-state
checkpoints are not ported (ROADMAP.md §A.9).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import torch

from ..configs import T5Config, Wan22VAEConfig, WanDiTConfig
from ..models.weights import (DIT_BLOCK_NAMES, DIT_INDEX, DIT_TOP_NAMES,
                              SAFETENSORS_DTYPES, AnyKey, t5_key_map,
                              vae_key_map)

StateDict = Dict[str, torch.Tensor]
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write ``tensors`` (on any device) as one ``.safetensors`` file;
    returns the bytes written."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def export_dit_state_dict(sd: Mapping[str, torch.Tensor], cfg: WanDiTConfig
                          ) -> StateDict:
    """`WanDiT` state dict -> the published Wan key layout (the inverse of
    `convert_dit_state_dict`): the patch embedding back to its conv weight
    [O, I, kt, kh, kw], the modulations to [1, n, d] fp32."""
    pt, ph, pw = cfg.patch_size
    out: StateDict = {
        "patch_embedding.weight": sd["patch_embed.weight"].reshape(
            cfg.dim, cfg.in_dim, pt, ph, pw),
        "patch_embedding.bias": sd["patch_embed.bias"],
        "head.modulation": sd["head.modulation"].float()[None],
    }
    for dst, src in DIT_TOP_NAMES.items():
        out[dst + ".weight"] = sd[src + ".weight"]
        out[dst + ".bias"] = sd[src + ".bias"]
    for i in range(cfg.num_layers):
        b = f"blocks.{i}."
        for dst, src in DIT_BLOCK_NAMES.items():
            out[b + dst + ".weight"] = sd[b + src + ".weight"]
            out[b + dst + ".bias"] = sd[b + src + ".bias"]
        for a in ("self_attn", "cross_attn"):
            for n in ("norm_q", "norm_k"):
                out[f"{b}{a}.{n}.weight"] = sd[f"{b}{a}.{n}.weight"]
        out[b + "modulation"] = sd[b + "modulation"].float()[None]
        if cfg.cross_attn_norm:
            out[b + "norm3.weight"] = sd[b + "norm3.scale"]
            out[b + "norm3.bias"] = sd[b + "norm3.bias"]
    return out


def save_dit_safetensors(path: str, dit: torch.nn.Module,
                         cfg: WanDiTConfig) -> int:
    """One ``.safetensors`` file of ``dit``'s weights in the published
    layout; returns the bytes written."""
    return write_safetensors(path, export_dit_state_dict(dit.state_dict(),
                                                         cfg))


def dit_checkpoint_config(cfg: WanDiTConfig) -> Dict[str, object]:
    """The ``config.json`` of a published Wan2.1 t2v DiT for ``cfg``."""
    return {"_class_name": "WanModel", "model_type": "t2v",
            "patch_size": list(cfg.patch_size), "text_len": cfg.text_len,
            "in_dim": cfg.in_dim, "dim": cfg.dim, "ffn_dim": cfg.ffn_dim,
            "freq_dim": cfg.freq_dim, "text_dim": cfg.text_dim,
            "out_dim": cfg.out_dim, "num_heads": cfg.num_heads,
            "num_layers": cfg.num_layers, "qk_norm": True,
            "cross_attn_norm": cfg.cross_attn_norm, "eps": cfg.eps}


def save_dit_checkpoint_dir(model_dir: str, dit: torch.nn.Module,
                            cfg: WanDiTConfig, num_shards: int = 2) -> int:
    """A checkpoint directory in the published layout: ``config.json``,
    ``num_shards`` safetensors shards of about equal size and their
    ``diffusion_pytorch_model.safetensors.index.json``; returns the bytes of
    the shards."""
    os.makedirs(model_dir, exist_ok=True)
    sd = export_dit_state_dict(dit.state_dict(), cfg)
    total = sum(t.numel() * t.element_size() for t in sd.values())
    shards = [dict() for _ in range(num_shards)]
    filled = 0
    for name, t in sd.items():
        shards[min(num_shards - 1, filled * num_shards // max(total, 1))][
            name] = t
        filled += t.numel() * t.element_size()
    weight_map, written = {}, 0
    for i, shard in enumerate(shards):
        fname = (f"diffusion_pytorch_model-{i + 1:05d}-of-"
                 f"{num_shards:05d}.safetensors")
        written += write_safetensors(os.path.join(model_dir, fname), shard)
        weight_map.update(dict.fromkeys(shard, fname))
    with open(os.path.join(model_dir, DIT_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(dit_checkpoint_config(cfg), f, indent=1)
    return written


def export_vae_state_dict(sd: Mapping[str, torch.Tensor], cfg) -> StateDict:
    """A `WanVAE` or `Wan22VAE` state dict -> the published
    ``Wan2.1_VAE.pth`` or ``Wan2.2_VAE.pth`` keys (by ``cfg``'s type)."""
    from ..models.wan_vae22 import wan22_vae_key_map
    names = (wan22_vae_key_map(cfg, AnyKey()) if isinstance(
        cfg, Wan22VAEConfig) else vae_key_map(cfg, AnyKey()))
    return {src: sd[dst] for src, dst in names.items() if dst in sd}


def export_t5_state_dict(sd: Mapping[str, torch.Tensor], cfg: T5Config
                         ) -> StateDict:
    """A `T5Encoder` state dict -> the published umT5 keys."""
    return {src: sd[dst] for src, dst in t5_key_map(cfg).items()}


def save_wan_checkpoint_dir(model_dir: str, dit: torch.nn.Module,
                            vae: torch.nn.Module, t5: torch.nn.Module,
                            dit_2: Optional[torch.nn.Module] = None,
                            num_shards: int = 2) -> int:
    """A whole checkpoint directory in the published layout, as
    `factory.load_pipeline` reads it: the DiT's directory at the root, or
    with a high-noise expert ``dit_2`` the Wan2.2 A14B layout
    (``low_noise_model/`` holding ``dit``, ``high_noise_model/`` holding
    ``dit_2``); the VAE as ``Wan2.2_VAE.pth`` for a Wan2.2 VAE (the TI2V-5B
    layout) or ``Wan2.1_VAE.pth``; umT5 as
    ``models_t5_umt5-xxl-enc-bf16.pth``. The DiTs go through the port's
    safetensors writer, the VAE and umT5 through ``torch.save`` (the
    published files are ``.pth``). Returns the bytes written."""
    from .. import factory
    os.makedirs(model_dir, exist_ok=True)
    written = 0
    if dit_2 is None:
        written += save_dit_checkpoint_dir(model_dir, dit, dit.cfg,
                                           num_shards)
    else:
        for sub, d in ((factory.LOW_NOISE_SUBPATH, dit),
                       (factory.HIGH_NOISE_SUBPATH, dit_2)):
            written += save_dit_checkpoint_dir(
                os.path.join(model_dir, sub), d, d.cfg, num_shards)
    vae_name = (factory.VAE22_SUBPATH if isinstance(vae.cfg, Wan22VAEConfig)
                else factory.VAE_SUBPATH)
    for path, sd in ((vae_name, export_vae_state_dict(vae.state_dict(),
                                                      vae.cfg)),
                     (factory.T5_SUBPATH, export_t5_state_dict(
                         t5.state_dict(), t5.cfg))):
        sd = {k: v.detach().cpu() for k, v in sd.items()}
        torch.save(sd, os.path.join(model_dir, path))
        written += sum(v.numel() * v.element_size() for v in sd.values())
    return written
