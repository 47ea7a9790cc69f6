"""Checkpoint files: published Wan2.1 and Wan2.2 state dicts -> the port's
modules.

Counterpart of `videocof_tpu/models/weights.py`. The published layouts are
those the reference loads: the DiT as sharded safetensors with a
``config.json`` (`wan_transformer3d.py:1157-1299`; each Wan2.2 A14B expert
is one such directory), the single-file VAE ``Wan2.1_VAE.pth``
(`wan_vae.py:684-706`) or ``Wan2.2_VAE.pth`` (the TI2V-5B's, read through
`wan_vae22.convert_wan22_vae_state_dict`) and the single-file umT5 encoder
(`wan_text_encoder.py:306-395`).

Safetensors files are read here without the ``safetensors`` package: an
8-byte little-endian header length, a JSON header of ``{name: {dtype,
shape, data_offsets}}``, then the raw bytes, mapped copy-on-write and viewed
with ``torch.frombuffer``. Every tensor keeps its stored dtype (a bf16 14B
checkpoint stays 28.6 GB on the host; JAX's loader widens bf16 to fp32
numpy). The converters map the published keys straight onto the port's
``state_dict`` names: linear weights stay [out, in], the patch-embedding
conv weight [O, I, 1, 2, 2] becomes the linear [O, I * 4], the modulations
[1, 6, d] become [6, d] fp32, and the time layers are fp32, as JAX keeps
them.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict

import torch

from ..configs import T5Config, WanDiTConfig, WanVAEConfig

StateDict = Dict[str, torch.Tensor]

# the safetensors dtype names, both ways
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
DIT_INDEX = "diffusion_pytorch_model.safetensors.index.json"
# the published branches the port does not carry (ROADMAP.md §A.10)
_UNPORTED_DIT_KEYS = ("img_emb.", "vace_", "control_adapter.")


# ---------------------------------------------------------------- file reading

def read_safetensors(path: str) -> StateDict:
    """A ``.safetensors`` file -> {name: tensor} in the stored dtypes, viewing
    a copy-on-write map of the file (writes to a tensor never reach it)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
              if size > 8 + n else None)
    header.pop("__metadata__", None)
    out: StateDict = {}
    for name, info in header.items():
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which the reader does not take "
                             f"({sorted(SAFETENSORS_DTYPES)})")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = 1
        for s in shape:
            count *= s
        esize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * esize or 8 + n + end > size:
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do not "
                             f"hold {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = 8 + n + begin
        if offset % esize:
            # a writer that did not align its tensors: copy this one out
            out[name] = torch.frombuffer(
                bytearray(mm[offset:offset + end - begin]), dtype=dtype
            ).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                         offset=offset).reshape(shape)
    return out


def load_state_dict(path: str) -> StateDict:
    """Read a ``.safetensors`` or ``.pth`` file, or a directory of safetensors
    shards (listed by ``diffusion_pytorch_model.safetensors.index.json`` when
    it is there, else every ``*.safetensors`` in it), into torch tensors in
    their stored dtypes. ``.pth`` files go through ``torch.load(
    weights_only=True)``, reading ``"state_dict"`` when it is there."""
    if os.path.isdir(path):
        idx = os.path.join(path, DIT_INDEX)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted({os.path.join(path, v) for v in weight_map.values()})
        else:
            files = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no safetensors shards in {path}")
        sd: StateDict = {}
        for f in files:
            sd.update(read_safetensors(f))
        return sd
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


# the reference's dict_mapping of config.json keys
# (`wan_transformer3d.py:1166-1178`)
_CONFIG_KEY_ALIASES = {"in_dim": "in_channels", "dim": "hidden_size"}


def read_checkpoint_config(model_dir: str) -> Dict[str, Any]:
    """``config.json`` with the reference's dict_mapping translation."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    for src, dst in _CONFIG_KEY_ALIASES.items():
        if src in cfg:
            cfg[dst] = cfg[src]
    return cfg


def dit_config_from_checkpoint(model_dir: str) -> WanDiTConfig:
    """The port's `WanDiTConfig` of a checkpoint directory. Only the t2v
    DiT with q/k RMSNorm is ported (Wan2.1 t2v, either Wan2.2 A14B expert,
    the TI2V-5B, whose ``model_type`` is ``ti2v``): another ``model_type``
    or ``qk_norm: false`` raises (ROADMAP.md §A.10)."""
    raw = read_checkpoint_config(model_dir)
    if raw.get("model_type", "t2v") not in ("t2v", "ti2v"):
        raise NotImplementedError(
            f"{model_dir}: model_type {raw['model_type']!r}; only the t2v "
            f"DiT is ported (ROADMAP.md §A.10)")
    if not raw.get("qk_norm", True):
        raise NotImplementedError(
            f"{model_dir}: qk_norm false; the port's DiT always normalizes "
            f"q and k (ROADMAP.md §A.10)")
    keep = {k: raw[k] for k in (
        "text_len", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim",
        "out_dim", "num_heads", "num_layers", "cross_attn_norm", "eps")
        if k in raw}
    if "patch_size" in raw:
        keep["patch_size"] = tuple(raw["patch_size"])
    return WanDiTConfig(**keep)


# -------------------------------------------------------------- DiT conversion

# published name -> the port's module name; block names under "blocks.<i>."
DIT_TOP_NAMES = {
    "text_embedding.0": "text_mlp.fc1",
    "text_embedding.2": "text_mlp.fc2",
    "time_embedding.0": "time_mlp.fc1",
    "time_embedding.2": "time_mlp.fc2",
    "time_projection.1": "time_proj.fc",
    "head.head": "head.fc",
}
DIT_BLOCK_NAMES = {
    **{f"{a}.{n}": f"{a}.{n}" for a in ("self_attn", "cross_attn")
       for n in ("q", "k", "v", "o")},
    "ffn.0": "ffn.fc1",
    "ffn.2": "ffn.fc2",
}
_FP32_TOP = ("time_embedding.", "time_projection.")


def convert_dit_state_dict(sd: StateDict, cfg: WanDiTConfig,
                           dtype: torch.dtype = torch.float32) -> StateDict:
    """Wan DiT published keys -> `WanDiT` state dict in ``dtype`` (the time
    layers and the modulations fp32). The i2v image branch, VACE and the
    camera adapter raise (ROADMAP.md §A.10)."""
    extra = sorted(k for k in sd if k.startswith(_UNPORTED_DIT_KEYS)
                   or ".k_img." in k or ".v_img." in k or "norm_k_img" in k)
    if extra:
        raise NotImplementedError(
            f"the checkpoint holds a branch the port does not carry (i2v "
            f"image embedding, VACE or camera control; ROADMAP.md §A.10): "
            f"{extra[:4]}")
    f32 = torch.float32
    pe = sd["patch_embedding.weight"]                 # [O, I, kt, kh, kw]
    out: StateDict = {
        "patch_embed.weight": pe.reshape(pe.shape[0], -1).to(dtype),
        "patch_embed.bias": sd["patch_embedding.bias"].to(dtype),
        "head.modulation": sd["head.modulation"].reshape(2, -1).to(f32),
    }
    for src, dst in DIT_TOP_NAMES.items():
        dt = f32 if src.startswith(_FP32_TOP) else dtype
        out[dst + ".weight"] = sd[src + ".weight"].to(dt)
        out[dst + ".bias"] = sd[src + ".bias"].to(dt)
    for i in range(cfg.num_layers):
        b = f"blocks.{i}."
        for src, dst in DIT_BLOCK_NAMES.items():
            out[b + dst + ".weight"] = sd[b + src + ".weight"].to(dtype)
            out[b + dst + ".bias"] = sd[b + src + ".bias"].to(dtype)
        for a in ("self_attn", "cross_attn"):
            for n in ("norm_q", "norm_k"):
                out[f"{b}{a}.{n}.weight"] = sd[f"{b}{a}.{n}.weight"].to(dtype)
        out[b + "modulation"] = sd[b + "modulation"].reshape(6, -1).to(f32)
        if cfg.cross_attn_norm:
            out[b + "norm3.scale"] = sd[b + "norm3.weight"].to(dtype)
            out[b + "norm3.bias"] = sd[b + "norm3.bias"].to(dtype)
    return out


# -------------------------------------------------------------- VAE conversion

class AnyKey:
    """A key set that holds every key: a name map built over it has every
    optional key (shortcuts, time convs), for writing a published file."""

    def __contains__(self, key) -> bool:
        return True


def _vae_res_names(src: str, dst: str, keys) -> Dict[str, str]:
    # ResidualBlock.residual = Sequential(RMS, SiLU, Conv, RMS, SiLU,
    # Dropout, Conv) (`wan_vae.py:198-204`)
    names = {f"{src}.residual.0.gamma": f"{dst}.norm1.gamma",
             f"{src}.residual.3.gamma": f"{dst}.norm2.gamma"}
    convs = {"residual.2": "conv1", "residual.6": "conv2"}
    if f"{src}.shortcut.weight" in keys:
        convs["shortcut"] = "shortcut"
    for a, b in convs.items():
        for p in ("weight", "bias"):
            names[f"{src}.{a}.{p}"] = f"{dst}.{b}.{p}"
    return names


def _vae_attn_names(src: str, dst: str) -> Dict[str, str]:
    names = {f"{src}.norm.gamma": f"{dst}.norm.gamma"}
    for a, b in (("to_qkv", "qkv"), ("proj", "proj")):
        for p in ("weight", "bias"):
            names[f"{src}.{a}.{p}"] = f"{dst}.{b}.{p}"
    return names


def _vae_conv(src: str, dst: str) -> Dict[str, str]:
    return {f"{src}.{p}": f"{dst}.{p}" for p in ("weight", "bias")}


def _vae_stages(keys, cfg: WanVAEConfig, part: str) -> Dict[str, str]:
    """The flat ``downsamples`` / ``upsamples`` Sequential of the encoder /
    decoder -> the port's ``down.<stage>`` / ``up.<stage>`` modules."""
    seq_name, stage_name = (("downsamples", "down") if part == "encoder"
                            else ("upsamples", "up"))
    per_stage = cfg.num_res_blocks + (0 if part == "encoder" else 1)
    names: Dict[str, str] = {}
    seq = 0
    n_stages = len(cfg.dim_mult)
    for i in range(n_stages):
        for j in range(per_stage):
            names.update(_vae_res_names(f"{part}.{seq_name}.{seq}",
                                        f"{part}.{stage_name}.{i}.res.{j}",
                                        keys))
            seq += 1
        if i != n_stages - 1:
            pre = f"{part}.{seq_name}.{seq}"
            dst = f"{part}.{stage_name}.{i}.resample"
            names.update(_vae_conv(pre + ".resample.1", dst + ".conv"))
            if pre + ".time_conv.weight" in keys:
                names.update(_vae_conv(pre + ".time_conv", dst + ".time_conv"))
            seq += 1
    return names


def vae_key_map(cfg: WanVAEConfig, keys) -> Dict[str, str]:
    """{published ``Wan2.1_VAE.pth`` key: the port's key}; ``keys`` (the
    file's, or `AnyKey`) says which optional keys exist."""
    names: Dict[str, str] = {}
    for part in ("encoder", "decoder"):
        names.update(_vae_conv(f"{part}.conv1", f"{part}.conv1"))
        names.update(_vae_res_names(f"{part}.middle.0", f"{part}.mid_rb1",
                                    keys))
        names.update(_vae_attn_names(f"{part}.middle.1", f"{part}.mid_attn"))
        names.update(_vae_res_names(f"{part}.middle.2", f"{part}.mid_rb2",
                                    keys))
        names[f"{part}.head.0.gamma"] = f"{part}.head_norm.gamma"
        names.update(_vae_conv(f"{part}.head.2", f"{part}.head_conv"))
        names.update(_vae_stages(keys, cfg, part))
    names.update(_vae_conv("conv1", "quant_conv"))
    names.update(_vae_conv("conv2", "post_quant_conv"))
    return names


def convert_vae_state_dict(sd: StateDict, cfg: WanVAEConfig,
                           dtype: torch.dtype = torch.float32) -> StateDict:
    """``Wan2.1_VAE.pth`` keys -> `WanVAE` state dict in ``dtype``. The raw
    file has no 'model.' prefix (the reference adds it when loading into its
    wrapper, `wan_vae.py:699-702`); both are taken."""
    if not any(k.startswith("encoder.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    return {dst: sd[src].to(dtype)
            for src, dst in vae_key_map(cfg, sd).items()}


def load_vae_state_dict(path: str, cfg, dtype: torch.dtype = torch.float32
                        ) -> StateDict:
    """A published VAE file -> the port's state dict: ``Wan2.2_VAE.pth``
    through `wan_vae22.convert_wan22_vae_state_dict` for a
    `Wan22VAEConfig`, ``Wan2.1_VAE.pth`` through `convert_vae_state_dict`
    for a `WanVAEConfig`."""
    from .wan_vae22 import Wan22VAEConfig, convert_wan22_vae_state_dict
    sd = load_state_dict(path)
    if isinstance(cfg, Wan22VAEConfig):
        return convert_wan22_vae_state_dict(sd, cfg, dtype)
    return convert_vae_state_dict(sd, cfg, dtype)


# --------------------------------------------------------------- T5 conversion

def t5_key_map(cfg: T5Config) -> Dict[str, str]:
    """{published umT5 key: the port's key} (`wan_text_encoder.py`'s module
    tree)."""
    names = {"token_embedding.weight": "token_embedding",
             "norm.weight": "norm.weight"}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}."
        for src, dst in (("norm1.weight", "norm1.weight"),
                         ("norm2.weight", "norm2.weight"),
                         ("ffn.gate.0.weight", "ffn.gate.weight"),
                         ("ffn.fc1.weight", "ffn.fc1.weight"),
                         ("ffn.fc2.weight", "ffn.fc2.weight"),
                         ("pos_embedding.embedding.weight", "pos_emb"),
                         *((f"attn.{n}.weight", f"attn.{n}.weight")
                           for n in ("q", "k", "v", "o"))):
            names[b + src] = b + dst
    return names


def convert_t5_state_dict(sd: StateDict, cfg: T5Config,
                          dtype: torch.dtype = torch.float32) -> StateDict:
    """Wan umT5 checkpoint keys (`wan_text_encoder.py`'s module tree) ->
    `T5Encoder` state dict in ``dtype`` (the relative position embeddings
    fp32, as JAX keeps them)."""
    return {dst: sd[src].to(torch.float32 if dst.endswith("pos_emb")
                            else dtype)
            for src, dst in t5_key_map(cfg).items()}
