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
them. An i2v DiT's image branch (``img_emb.proj.*``, each block's
``cross_attn.k_img``/``v_img``/``norm_k_img``) maps onto the port's i2v
modules; the VACE branch (`wan_dit_vace.convert_vace_state_dict`) and the
camera adapter (`camera_pipeline.convert_camera_adapter_state_dict`) are
read by their own converters, which the factory calls where a checkpoint
holds them.
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
    """The port's `WanDiTConfig` of a checkpoint directory: the t2v DiT
    (Wan2.1 t2v and VACE, either Wan2.2 A14B expert, the TI2V-5B, whose
    ``model_type`` is ``ti2v``) or the i2v one, with q/k RMSNorm. Another
    ``model_type`` raises ``ValueError``; ``qk_norm: false`` raises
    ``NotImplementedError``: no published Wan checkpoint has it."""
    raw = read_checkpoint_config(model_dir)
    model_type = raw.get("model_type", "t2v")
    if model_type not in ("t2v", "ti2v", "i2v"):
        raise ValueError(f"{model_dir}: model_type {model_type!r}; the Wan "
                         f"DiT is t2v, ti2v or i2v")
    if not raw.get("qk_norm", True):
        raise NotImplementedError(
            f"{model_dir}: qk_norm false; the port's DiT always normalizes "
            f"q and k")
    keep = {k: raw[k] for k in (
        "text_len", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim",
        "out_dim", "num_heads", "num_layers", "cross_attn_norm", "eps")
        if k in raw}
    if "patch_size" in raw:
        keep["patch_size"] = tuple(raw["patch_size"])
    if model_type == "i2v":
        keep["model_type"] = "i2v"
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
# i2v's CLIP-feature MLP (Sequential(LN, Linear, GELU, Linear, LN)) and each
# block's image keys and values
DIT_IMG_EMB_NAMES = {"img_emb.proj.0": ("img_emb.ln1", "scale"),
                     "img_emb.proj.1": ("img_emb.fc1", "weight"),
                     "img_emb.proj.3": ("img_emb.fc2", "weight"),
                     "img_emb.proj.4": ("img_emb.ln2", "scale")}
DIT_IMG_BLOCK_NAMES = ("cross_attn.k_img", "cross_attn.v_img")


def convert_block_state_dict(sd: StateDict, src: str, dst: str,
                             cfg: WanDiTConfig, dtype: torch.dtype
                             ) -> StateDict:
    """One `WanAttentionBlock`'s published keys under ``src`` (``blocks.3.``
    or ``vace_blocks.0.``) -> `WanBlock` keys under ``dst``."""
    out: StateDict = {}
    for a, b in DIT_BLOCK_NAMES.items():
        out[dst + b + ".weight"] = sd[src + a + ".weight"].to(dtype)
        out[dst + b + ".bias"] = sd[src + a + ".bias"].to(dtype)
    for a in ("self_attn", "cross_attn"):
        for n in ("norm_q", "norm_k"):
            out[f"{dst}{a}.{n}.weight"] = sd[f"{src}{a}.{n}.weight"].to(dtype)
    out[dst + "modulation"] = sd[src + "modulation"].reshape(6, -1).to(
        torch.float32)
    if cfg.cross_attn_norm:
        out[dst + "norm3.scale"] = sd[src + "norm3.weight"].to(dtype)
        out[dst + "norm3.bias"] = sd[src + "norm3.bias"].to(dtype)
    if cfg.model_type == "i2v":
        for n in DIT_IMG_BLOCK_NAMES:
            out[dst + n + ".weight"] = sd[src + n + ".weight"].to(dtype)
            out[dst + n + ".bias"] = sd[src + n + ".bias"].to(dtype)
        out[dst + "cross_attn.norm_k_img.weight"] = sd[
            src + "cross_attn.norm_k_img.weight"].to(dtype)
    return out


def convert_dit_state_dict(sd: StateDict, cfg: WanDiTConfig,
                           dtype: torch.dtype = torch.float32) -> StateDict:
    """Wan DiT published keys -> `WanDiT` state dict in ``dtype`` (the time
    layers and the modulations fp32); an i2v ``cfg`` takes the image
    branch too. The keys of the VACE branch and the camera adapter are
    left to their own converters."""
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
    if cfg.model_type == "i2v":
        for src, (dst, w) in DIT_IMG_EMB_NAMES.items():
            out[f"{dst}.{w}"] = sd[src + ".weight"].to(dtype)
            out[dst + ".bias"] = sd[src + ".bias"].to(dtype)
    for i in range(cfg.num_layers):
        out.update(convert_block_state_dict(sd, f"blocks.{i}.",
                                            f"blocks.{i}.", cfg, dtype))
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


def module_from_state_dict(module_cls, cfg, sd: StateDict, dtype, device,
                           quantize=None, exclude=None):
    """``module_cls(cfg)`` holding the tensors of ``sd`` (built on the meta
    device: no weights drawn only to be overwritten) on ``device``. With
    ``quantize="fp8"`` each matmul weight is shipped and stored in fp8 one
    at a time (`utils.fp8.quantize_dit_fp8`, JAX's exclusions or
    ``exclude``) before the rest moves, so the bf16 model never exists on
    the card."""
    if quantize not in (None, "fp8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    module = module_cls(cfg, dtype=dtype, device="meta")
    module.load_state_dict(sd, strict=True, assign=True)
    if quantize == "fp8":
        from ..utils.fp8 import DEFAULT_EXCLUDE, quantize_dit_fp8
        quantize_dit_fp8(module, exclude=exclude or DEFAULT_EXCLUDE,
                         device=device)
    return module.to(device)
