"""Pipeline factory: a `WanPipeline` (or a Wan2.2 MoE `Wan22Pipeline`) from a
checkpoint directory, or from random weights drawn from a seed.

Counterpart of the Wan branches of `videocof_tpu/factory.py`
(`load_pipeline`; the reference's config-driven build, `fast_infer.py:277-345`,
`config/wan2.1/wan_civitai.yaml`, `config/wan2.2/wan_civitai_t2v.yaml` and
`wan_civitai_5b.yaml`). A checkpoint directory holds the DiT's
``config.json`` and safetensors shards (a Wan2.2 A14B directory one such
directory per expert, ``low_noise_model/`` and ``high_noise_model/``), the
VAE (``Wan2.1_VAE.pth``, or the TI2V-5B's ``Wan2.2_VAE.pth``), the umT5
encoder ``models_t5_umt5-xxl-enc-bf16.pth`` and the tokenizer under
``google/umt5-xxl``; an i2v directory (``model_type`` "i2v") also the CLIP
tower ``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``. A DiT
whose keys hold the VACE branch (``vace_patch_embedding``,
``vace_blocks.*``) gives a `VacePipeline`, one with a camera adapter
(``control_adapter.*``) a `CameraPipeline`. LoRA files are merged into
every DiT in order, on the device, and then ``quantize="fp8"`` stores
each DiT's matmul weights in fp8 (`utils/fp8.py`), one expert after the
other. ``offload_t5`` keeps
the umT5 weights in host memory (pinned when CUDA is present) and ships
them to the device for each prompt encoding only. ``precompile`` raises
`NotImplementedError` naming its ROADMAP.md item.

`detect_family` names a checkpoint's family; a CogVideoX, Flux or
QwenImage directory (diffusers layout: a bare transformer directory, or a
pipeline directory with ``transformer/`` and ``vae/``) is read by
`load_family_pipeline` (JAX's `factory.py:70-103`), which `load_pipeline`
hands it to.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence, Tuple, Union

import torch

from .configs import (T5Config, WAN21_T2V_1_3B, Wan22VAEConfig, WanDiTConfig,
                      WanVAEConfig)
from .data.tokenizer import WanTokenizer
from .models import weights
from .models.clip_vision import (CLIP_FILE, CLIP_VIT_H_14, ClipVision,
                                 convert_clip_state_dict, init_clip_vision)
from .models.lora import merge_lora
from .models.t5_encoder import T5Encoder, init_t5_encoder
from .models.wan_dit import WanDiT, init_wan_dit
from .models.wan_vae import WanVAE, init_wan_vae
from .models.wan_dit_vace import (WanVace, convert_vace_state_dict,
                                  vace_stride)
from .models.wan_vae22 import Wan22VAE, init_wan22_vae
from .pipeline import (CameraPipeline, VacePipeline, Wan22Pipeline,
                       WanPipeline)
from .pipeline.camera_pipeline import (camera_adapter_from_state_dict,
                                       convert_camera_adapter_state_dict)
from .pipeline.wan_pipeline import _resolve_device
from .utils.fp8 import quantize_dit_fp8

# default sub-paths inside a Wan checkpoint dir (wan_civitai.yaml)
VAE_SUBPATH = "Wan2.1_VAE.pth"
T5_SUBPATH = "models_t5_umt5-xxl-enc-bf16.pth"
TOKENIZER_SUBPATH = "google/umt5-xxl"
FUSIONX_LORA = "Wan2.1_Text_to_Video_14B_FusionX_LoRA.safetensors"
# Wan2.2 A14B MoE layout: two expert sub-dirs beside the shared VAE, umT5
# and tokenizer (wan_civitai_t2v.yaml)
LOW_NOISE_SUBPATH = "low_noise_model"
HIGH_NOISE_SUBPATH = "high_noise_model"
WAN22_BOUNDARY = 0.875
# the Wan2.2 VAE of the TI2V-5B layout (wan_civitai_5b.yaml)
VAE22_SUBPATH = "Wan2.2_VAE.pth"
# diffusers ``_class_name`` -> the family key of the non-Wan families
FAMILY_CLASSES = {
    "CogVideoXTransformer3DModel": "cogvideox",
    "FluxTransformer2DModel": "flux",
    "QwenImageTransformer2DModel": "qwenimage",
}


def is_wan22_moe_dir(model_name: str) -> bool:
    """True when ``model_name`` is a Wan2.2 A14B dual-expert checkpoint dir
    (both ``low_noise_model/`` and ``high_noise_model/``)."""
    return bool(model_name) and all(
        os.path.isdir(os.path.join(model_name, s))
        for s in (LOW_NOISE_SUBPATH, HIGH_NOISE_SUBPATH))


def is_vae22_dir(model_name: str) -> bool:
    """True when the checkpoint dir ships the Wan2.2 VAE (the TI2V-5B
    layout: ``Wan2.2_VAE.pth`` and no ``Wan2.1_VAE.pth``)."""
    return (bool(model_name)
            and os.path.isfile(os.path.join(model_name, VAE22_SUBPATH))
            and not os.path.isfile(os.path.join(model_name, VAE_SUBPATH)))


def detect_family(model_name: str) -> str:
    """'wan' | 'cogvideox' | 'flux' | 'qwenimage' for a checkpoint dir: the
    diffusers ``_class_name`` of a ``config.json`` at the dir's root or
    under ``transformer/``; Wan dirs (and anything else) are 'wan'."""
    if not model_name or not os.path.isdir(model_name):
        return "wan"
    for sub in ("", "transformer"):
        cfg_path = os.path.join(model_name, sub, "config.json")
        if os.path.isfile(cfg_path):
            try:
                with open(cfg_path) as f:
                    cls = json.load(f).get("_class_name", "")
            except (OSError, ValueError):
                continue
            if cls in FAMILY_CLASSES:
                return FAMILY_CLASSES[cls]
    return "wan"


def load_family_pipeline(model_name: str, dtype: torch.dtype = torch.bfloat16,
                         family: Optional[str] = None,
                         quantize: Optional[str] = None, device=None):
    """A `CogVideoXPipeline`, `FluxPipeline` or `QwenImagePipeline` from a
    diffusers-layout directory: a bare transformer directory, or a pipeline
    directory with ``transformer/`` and ``vae/`` (CogVideoX needs its VAE;
    without one Flux and QwenImage return latents). ``quantize="fp8"``
    stores the DiT's matmul weights in fp8 with the family's exclusions.
    The pipelines take precomputed text embeddings (the text encoders are
    out of scope, as in JAX). ``device``: CUDA unless the caller asks for
    the CPU."""
    from .pipeline import (CogVideoXPipeline, FluxPipeline,
                           QwenImagePipeline)
    family = family or detect_family(model_name)
    tdir = model_name
    if os.path.isfile(os.path.join(model_name, "transformer",
                                   "config.json")):
        tdir = os.path.join(model_name, "transformer")
    vdir = os.path.join(model_name, "vae")
    has_vae = os.path.isfile(os.path.join(vdir, "config.json"))
    kw = dict(dtype=dtype, quantize=quantize, device=device)
    if family == "cogvideox":
        if not has_vae:
            raise ValueError(
                f"CogVideoX checkpoint {model_name!r} needs a vae/ subdir "
                "(AutoencoderKLCogVideoX) to decode videos")
        return CogVideoXPipeline.from_pretrained(tdir, vdir, **kw)
    if family == "qwenimage":
        return QwenImagePipeline.from_pretrained(
            tdir, vae_path=vdir if os.path.isdir(vdir) else None, **kw)
    if family == "flux":
        return FluxPipeline.from_pretrained(
            tdir, vae_path=vdir if has_vae else None, **kw)
    raise ValueError(f"unknown model family {family!r} for {model_name!r}")


def _finish_dit(dit: WanDiT, lora_paths, quantize: Optional[str]
                ) -> WanDiT:
    """Merge the LoRA files into ``dit`` in order, then quantize it."""
    for path, mult in (lora_paths or ()):
        merge_lora(dit, path, multiplier=mult)
    if quantize == "fp8":
        quantize_dit_fp8(dit)
    return dit


def _read_dit(model_dir: str, cfg: WanDiTConfig, dtype, device
              ) -> Tuple[WanDiT, dict]:
    """The DiT of ``model_dir`` and the branches its keys hold: {"vace":
    `WanVace`} (JAX's `factory.py:234-245`) and {"camera":
    `CameraAdapter`} (`:247-253`)."""
    raw = weights.load_state_dict(model_dir)
    branches = {}
    if any(k.startswith("vace_patch_embedding") for k in raw):
        stride = vace_stride(raw, cfg)
        sd, vsd = convert_vace_state_dict(raw, cfg, stride, dtype)
        in_dim = vsd["vace_patch_embed.weight"].shape[1] // math.prod(
            cfg.patch_size)
        vace = WanVace(cfg, stride, in_dim, dtype, "meta")
        vace.load_state_dict(vsd, strict=True, assign=True)
        branches["vace"] = vace.to(device)
    else:
        sd = weights.convert_dit_state_dict(raw, cfg, dtype)
    if any(k.startswith("control_adapter.") for k in raw):
        branches["camera"] = camera_adapter_from_state_dict(
            convert_camera_adapter_state_dict(raw, dtype), dtype, device)
    del raw
    return (weights.module_from_state_dict(WanDiT, cfg, sd, dtype, device),
            branches)


def _read_clip(model_name: str, dtype, device) -> ClipVision:
    """The CLIP tower an i2v directory must hold (``visual.*`` keys of the
    published file, read with ``torch.load(weights_only=True)``)."""
    path = os.path.join(model_name, CLIP_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{model_name} holds an i2v DiT but not its CLIP tower {CLIP_FILE}"
            f": image-to-video needs the start image's CLIP features")
    sd = convert_clip_state_dict(weights.load_state_dict(path),
                                 CLIP_VIT_H_14, dtype)
    return weights.module_from_state_dict(ClipVision, CLIP_VIT_H_14, sd,
                                          dtype, device)


def load_pipeline(
    model_name: str,
    dtype: torch.dtype = torch.bfloat16,
    random_init: bool = False,
    dit_cfg: Optional[WanDiTConfig] = None,
    vae_cfg: Optional[Union[WanVAEConfig, Wan22VAEConfig]] = None,
    t5_cfg: Optional[T5Config] = None,
    seed: int = 0,
    attn_backend: Optional[str] = None,
    high_noise_model: Optional[str] = None,
    boundary: float = WAN22_BOUNDARY,
    require_real_tokenizer: bool = True,
    quantize: Optional[str] = None,
    offload_t5: bool = False,
    lora_paths: Optional[Sequence[Tuple[str, float]]] = None,
    precompile: Optional[dict] = None,
    device=None,
) -> WanPipeline:
    """Build an edit pipeline from the checkpoint directory ``model_name``,
    or with ``random_init`` from weights drawn on the device from ``seed``
    (the DiT first, at ``dit_cfg``, default Wan2.1 T2V 1.3B, then the VAE,
    then umT5, from one generator).

    A Wan2.2 A14B directory (``low_noise_model/`` and ``high_noise_model/``)
    or ``high_noise_model`` (a second DiT directory) gives a
    `Wan22Pipeline` whose high-noise expert runs the steps at or above
    ``boundary``. A directory with ``Wan2.2_VAE.pth`` and no
    ``Wan2.1_VAE.pth`` (the TI2V-5B) gets the Wan2.2 VAE; ``vae_cfg``
    overrides the choice. ``lora_paths``: (path, multiplier) pairs merged
    into every DiT in order. ``quantize="fp8"`` then stores the DiTs'
    matmul weights in fp8 (`utils/fp8.py`). ``offload_t5``: umT5 stays
    in host memory and streams to the device per prompt encoding
    (`WanPipeline`). ``device``: CUDA unless the caller asks for the CPU.
    An i2v DiT (``dit_cfg`` or the directory's ``model_type``) comes with
    the CLIP tower as ``pipe.clip``: read from the directory (which must
    hold it), or drawn after umT5 with ``random_init``. A VACE or camera
    directory gives a `VacePipeline` or a `CameraPipeline`.
    ``random_init`` draws one DiT, so it raises ``ValueError`` with
    ``high_noise_model`` rather than ignore it; ``precompile`` (the JAX
    package's ahead-of-time fused sampler) raises
    ``NotImplementedError``."""
    if precompile is not None:
        raise NotImplementedError(
            "precompile: the port runs the sampler stepwise and has no "
            "ahead-of-time fused executable (ROADMAP.md §A, not ported on "
            "purpose)")
    if quantize not in (None, "fp8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if random_init and high_noise_model:
        raise ValueError("random_init draws one DiT; high_noise_model names "
                         "a checkpoint directory, which it would ignore")
    device = _resolve_device(device)
    if not random_init and detect_family(model_name) != "wan":
        # a CogVideoX, Flux or QwenImage directory, as JAX's factory routes it
        return load_family_pipeline(model_name, dtype=dtype, device=device)
    if vae_cfg is None:
        vae_cfg = (Wan22VAEConfig() if not random_init
                   and is_vae22_dir(model_name) else WanVAEConfig())
    vae22 = isinstance(vae_cfg, Wan22VAEConfig)
    t5_cfg = t5_cfg or T5Config()

    dit_2, clip, branches = None, None, {}
    if random_init:
        dit_cfg = dit_cfg or WAN21_T2V_1_3B
        gen = torch.Generator(device=device).manual_seed(seed)
        dit = init_wan_dit(dit_cfg, gen, dtype, device)
        vae = (init_wan22_vae if vae22 else init_wan_vae)(vae_cfg, gen, dtype,
                                                          device)
        t5 = init_t5_encoder(t5_cfg, gen, dtype, device)
        if dit_cfg.model_type == "i2v":
            clip = init_clip_vision(CLIP_VIT_H_14, gen, dtype, device)
        tokenizer = WanTokenizer(vocab_size=t5_cfg.vocab)
        _finish_dit(dit, lora_paths, quantize)
    else:
        dit_dir = model_name
        if high_noise_model is None and is_wan22_moe_dir(model_name):
            dit_dir = os.path.join(model_name, LOW_NOISE_SUBPATH)
            high_noise_model = os.path.join(model_name, HIGH_NOISE_SUBPATH)
        dit_cfg = dit_cfg or weights.dit_config_from_checkpoint(dit_dir)
        # one expert at a time: merged and quantized before the next is read
        dit, branches = _read_dit(dit_dir, dit_cfg, dtype, device)
        _finish_dit(dit, lora_paths, quantize)
        if high_noise_model:
            dit_2 = _finish_dit(_read_dit(high_noise_model, dit_cfg, dtype,
                                          device)[0], lora_paths, quantize)
        if dit_cfg.model_type == "i2v":
            clip = _read_clip(model_name, dtype, device)
        vae_path = os.path.join(model_name,
                                VAE22_SUBPATH if vae22 else VAE_SUBPATH)
        vae = weights.module_from_state_dict(
            Wan22VAE if vae22 else WanVAE, vae_cfg,
            weights.load_vae_state_dict(vae_path, vae_cfg, dtype), dtype,
            device)
        sd = weights.convert_t5_state_dict(weights.load_state_dict(
            os.path.join(model_name, T5_SUBPATH)), t5_cfg, dtype)
        t5 = weights.module_from_state_dict(T5Encoder, t5_cfg, sd, dtype,
                                            "cpu" if offload_t5 else device)
        del sd
        # a real checkpoint demands a real tokenizer: the hash fallback
        # would silently corrupt production prompts
        tok_path = os.path.join(model_name, TOKENIZER_SUBPATH)
        tokenizer = WanTokenizer(
            tok_path if os.path.isdir(tok_path) else TOKENIZER_SUBPATH,
            vocab_size=t5_cfg.vocab, require_real=require_real_tokenizer)
    if dit_2 is not None:
        return Wan22Pipeline(dit, vae, t5, tokenizer, dtype=dtype,
                             attn_backend=attn_backend, device=device,
                             offload_t5=offload_t5, dit_2=dit_2,
                             boundary=boundary)
    kw = dict(dtype=dtype, attn_backend=attn_backend, device=device,
              offload_t5=offload_t5, clip=clip)
    if "vace" in branches:
        return VacePipeline(dit, vae, t5, tokenizer, vace=branches["vace"],
                            **kw)
    if "camera" in branches:
        return CameraPipeline(dit, vae, t5, tokenizer,
                              camera=branches["camera"], **kw)
    return WanPipeline(dit, vae, t5, tokenizer, **kw)
