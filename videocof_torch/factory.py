"""Pipeline factory: a `WanPipeline` from a Wan2.1 t2v checkpoint directory,
or from random weights drawn from a seed.

Counterpart of the Wan2.1 t2v branch of `videocof_tpu/factory.py`
(`load_pipeline`; the reference's config-driven build, `fast_infer.py:277-345`,
`config/wan2.1/wan_civitai.yaml`). A checkpoint directory holds the DiT's
``config.json`` and safetensors shards, ``Wan2.1_VAE.pth``, the umT5
encoder ``models_t5_umt5-xxl-enc-bf16.pth`` and the tokenizer under
``google/umt5-xxl``. LoRA files are merged into the DiT in order, on the
device. The other branches of the JAX factory raise `NotImplementedError`
naming their ROADMAP.md item.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import torch

from .configs import T5Config, WAN21_T2V_1_3B, WanDiTConfig, WanVAEConfig
from .data.tokenizer import WanTokenizer
from .models import weights
from .models.lora import merge_lora
from .models.t5_encoder import T5Encoder, init_t5_encoder
from .models.wan_dit import WanDiT, init_wan_dit
from .models.wan_vae import WanVAE, init_wan_vae
from .pipeline import WanPipeline
from .pipeline.wan_pipeline import _resolve_device

# default sub-paths inside a Wan2.1 checkpoint dir (wan_civitai.yaml)
VAE_SUBPATH = "Wan2.1_VAE.pth"
T5_SUBPATH = "models_t5_umt5-xxl-enc-bf16.pth"
TOKENIZER_SUBPATH = "google/umt5-xxl"
FUSIONX_LORA = "Wan2.1_Text_to_Video_14B_FusionX_LoRA.safetensors"
# layouts of the JAX factory's other branches, recognized only to refuse them
_WAN22_MOE_SUBPATHS = ("low_noise_model", "high_noise_model")
_VAE22_SUBPATH = "Wan2.2_VAE.pth"
_FAMILY_CLASSES = ("CogVideoXTransformer3DModel", "FluxTransformer2DModel",
                   "QwenImageTransformer2DModel")


def _refuse_unported_layout(model_name: str) -> None:
    """Raise for the checkpoint layouts of the JAX factory's other
    branches: Wan2.2 MoE, the Wan2.2 VAE, and the non-Wan families."""
    if all(os.path.isdir(os.path.join(model_name, s))
           for s in _WAN22_MOE_SUBPATHS):
        raise NotImplementedError(
            f"{model_name} is a Wan2.2 MoE checkpoint; Wan2.2 is not ported "
            f"(ROADMAP.md §A.7)")
    if (os.path.isfile(os.path.join(model_name, _VAE22_SUBPATH))
            and not os.path.isfile(os.path.join(model_name, VAE_SUBPATH))):
        raise NotImplementedError(
            f"{model_name} ships the Wan2.2 VAE, which is not ported "
            f"(ROADMAP.md §A.7)")
    for sub in ("", "transformer"):
        cfg_path = os.path.join(model_name, sub, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                cls = json.load(f).get("_class_name", "")
            if cls in _FAMILY_CLASSES:
                raise NotImplementedError(
                    f"{model_name} is a {cls} checkpoint; the other model "
                    f"families are not ported (ROADMAP.md §A.10)")


def _from_state_dict(module_cls, cfg, sd, dtype, device):
    """``module_cls(cfg)`` holding the tensors of ``sd`` (built on the meta
    device, so no weights are drawn only to be overwritten), on ``device``."""
    module = module_cls(cfg, dtype=dtype, device="meta")
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device)


def load_pipeline(
    model_name: str,
    dtype: torch.dtype = torch.bfloat16,
    random_init: bool = False,
    dit_cfg: Optional[WanDiTConfig] = None,
    vae_cfg: Optional[WanVAEConfig] = None,
    t5_cfg: Optional[T5Config] = None,
    seed: int = 0,
    attn_backend: Optional[str] = None,
    high_noise_model: Optional[str] = None,
    require_real_tokenizer: bool = True,
    quantize: Optional[str] = None,
    offload_t5: bool = False,
    lora_paths: Optional[Sequence[Tuple[str, float]]] = None,
    precompile: Optional[dict] = None,
    device=None,
) -> WanPipeline:
    """Build a Wan2.1 t2v edit pipeline from the checkpoint directory
    ``model_name``, or with ``random_init`` from weights drawn on the device
    from ``seed`` (the DiT first, at ``dit_cfg``, default Wan2.1 T2V 1.3B,
    then the VAE, then umT5, from one generator). ``lora_paths``: (path,
    multiplier) pairs merged into the DiT in order. ``device``: CUDA unless
    the caller asks for the CPU. ``high_noise_model`` (Wan2.2 MoE),
    ``quantize`` (fp8), ``offload_t5`` and ``precompile`` (the JAX
    package's ahead-of-time fused sampler) raise ``NotImplementedError``."""
    if high_noise_model:
        raise NotImplementedError("Wan2.2 MoE (high_noise_model) is not "
                                  "ported (ROADMAP.md §A.7)")
    if quantize:
        raise NotImplementedError(f"quantize={quantize!r}: fp8 weight storage "
                                  f"is not ported (ROADMAP.md §A.5)")
    if offload_t5:
        raise NotImplementedError("offload_t5 is not ported (ROADMAP.md, "
                                  "what the entry slice left)")
    if precompile is not None:
        raise NotImplementedError(
            "precompile: the port runs the sampler stepwise and has no "
            "ahead-of-time fused executable (ROADMAP.md §A, not ported on "
            "purpose)")
    device = _resolve_device(device)
    vae_cfg = vae_cfg or WanVAEConfig()
    t5_cfg = t5_cfg or T5Config()

    if random_init:
        dit_cfg = dit_cfg or WAN21_T2V_1_3B
        gen = torch.Generator(device=device).manual_seed(seed)
        dit = init_wan_dit(dit_cfg, gen, dtype, device)
        vae = init_wan_vae(vae_cfg, gen, dtype, device)
        t5 = init_t5_encoder(t5_cfg, gen, dtype, device)
        tokenizer = WanTokenizer(vocab_size=t5_cfg.vocab)
    else:
        _refuse_unported_layout(model_name)
        dit_cfg = dit_cfg or weights.dit_config_from_checkpoint(model_name)
        sd = weights.convert_dit_state_dict(
            weights.load_state_dict(model_name), dit_cfg, dtype)
        dit = _from_state_dict(WanDiT, dit_cfg, sd, dtype, device)
        sd = weights.convert_vae_state_dict(weights.load_state_dict(
            os.path.join(model_name, VAE_SUBPATH)), vae_cfg, dtype)
        vae = _from_state_dict(WanVAE, vae_cfg, sd, dtype, device)
        sd = weights.convert_t5_state_dict(weights.load_state_dict(
            os.path.join(model_name, T5_SUBPATH)), t5_cfg, dtype)
        t5 = _from_state_dict(T5Encoder, t5_cfg, sd, dtype, device)
        del sd
        # a real checkpoint demands a real tokenizer: the hash fallback
        # would silently corrupt production prompts
        tok_path = os.path.join(model_name, TOKENIZER_SUBPATH)
        tokenizer = WanTokenizer(
            tok_path if os.path.isdir(tok_path) else TOKENIZER_SUBPATH,
            vocab_size=t5_cfg.vocab, require_real=require_real_tokenizer)
    for path, mult in (lora_paths or ()):
        merge_lora(dit, path, multiplier=mult)
    return WanPipeline(dit, vae, t5, tokenizer, dtype=dtype,
                       attn_backend=attn_backend, device=device)
