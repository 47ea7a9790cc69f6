"""Carry weights from the JAX package's parameter trees into the port.

Each function takes a JAX parameter tree as nested dicts/lists of numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns a ``state_dict``
for the port's module. The JAX trees stack the per-layer block parameters on
a leading axis (``params["blocks"]``); here they are unstacked into
``blocks.<i>.*``. Linear kernels are [din, dout] in JAX and are transposed to
``nn.Linear``'s [dout, din]; VAE conv kernels are already [O, I, ...], and
so are the CLIP tower's patch conv and the camera adapter's convs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple, Type, TypeVar

import numpy as np
import torch

from .models.lora import LoRAAdapters

C = TypeVar("C")


def config_from(cls: Type[C], other: Any) -> C:
    """The port's config ``cls`` with every field read from ``other`` (a JAX
    package config of the same name); fields the port does not carry are
    left behind."""
    return cls(**{f.name: getattr(other, f.name)
                  for f in dataclasses.fields(cls)})


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _linear_tree(params: Dict[str, Any], stacked: Tuple[str, ...] = (
        "blocks",), convs: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Flatten a tree of linear layers, unstacking the leaves under the
    ``stacked`` keys (a leading layer axis) and turning each [din, dout]
    ``kernel`` into a [dout, din] ``weight``; the kernels of ``convs``
    (already [O, I, ...]) are renamed only."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(params):
        if key.endswith(".kernel"):
            if not key.startswith(convs):
                arr = np.swapaxes(arr, -1, -2)
            key = key[:-len("kernel")] + "weight"
        top, _, rest = key.partition(".")
        if top in stacked:
            for i in range(arr.shape[0]):
                out[f"{top}.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            out[key] = torch.tensor(arr)
    return out


def jax_param_path(name: str) -> str:
    """The JAX tree path of the port's linear weight ``name``, the inverse
    of `_linear_tree`'s map: ``blocks.3.self_attn.q.weight`` ->
    ``blocks/self_attn/q/kernel`` (block weights are one stacked leaf
    there, and so are Flux's ``single_blocks``)."""
    parts = name.split(".")
    if parts[0] in ("blocks", "single_blocks"):
        del parts[1]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def dit_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's DiT params -> `WanDiT` state dict (an i2v tree's
    ``img_emb`` and blocks' ``k_img``/``v_img``/``norm_k_img``
    included)."""
    return _linear_tree(params)


def clip_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP tower params -> `ClipVision` state dict (its
    blocks are a list, not stacked)."""
    return _linear_tree(params, stacked=(), convs=("patch_embed.",))


def vace_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's VACE branch params (`init_vace_params`) ->
    `WanVace` state dict."""
    return _linear_tree(params, stacked=("vace_blocks", "after_proj"))


def camera_adapter_from_jax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's camera adapter params -> `CameraAdapter` state
    dict."""
    return _linear_tree(params, stacked=(), convs=("conv.", "res."))


def s2v_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's S2V params (`init_s2v_params`) -> `WanS2V` state
    dict."""
    return _linear_tree(params, stacked=())


def cogvideox_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's CogVideoX params -> `CogVideoX` state dict."""
    return _linear_tree(params)


def flux_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Flux params (double-stream ``blocks`` and
    single-stream ``single_blocks``, both stacked) -> `Flux` state dict."""
    return _linear_tree(params, stacked=("blocks", "single_blocks"))


def qwenimage_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's QwenImage params -> `QwenImage` state dict."""
    return _linear_tree(params)


def cogvideox_vae_from_jax(params: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's CogVideoX VAE params (conv kernels already
    [O, I, ...], its lists of stages and blocks) -> `CogVideoXVAE` state
    dict."""
    return _linear_tree(params, stacked=(), convs=("encoder.", "decoder."))


def kl_vae_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's 2D KL-VAE decoder params -> `KLVAEDecoder` state
    dict: convs renamed only, the mid-block attention's [in, out]
    projections transposed to ``nn.Linear``'s."""
    return _linear_tree(params, stacked=(), convs=(
        "conv_in.", "conv_out.", "mid_resnet", "up_blocks.",
        "post_quant_conv."))


def t5_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """`videocof_tpu.models.t5_encoder` params -> `T5Encoder` state dict."""
    return _linear_tree(params)


def lora_from_jax(adapters: Dict[str, Any], cfg) -> LoRAAdapters:
    """`videocof_tpu.models.lora.init_lora_adapters`-style adapters
    ({"rank", "alpha", "blocks": {module: {name: {down [L, r, din],
    up [L, dout, r]}}}}) -> the port's `LoRAAdapters` for the DiT config
    ``cfg``. Both sides keep the torch orientation: no transpose."""
    blocks = adapters["blocks"]
    rank = int(np.asarray(adapters["rank"]))
    module = LoRAAdapters(cfg, rank, float(np.asarray(adapters["alpha"])))
    sd = {}
    for mod, names in blocks.items():
        for name, ad in names.items():
            for part in ("down", "up"):
                arr = np.asarray(ad[part], np.float32)
                for i in range(arr.shape[0]):
                    sd[f"blocks.{i}.{mod}.{name}.{part}"] = torch.tensor(arr[i])
    module.load_state_dict(sd)
    return module


def vae_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """`videocof_tpu.models.wan_vae` params -> `WanVAE` state dict."""
    out = {}
    for key, arr in _flatten(params):
        if key.endswith(".kernel"):
            key = key[:-len("kernel")] + "weight"
        out[key] = torch.tensor(arr)
    return out


def xlm_roberta_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """`videocof_tpu.models.xlm_roberta` params -> `XLMRoberta` state dict
    (its blocks are a list, not stacked)."""
    return _linear_tree(params, stacked=())


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def experts_from_jax(stacked: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `stack_experts` tree of Wan DiTs (every leaf [E, ...]) -> the
    port's `parallel.stack_experts` ({name: [E, ...]})."""
    from .parallel.ep import stack_experts
    n = np.asarray(next(v for _, v in _flatten(stacked))).shape[0]
    return stack_experts(*(dit_from_jax(_index(stacked, e))
                           for e in range(n)))
