"""Carry weights from the JAX package's parameter trees into the port.

Each function takes a JAX parameter tree as nested dicts/lists of numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns a ``state_dict``
for the port's module. The JAX trees stack the per-layer block parameters on
a leading axis (``params["blocks"]``); here they are unstacked into
``blocks.<i>.*``. Linear kernels are [din, dout] in JAX and are transposed to
``nn.Linear``'s [dout, din]; VAE conv kernels are already [O, I, ...].
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


def _linear_tree(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a tree of linear layers, unstacking ``blocks`` and turning
    each [din, dout] ``kernel`` into a [dout, din] ``weight``."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(params):
        if key.endswith(".kernel"):
            key, arr = key[:-len("kernel")] + "weight", np.swapaxes(arr, -1, -2)
        if key.startswith("blocks."):
            rest = key[len("blocks."):]
            for i in range(arr.shape[0]):
                out[f"blocks.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            out[key] = torch.tensor(arr)
    return out


def jax_param_path(name: str) -> str:
    """The JAX tree path of the port's linear weight ``name``, the inverse
    of `_linear_tree`'s map: ``blocks.3.self_attn.q.weight`` ->
    ``blocks/self_attn/q/kernel`` (block weights are one stacked leaf
    there)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        del parts[1]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def dit_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """`videocof_tpu.models.wan_dit` params -> `WanDiT` state dict."""
    return _linear_tree(params)


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
