"""LoRA adapters of the Wan DiT blocks, for training.

Counterpart of the adapter half of `videocof_tpu/models/lora.py`
(`init_lora_adapters`, `fuse_block_adapters`, `apply_lora_adapters`,
`lora_adapters_to_state_dict`). The tensors keep the torch orientation,
``down`` [r, din] and ``up`` [dout, r], so the kohya export round-trips
through the JAX package's `merge_lora` and the reference's `lora_utils`.

The adapters are fused into one block's weights inside that block's call
(`WanDiT.forward(lora=...)`): ``W_eff = W + scale * up @ down`` in fp32, cast
to W's dtype, so only one block's fused weights exist at a time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..configs import WanDiTConfig

# module -> adapted linears of a Wan block (`_ADAPTER_TARGETS`)
ADAPTER_TARGETS = {
    "self_attn": ("q", "k", "v", "o"),
    "cross_attn": ("q", "k", "v", "o"),
    "ffn": ("fc1", "fc2"),
}
# kohya module names of the FFN linears (the reference's ffn.0 / ffn.2)
_KOHYA_NAMES = {("ffn", "fc1"): "ffn.0", ("ffn", "fc2"): "ffn.2"}


def _target_dims(cfg: WanDiTConfig):
    d, f = cfg.dim, cfg.ffn_dim
    dims = {(m, n): (d, d) for m in ("self_attn", "cross_attn")
            for n in ADAPTER_TARGETS[m]}
    dims[("ffn", "fc1")] = (d, f)
    dims[("ffn", "fc2")] = (f, d)
    return dims


class LoRALinear(nn.Module):
    """One adapter: ``down`` [r, din], ``up`` [dout, r]."""

    def __init__(self, rank: int, din: int, dout: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.down = nn.Parameter(torch.zeros(rank, din, dtype=dtype,
                                             device=device))
        self.up = nn.Parameter(torch.zeros(dout, rank, dtype=dtype,
                                           device=device))


class LoRAAdapters(nn.Module):
    """Adapters of every block: ``blocks[i][module][name]`` is a
    `LoRALinear`, ``rank`` and ``alpha`` the LoRA scale's terms."""

    def __init__(self, cfg: WanDiTConfig, rank: int, alpha: float,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.rank, self.alpha = rank, float(alpha)
        dims = _target_dims(cfg)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({mod: nn.ModuleDict({
                n: LoRALinear(rank, *dims[(mod, n)], dtype, device)
                for n in names}) for mod, names in ADAPTER_TARGETS.items()})
            for _ in range(cfg.num_layers))

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@torch.no_grad()
def init_lora_adapters(cfg: WanDiTConfig, generator: torch.Generator,
                       rank: int = 16, dtype=torch.float32,
                       device=None) -> LoRAAdapters:
    """Standard LoRA start, identity at init: ``up`` zero, ``down``
    N(0, 1) / rank, alpha = rank; drawn from ``generator`` on its device."""
    ad = LoRAAdapters(cfg, rank, float(rank), dtype,
                      device or generator.device)
    for block in ad.blocks:
        for mod in block.values():
            for lin in mod.values():
                r = torch.randn(lin.down.shape, generator=generator,
                                device=generator.device)
                lin.down.copy_(r / rank)
    return ad


def fuse_block_adapters(block: nn.Module, ad: nn.ModuleDict,
                        scale: float) -> Dict[str, torch.Tensor]:
    """One block's ``W_eff = (W.float() + scale * up @ down).to(W.dtype)``
    for every adapted linear, as ``{parameter name: W_eff}`` for
    `torch.func.functional_call` (differentiable wrt the adapters)."""
    fused = {}
    for mod, names in ad.items():
        for name, lin in names.items():
            w = getattr(getattr(block, mod), name).weight       # [dout, din]
            delta = lin.up.float() @ lin.down.float()
            fused[f"{mod}.{name}.weight"] = (w.float() + scale * delta
                                             ).to(w.dtype)
    return fused


def apply_lora_adapters(dit: nn.Module, adapters: LoRAAdapters,
                        multiplier: float = 1.0) -> Dict[str, torch.Tensor]:
    """The DiT's state dict with every block's adapters fused in, at
    ``multiplier * alpha / rank`` (the training-time analogue of merging)."""
    scale = multiplier * adapters.scale
    sd = dict(dit.state_dict())
    for i, (block, ad) in enumerate(zip(dit.blocks, adapters.blocks)):
        for key, w in fuse_block_adapters(block, ad, scale).items():
            sd[f"blocks.{i}.{key}"] = w
    return sd


def _to_numpy(p: torch.Tensor) -> np.ndarray:
    return p.detach().float().cpu().numpy().copy()


def lora_adapters_to_state_dict(adapters: LoRAAdapters
                                ) -> Dict[str, np.ndarray]:
    """Adapters -> kohya-format numpy state dict (``lora_unet_*`` keys, down
    [r, din], up [dout, r], alpha), loadable by the JAX package's
    `merge_lora` and by the reference's `lora_utils`."""
    sd: Dict[str, np.ndarray] = {}
    for mod, names in ADAPTER_TARGETS.items():
        for name in names:
            dotted = _KOHYA_NAMES.get((mod, name), f"{mod}.{name}")
            for layer, block in enumerate(adapters.blocks):
                lin = block[mod][name]
                base = "lora_unet_" + f"blocks.{layer}.{dotted}".replace(
                    ".", "_")
                sd[base + ".lora_down.weight"] = _to_numpy(lin.down)
                sd[base + ".lora_up.weight"] = _to_numpy(lin.up)
                sd[base + ".alpha"] = np.array(adapters.alpha, np.float32)
    return sd
