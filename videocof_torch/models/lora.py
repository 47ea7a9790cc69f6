"""LoRA of the Wan DiT: published LoRA files merged into the weights, and
the adapters of the blocks for training.

Counterpart of `videocof_tpu/models/lora.py`: `parse_lora_state_dict`,
`merge_lora` and `unmerge_lora` (the reference's load-time fusion,
`lora_utils.py:371-620`: ``W += multiplier * (alpha / rank) * up @ down``,
in place on the module), `load_runtime_lora` (LoRA files as runtime
adapters, the only LoRA path over fp8 weights), and the adapter half
(`init_lora_adapters`, `fuse_block_adapters`, `apply_lora_adapters`,
`lora_adapters_to_state_dict`). The tensors keep the
torch orientation, ``down`` [r, din] and ``up`` [dout, r], so the kohya
export round-trips through `merge_lora` here, in the JAX package and in the
reference's `lora_utils`.

The adapters are fused into one block's weights inside that block's call
(`WanDiT.forward(lora=...)`): ``W_eff = W + scale * up @ down`` in fp32, cast
to W's dtype (bf16 over fp8 storage, from the fp32 dequantization in one
rounding), so only one block's fused weights exist at a time.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..configs import WanDiTConfig
from ..utils.fp8 import is_fp8
from .weights import DIT_BLOCK_NAMES, DIT_TOP_NAMES, load_state_dict

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
    `LoRALinear`, ``rank`` and ``alpha`` the LoRA scale's terms. ``ranks``
    ({(module, name): rank}) adapts only those linears, each at its own
    rank (the runtime adapters of `load_runtime_lora`)."""

    def __init__(self, cfg: WanDiTConfig, rank: int, alpha: float,
                 dtype=torch.float32, device=None,
                 ranks: Optional[Mapping[Tuple[str, str], int]] = None):
        super().__init__()
        self.rank, self.alpha = rank, float(alpha)
        dims = _target_dims(cfg)
        if ranks is None:
            ranks = {(mod, n): rank for mod, names in ADAPTER_TARGETS.items()
                     for n in names}
        targets: Dict[str, Dict[str, int]] = {}
        for (mod, n), r in ranks.items():
            targets.setdefault(mod, {})[n] = r
        self.blocks = nn.ModuleList(
            nn.ModuleDict({mod: nn.ModuleDict({
                n: LoRALinear(r, *dims[(mod, n)], dtype, device)
                for n, r in names.items()}) for mod, names in targets.items()})
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
    `torch.func.functional_call` (differentiable wrt the adapters). Over fp8
    storage ``W.float()`` is the fp32 dequantization ``q.float() * scale``
    and ``W_eff`` is bf16, rounded once from fp32 (JAX's arithmetic)."""
    fused = {}
    for mod, names in ad.items():
        for name, lin in names.items():
            base = getattr(getattr(block, mod), name)
            w = base.weight                                     # [dout, din]
            delta = lin.up.float() @ lin.down.float()
            if is_fp8(base):
                w32, dtype = w.float() * base.weight_scale, torch.bfloat16
            else:
                w32, dtype = w.float(), w.dtype
            fused[f"{mod}.{name}.weight"] = (w32 + scale * delta).to(dtype)
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


# ------------------------------------------------------------ LoRA files

# published module name -> the port's module name (JAX's `_TOP_PATHS`; the
# block names, under "blocks.<i>.", are `DIT_BLOCK_NAMES`)
_TOP_PATHS = {**DIT_TOP_NAMES, "patch_embedding": "patch_embed"}


def _known_module_names(num_layers: int) -> Dict[str, str]:
    out = dict(_TOP_PATHS)
    for i in range(num_layers):
        for src, dst in DIT_BLOCK_NAMES.items():
            out[f"blocks.{i}.{src}"] = f"blocks.{i}.{dst}"
    return out


def parse_lora_state_dict(sd: Mapping[str, object], num_layers: int
                          ) -> Dict[str, Dict[str, object]]:
    """A LoRA state dict in any of the three key formats -> {published
    module name: {down, up[, alpha]}}: kohya ``lora_unet_blocks_0_self_attn_q
    .lora_down/lora_up.weight`` with ``.alpha``, Comfy ``diffusion_model.
    blocks.0.self_attn.q.lora_down/up.weight``, and PEFT ``blocks.0.self_attn
    .q.lora_A/lora_B(.default).weight`` (bare, or under ``diffusion_model.``
    or ``transformer.``). Modules the DiT does not have are skipped."""
    known = _known_module_names(num_layers)
    underscore_to_dotted = {k.replace(".", "_"): k for k in known}
    mods: Dict[str, Dict[str, object]] = {}

    def canon(raw: str) -> Optional[str]:
        return raw if raw in known else underscore_to_dotted.get(raw)

    for key, val in sd.items():
        # kohya underscore names first (the dotted pattern below would also
        # match them, and then fail to name a module)
        m = re.match(r"^lora_unet_(.+?)\.(lora_A|lora_B|lora_down|lora_up)"
                     r"(?:\.default)?\.weight$", key)
        if not m:
            m = re.match(r"^(?:diffusion_model\.|transformer\.)?(.+?)\."
                         r"(lora_A|lora_B|lora_down|lora_up)(?:\.default)?"
                         r"\.weight$", key)
        if not m:
            m = re.match(r"^(?:lora_unet_|diffusion_model\.|transformer\.)?"
                         r"(.+?)\.alpha$", key)
            name = canon(m.group(1)) if m else None
            if name:
                mods.setdefault(name, {})["alpha"] = float(
                    torch.as_tensor(val).reshape(()))
            continue
        name = canon(m.group(1))
        if name is None:
            continue
        slot = "down" if m.group(2) in ("lora_A", "lora_down") else "up"
        mods.setdefault(name, {})[slot] = torch.as_tensor(val)
    return {k: v for k, v in mods.items() if "down" in v and "up" in v}


@torch.no_grad()
def merge_lora(dit: nn.Module,
               lora: Union[str, Mapping[str, object]],
               multiplier: float = 1.0) -> List[str]:
    """Fuse a LoRA file (a path or a state dict) into ``dit``'s weights in
    place: ``W <- (W.float() + multiplier * (alpha / rank) * up @ down)
    .to(W.dtype)``, the product in fp32 on W's device; ``alpha`` defaults to
    the rank, and a conv LoRA on the patch embedding is flattened as its
    base weight is. Returns the port's names of the merged modules. An
    fp8-stored weight raises ``ValueError``: merge before quantizing (the
    factory applies ``lora_paths`` ahead of ``quantize="fp8"``), or attach
    the file as runtime adapters (`load_runtime_lora`)."""
    if isinstance(lora, str):
        lora = load_state_dict(lora)
    known = _known_module_names(dit.cfg.num_layers)
    merged = []
    for name, entry in parse_lora_state_dict(lora, dit.cfg.num_layers).items():
        down, up = entry["down"], entry["up"]
        rank = down.shape[0]
        scale = entry.get("alpha", float(rank)) / rank
        down = down.reshape(rank, -1)
        up = up.reshape(up.shape[0], -1)
        lin = dit.get_submodule(known[name])
        if is_fp8(lin):
            raise ValueError(
                f"cannot fuse LoRA into fp8-quantized weight {name!r}: merge "
                f"before quantization (factory.load_pipeline applies "
                f"lora_paths ahead of quantize='fp8') or load it as runtime "
                f"adapters (load_runtime_lora)")
        w = lin.weight
        delta = multiplier * scale * (up.to(w.device).float()
                                      @ down.to(w.device).float())
        if delta.shape != w.shape:
            raise ValueError(f"LoRA {name}: up @ down is {tuple(delta.shape)}"
                             f", the weight {tuple(w.shape)}")
        w.copy_((w.float() + delta).to(w.dtype))
        merged.append(known[name])
    return merged


def unmerge_lora(dit: nn.Module, lora: Union[str, Mapping[str, object]],
                 multiplier: float = 1.0) -> List[str]:
    """Subtract a merged LoRA file's delta again: `merge_lora` at
    ``-multiplier`` (the weights come back to fp32 rounding of the
    merge's)."""
    return merge_lora(dit, lora, multiplier=-multiplier)


RuntimeLoRA = Tuple[LoRAAdapters, float]


@torch.no_grad()
def load_runtime_lora(loras: Sequence[Tuple[Union[str, Mapping[str, object]],
                                            float]],
                      cfg: WanDiTConfig
                      ) -> Tuple[Optional[RuntimeLoRA], Dict[str, Dict]]:
    """LoRA files as runtime adapters, the LoRA path over fp8 weights
    (`merge_lora` refuses them): ``loras`` is a list of (path or state
    dict, multiplier). The files combine by rank concatenation, each
    file's ``multiplier * alpha / rank`` folded into its up matrices, so
    the runtime scale is 1.0; a file's layers are zero-padded to its
    largest rank. Returns ``((adapters, 1.0), leftover)``, the first the
    form `WanDiT.forward(lora=)` and `WanPipeline.set_runtime_lora` take
    (None when no file names a block linear), ``leftover`` the entries of
    the non-block modules ({published name: {down, up[, alpha],
    multiplier}}), which the caller merges or drops."""
    L = cfg.num_layers
    known = _known_module_names(L)
    per_file: Dict[Tuple[str, str], List[Dict[int, Tuple]]] = {}
    leftover: Dict[str, Dict] = {}
    dims: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for sd, mult in loras:
        if isinstance(sd, str):
            sd = load_state_dict(sd)
        file_blocks: Dict[Tuple[str, str], Dict[int, Tuple]] = {}
        for dotted, entry in parse_lora_state_dict(sd, L).items():
            parts = known[dotted].split(".")
            if parts[0] != "blocks":
                leftover[dotted] = {**entry, "multiplier": mult}
                continue
            layer, key = int(parts[1]), (parts[2], parts[3])
            rank = entry["down"].shape[0]
            down = entry["down"].reshape(rank, -1).float()
            up = entry["up"].reshape(entry["up"].shape[0], -1).float()
            scale = mult * entry.get("alpha", float(rank)) / rank
            file_blocks.setdefault(key, {})[layer] = (down, up * scale)
            dims[key] = (down.shape[1], up.shape[0])
        for key, layers in file_blocks.items():
            per_file.setdefault(key, []).append(layers)
    if not per_file:
        return None, leftover
    ranks = {key: sum(max(d.shape[0] for d, _ in layers.values())
                      for layers in files)
             for key, files in per_file.items()}
    adapters = LoRAAdapters(cfg, 1, 1.0, ranks=ranks)
    for (mod, name), files in per_file.items():
        start = 0
        for layers in files:
            r = max(d.shape[0] for d, _ in layers.values())
            for i, (d, u) in layers.items():
                lin = adapters.blocks[i][mod][name]
                lin.down[start:start + d.shape[0]] = d
                lin.up[:, start:start + u.shape[1]] = u
            start += r
    return (adapters, 1.0), leftover
