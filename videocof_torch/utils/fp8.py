"""fp8 weight storage with bf16 compute.

Counterpart of `videocof_tpu/utils/fp8.py`: each large matmul weight of the
DiT is stored as ``float8_e4m3fn`` with an fp32 scale, ``scale = max(|W|,
1e-12) / 448`` and ``q = (W / scale).to(float8_e4m3fn)``, and dequantized
at its use to bf16, ``(q.float() * scale).to(bfloat16)`` (`wan_dit._linear`),
so only the linear being applied holds bf16 weights. It halves the DiT's
device memory: the two 14B experts of Wan2.2 A14B fit one 80 GB card with
umT5-XXL beside them.

JAX stacks the block weights on a layer axis and gives them one scale per
layer; here each block's weight is its own tensor with its own scale, the
same numbers. The weights quantized are JAX's: linear weights whose JAX
path (`convert.jax_param_path`) holds none of ``DEFAULT_EXCLUDE``.
Quantization runs on the weight's device, one tensor after another, so no
fp32 copy of a whole model ever exists.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

E4M3_MAX = 448.0
FP8 = torch.float8_e4m3fn
# JAX path substrings kept in high precision (the AdaLN and timestep names
# of every family JAX covers; norms and biases are 1-D anyway)
DEFAULT_EXCLUDE = ("modulation", "norm", "bias", "time_mlp", "time_proj",
                   "time_embed", "text_embed", "guidance_embed",
                   "img_mod", "txt_mod")


def is_fp8(lin: nn.Module) -> bool:
    """True when the linear ``lin`` stores its weight in fp8."""
    return lin.weight.dtype == FP8


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fp8 weight, fp32 0-d scale) of one weight, on its device."""
    a = w.detach().float()
    scale = a.abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (a / scale).to(FP8), scale


def dequantize(lin: nn.Module, dtype=None) -> torch.Tensor:
    """The linear's weight for compute: an fp8 one as ``(q.float() *
    scale).to(dtype or bfloat16)``, another as it is (in ``dtype`` when
    given)."""
    w = lin.weight
    if w.dtype == FP8:
        return (w.float() * lin.weight_scale).to(dtype or torch.bfloat16)
    return w if dtype is None else w.to(dtype)


def compute_dtype(lin: nn.Module) -> torch.dtype:
    """The dtype the linear computes in: bf16 for fp8 storage (the
    dequantization's target), else its weight's dtype."""
    return torch.bfloat16 if is_fp8(lin) else lin.weight.dtype


@torch.no_grad()
def quantize_dit_fp8(dit: nn.Module) -> nn.Module:
    """Store ``dit``'s matmul weights in fp8 in place, one tensor at a time
    on its device: each quantized linear's ``weight`` becomes the fp8
    tensor and its new buffer ``weight_scale`` the fp32 scale. Returns
    ``dit``."""
    from ..convert import jax_param_path    # convert imports models.lora
    for name, mod in dit.named_modules():
        if not isinstance(mod, nn.Linear) or is_fp8(mod):
            continue
        path = jax_param_path(f"{name}.weight")
        if any(p in path for p in DEFAULT_EXCLUDE):
            continue
        q, scale = quantize_weight(mod.weight)
        mod.weight = nn.Parameter(q, requires_grad=False)
        mod.register_buffer("weight_scale", scale)
    return dit


def fp8_bytes(module: nn.Module) -> int:
    """Bytes of ``module``'s parameters and buffers as stored."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))
