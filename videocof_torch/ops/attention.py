"""Attention backend dispatch (counterpart of `videocof_tpu/ops/attention.py`).

Backends:
  * ``"flash"`` — the hand-written CUDA flash-attention kernel
    (`flash_attention.py`); the default for CUDA tensors.
  * ``"int8"`` — the Sage-style int8-QK^T kernel B4 (`int8_attention.py`),
    inference only. Opt-in, as in JAX.
  * ``"naive"`` — explicit fp32 softmax attention, the twin of JAX's
    ``_naive_attention``; the default for CPU tensors.

Unlike JAX, which drops to XLA attention when its kernel cannot take a call
(a head_dim that is not a multiple of 128 for ``"int8"``, one the flash
kernel lacks for ``"pallas"``), nothing here switches path silently: what a
kernel does not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .int8_attention import int8_flash_attention

BACKENDS = ("flash", "int8", "naive")


def _naive_attention(q, k, v, mask=None, scale=None):
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(~mask.bool()[:, None, None, :], neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", probs, v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention over [B, L, N, D] tensors (heads on axis -2).
    ``mask`` is a boolean key mask [B, Lk] (True = attend)."""
    if backend is None:
        backend = "flash" if q.is_cuda else "naive"
    if backend == "flash":
        return flash_attention(q, k, v, kv_mask=mask, scale=scale)
    if backend == "int8":
        return int8_flash_attention(q, k, v, kv_mask=mask, scale=scale)
    if backend == "naive":
        return _naive_attention(q, k, v, mask=mask, scale=scale)
    raise ValueError(f"attention backend {backend!r} not in {BACKENDS}")
