"""Attention backend dispatch (counterpart of `videocof_tpu/ops/attention.py`).

Backends:
  * ``"flash"`` — the hand-written CUDA flash-attention kernel
    (`flash_attention.py`); the default for CUDA tensors.
  * ``"int8"`` — the Sage-style int8-QK^T kernel B4 (`int8_attention.py`),
    inference only. Opt-in, as in JAX.
  * ``"naive"`` — explicit fp32 softmax attention, the twin of JAX's
    ``_naive_attention``; the default for CPU tensors.

Selection, as in JAX: an explicit ``backend=`` argument, then the
``VIDEOCOF_ATTENTION_TYPE`` environment variable, then the device
(`default_backend`). JAX's name ``"pallas"`` is taken as ``"flash"``, its
kernel's counterpart; JAX's ``"xla"`` has none and raises, as an unknown
name does.

Unlike JAX, which drops to XLA attention when its kernel cannot take a call
(a head_dim that is not a multiple of 128 for ``"int8"``, one the flash
kernel lacks for ``"pallas"``), nothing here switches path silently: what a
kernel does not take raises.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from .flash_attention import flash_attention
from .int8_attention import int8_flash_attention

BACKENDS = ("flash", "int8", "naive")
_ENV_VAR = "VIDEOCOF_ATTENTION_TYPE"
# JAX's backend names that have a counterpart here
_ALIASES = {"pallas": "flash"}


def available_backends() -> tuple:
    """The backend names `attention` takes."""
    return BACKENDS


def _canonical(name: str) -> str:
    name = _ALIASES.get(name.lower(), name.lower())
    if name not in BACKENDS:
        raise ValueError(f"attention backend {name!r} not in {BACKENDS}")
    return name


def default_backend(device: Union[torch.device, torch.Tensor, str, None]
                    = None) -> str:
    """``VIDEOCOF_ATTENTION_TYPE`` when it is set (ValueError for a name
    not in `available_backends`), else ``"flash"`` on a CUDA device and
    ``"naive"`` on the CPU. ``device``: a device, a tensor on it, or None
    for the card when one is present."""
    env = os.environ.get(_ENV_VAR, "")
    if env:
        try:
            return _canonical(env)
        except ValueError:
            raise ValueError(f"{_ENV_VAR}={env!r} not in {BACKENDS}") from None
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        return "flash" if torch.cuda.is_available() else "naive"
    return "flash" if torch.device(device).type == "cuda" else "naive"


# rows of q per chunk of the naive backend: keeps its fp32 logits near 1 GiB
_NAIVE_LOGIT_BYTES = 1 << 30


def _naive_attention(q, k, v, mask=None, scale=None):
    """fp32 softmax attention, q's rows taken in chunks whose logits stay
    near 1 GiB (each row's softmax is its own: the chunks change nothing);
    K and V are laid out for the batched products once."""
    B, Lq, N, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    Lk = k.shape[1]
    # [B*N, D, Lk] and [B*N, Lk, D]
    kt = k.float().permute(0, 2, 3, 1).reshape(B * N, d, Lk)
    vf = v.float().permute(0, 2, 1, 3).reshape(B * N, Lk, d)
    masked = None if mask is None else ~mask.bool()[:, None, None, :]
    rows = max(1, _NAIVE_LOGIT_BYTES // (4 * B * N * max(Lk, 1)))
    outs = []
    for r0 in range(0, Lq, rows):
        qc = q[:, r0:r0 + rows].float().permute(0, 2, 1, 3)   # [B, N, r, D]
        r = qc.shape[2]
        # the logits scaled in the product's epilogue: (q . k) * scale
        logits = torch.baddbmm(torch.zeros(1, 1, 1, device=q.device),
                               qc.reshape(B * N, r, d), kt, beta=0.0,
                               alpha=scale).view(B, N, r, Lk)
        if masked is not None:
            logits.masked_fill_(masked, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).view(B * N, r, Lk)
        outs.append(torch.bmm(probs, vf).view(B, N, r, d).transpose(1, 2)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention over [B, L, N, D] tensors (heads on axis -2).
    ``mask`` is a boolean key mask [B, Lk] (True = attend)."""
    backend = default_backend(q) if backend is None else _canonical(backend)
    if backend == "flash":
        return flash_attention(q, k, v, kv_mask=mask, scale=scale)
    if backend == "int8":
        return int8_flash_attention(q, k, v, kv_mask=mask, scale=scale)
    return _naive_attention(q, k, v, mask=mask, scale=scale)
