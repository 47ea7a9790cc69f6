"""XLM-Roberta text encoder with the CLIP projection head, PyTorch.

Counterpart of `videocof_tpu/models/xlm_roberta.py`: the text tower of the
reference's `XLMRobertaCLIP` (`videox_fun/models/wan_xlm_roberta.py`,
`wan_image_encoder.py:305-327` XLMRobertaWithHead): post-norm roberta
blocks, masked mean pooling and a bias-free 2-layer GELU head to the shared
embedding dim; `clip_vision.py` carries the image tower. Position ids follow
roberta's convention, ``pad_id + cumsum(mask) * mask``. The attention is
plain fp32 softmax attention (JAX's is XLA's `dot_product_attention`, a
library call, as the CLIP image tower's), the padding keys masked.

The module tree follows the JAX parameter tree
(`convert.xlm_roberta_from_jax`), linear weights [out, in]. No pipeline of
either package calls it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention
from .wan_dit import _layer_norm, _linear


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5
    out_dim: Optional[int] = 1024     # the CLIP head; None: hidden states

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# the xlm-roberta-large text tower of clip_xlm_roberta_vit_h_14
# (`wan_image_encoder.py:473-500`)
XLMR_LARGE = XLMRobertaConfig()
XLMR_TINY = XLMRobertaConfig(vocab_size=96, max_seq_len=32, dim=32,
                             num_heads=4, num_layers=2, out_dim=16)


class _Norm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


def _lin(din, dout, dtype, device, bias=True):
    return nn.Linear(din, dout, bias=bias, dtype=dtype, device=device)


class _Attn(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        for name in ("q", "k", "v", "o"):
            setattr(self, name, _lin(d, d, dtype, device))


class _Block(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.attn = _Attn(d, dtype, device)
        self.norm1 = _Norm(d, dtype, device)
        self.fc1 = _lin(d, 4 * d, dtype, device)
        self.fc2 = _lin(4 * d, d, dtype, device)
        self.norm2 = _Norm(d, dtype, device)


class _Head(nn.Module):
    def __init__(self, d, out_dim, dtype, device):
        super().__init__()
        mid = (d + out_dim) // 2
        self.fc1 = _lin(d, mid, dtype, device, bias=False)
        self.fc2 = _lin(mid, out_dim, dtype, device, bias=False)


class XLMRoberta(nn.Module):
    def __init__(self, cfg: XLMRobertaConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim

        def table(n):
            return nn.Parameter(torch.zeros(n, d, dtype=dtype, device=device))

        self.token_embedding = table(cfg.vocab_size)
        self.type_embedding = table(cfg.type_size)
        self.pos_embedding = table(cfg.max_seq_len)
        self.norm = _Norm(d, dtype, device)
        self.blocks = nn.ModuleList(_Block(d, dtype, device)
                                    for _ in range(cfg.num_layers))
        if cfg.out_dim is not None:
            self.head = _Head(d, cfg.out_dim, dtype, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return xlm_roberta_encode(self, ids)


@torch.no_grad()
def init_xlm_roberta(cfg: XLMRobertaConfig, generator: torch.Generator,
                     dtype=torch.float32, device=None) -> XLMRoberta:
    """Random weights drawn as JAX's `init_xlm_roberta` draws them (N(0,
    0.02^2) embeddings, uniform ±1/sqrt(din) linear weights, zero biases,
    unit norms), from ``generator`` on its device (or ``device``)."""
    model = XLMRoberta(cfg, dtype=dtype, device=device or generator.device)
    gdev = generator.device
    for name, p in model.named_parameters():
        if name.endswith("_embedding"):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                       device=gdev))
        elif name.endswith(".weight"):
            bound = 1.0 / math.sqrt(p.shape[1])
            p.copy_(torch.empty(p.shape, device=gdev).uniform_(
                -bound, bound, generator=generator))
        elif name.endswith(".bias"):
            p.zero_()
    return model


def _ln(x, norm: _Norm, eps):
    return _layer_norm(x, eps, norm.scale, norm.bias).to(x.dtype)


def _block(blk: _Block, cfg: XLMRobertaConfig, x, mask):
    B, L, D = x.shape
    N = cfg.num_heads

    def attn_body(h):
        q, k, v = (_linear(h, getattr(blk.attn, n)).reshape(B, L, N, D // N)
                   for n in "qkv")
        o = attention(q, k, v, mask=mask, backend="naive")
        return _linear(o.reshape(B, L, D), blk.attn.o)

    def ffn_body(h):
        return _linear(F.gelu(_linear(h, blk.fc1), approximate="none"),
                       blk.fc2)

    if cfg.post_norm:              # roberta: residual, then norm
        x = _ln(x + attn_body(x), blk.norm1, cfg.eps)
        return _ln(x + ffn_body(x), blk.norm2, cfg.eps)
    x = x + attn_body(_ln(x, blk.norm1, cfg.eps))
    return x + ffn_body(_ln(x, blk.norm2, cfg.eps))


def xlm_roberta_encode(model: XLMRoberta, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, L] -> hidden states [B, L, dim] (the reference's
    `XLMRoberta.forward`, `wan_xlm_roberta.py:121-145`)."""
    cfg = model.cfg
    ids = ids.to(model.token_embedding.device)
    mask = ids != cfg.pad_id
    pos = cfg.pad_id + torch.cumsum(mask.long(), dim=1) * mask
    x = (model.token_embedding[ids]
         + model.type_embedding[torch.zeros_like(ids)]
         + model.pos_embedding[pos])
    if cfg.post_norm:
        x = _ln(x, model.norm, cfg.eps)
    for blk in model.blocks:
        x = _block(blk, cfg, x, mask)
    if not cfg.post_norm:
        x = _ln(x, model.norm, cfg.eps)
    return x


def xlm_roberta_clip_text(model: XLMRoberta, ids: torch.Tensor
                          ) -> torch.Tensor:
    """ids [B, L] -> the pooled CLIP text embedding [B, out_dim] (the
    reference's `XLMRobertaWithHead.forward`, `wan_image_encoder.py:
    317-327`: masked mean pooling, the bias-free GELU head)."""
    x = xlm_roberta_encode(model, ids)
    m = (ids.to(x.device) != model.cfg.pad_id).to(x.dtype)[..., None]
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-6)
    h = F.gelu(_linear(pooled, model.head.fc1), approximate="none")
    return _linear(h, model.head.fc2)


def convert_xlm_roberta_state_dict(sd: Dict[str, torch.Tensor],
                                   cfg: XLMRobertaConfig, prefix: str = "",
                                   dtype=torch.float32
                                   ) -> Dict[str, torch.Tensor]:
    """The reference's module keys (`wan_xlm_roberta.py`, optionally under
    ``prefix``, ``textual.`` inside the CLIP checkpoint) -> `XLMRoberta`
    state dict in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}

    def put(dst, src):
        out[dst] = torch.as_tensor(sd[prefix + src]).to(dtype)

    for name in ("token", "type", "pos"):
        put(f"{name}_embedding", f"{name}_embedding.weight")

    def ln(dst, src):
        put(f"{dst}.scale", f"{src}.weight")
        put(f"{dst}.bias", f"{src}.bias")

    def lin(dst, src, bias=True):
        put(f"{dst}.weight", f"{src}.weight")
        if bias:
            put(f"{dst}.bias", f"{src}.bias")

    ln("norm", "norm")
    for i in range(cfg.num_layers):
        b = f"blocks.{i}."
        for n in "qkvo":
            lin(f"{b}attn.{n}", f"{b}attn.{n}")
        ln(b + "norm1", b + "norm1")
        lin(b + "fc1", b + "ffn.0")
        lin(b + "fc2", b + "ffn.2")
        ln(b + "norm2", b + "norm2")
    if cfg.out_dim is not None and prefix + "head.0.weight" in sd:
        lin("head.fc1", "head.0", bias=False)
        lin("head.fc2", "head.2", bias=False)
    return out
