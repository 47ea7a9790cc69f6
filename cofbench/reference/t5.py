"""umT5-XXL encoder (Wan's ``wan/modules/t5.py``): T5 RMS norms, unscaled
attention with a relative-position bias of each layer's own, a gated-GELU
feed-forward; float32 throughout."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def position_buckets(length: int, num_buckets: int, max_dist: int,
                     device) -> torch.Tensor:
    """Bidirectional relative-position bucket of every (query, key) pair."""
    pos = torch.arange(length, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).long() * half
    rel = rel.abs()
    exact = half // 2
    large = exact + (torch.log(rel.float().clamp_min(1) / exact)
                     / math.log(max_dist / exact) * (half - exact)).long()
    large = large.clamp_max(half - 1)
    return buckets + torch.where(rel < exact, rel, large)


def _norm(x, weight, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def encode(sd, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
           quant=None) -> torch.Tensor:
    """ids, mask [B, L] -> the last hidden states [B, L, dim], float32.
    ``quant`` rounds both operands of every linear (the control: `fp8`)."""
    dev = ids.device
    q8 = quant or (lambda t: t)

    def w(key):
        return sd[key].to(dev, torch.float32)

    def linear(x, key):
        return F.linear(q8(x), q8(w(key)))

    B, L = ids.shape
    heads = cfg["num_heads"]
    x = F.embedding(ids, w("token_embedding.weight"))
    buckets = position_buckets(L, cfg["num_buckets"], cfg["rel_max_dist"],
                               dev)
    pad = torch.where(mask[:, None, None, :] > 0, 0.0,
                      torch.finfo(torch.float32).min)
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}."
        h = _norm(x, w(p + "norm1.weight"))
        q, k, v = (linear(h, p + f"attn.{n}.weight").unflatten(
            -1, (heads, -1)) for n in "qkv")
        bias = w(p + "pos_embedding.embedding.weight")[buckets]
        logits = (torch.einsum("bind,bjnd->bnij", q, k)
                  + bias.permute(2, 0, 1)[None] + pad)
        att = torch.einsum("bnij,bjnd->bind", logits.softmax(-1), v)
        x = x + linear(att.flatten(2), p + "attn.o.weight")
        h = _norm(x, w(p + "norm2.weight"))
        gate = F.gelu(linear(h, p + "ffn.gate.0.weight"), approximate="tanh")
        x = x + linear(linear(h, p + "ffn.fc1.weight") * gate,
                       p + "ffn.fc2.weight")
    return _norm(x, w("norm.weight"))
