"""The Wan2.1 DiT (Wan's ``WanModel.forward`` for t2v) in float32: patch
embedding as its Conv3d, sinusoidal time embedding, AdaLN-gated blocks with
q/k RMS norms, RoPE and softmax attention computed in blocks of query rows,
the modulated head and Wan's unpatchify. LoRA deltas are added to each
linear's float32 weight as the layer is reached."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import rope

# bytes of one block of attention logits (queries x keys x heads, float32)
LOGIT_BYTES = 2 << 30


def sinusoid(dim: int, t: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    ang = torch.outer(t.double(), 10000.0 ** (
        -torch.arange(half, dtype=torch.float64, device=t.device) / half))
    return torch.cat([ang.cos(), ang.sin()], dim=1).float()


def attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [L, N, D] float32 tensors, in blocks
    of query rows whose logits stay near LOGIT_BYTES."""
    qh = q.transpose(0, 1) * q.shape[-1] ** -0.5
    kh, vh = k.transpose(0, 1), v.transpose(0, 1)
    heads, lq, lk = qh.shape[0], qh.shape[1], kh.shape[1]
    rows = max(1, LOGIT_BYTES // (4 * heads * lk))
    out = torch.empty_like(qh)
    kt = kh.transpose(1, 2)
    for s in range(0, lq, rows):
        logits = torch.bmm(qh[:, s:s + rows], kt)
        out[:, s:s + rows] = torch.bmm(logits.softmax(-1), vh)
        del logits
    return out.transpose(0, 1)


def _rms(x, weight, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


class Weights:
    """float32 views of one DiT's published weights, with the LoRA deltas
    ``{module: [(up, down, scale)]}`` added to its linears; ``quant``
    rounds both operands of every linear (the control: `edit.fp8`)."""

    def __init__(self, sd, deltas: Dict[str, List[Tuple]], device,
                 quant=None):
        self.sd, self.deltas, self.device = sd, deltas, device
        self.q = quant or (lambda t: t)

    def __call__(self, key: str) -> torch.Tensor:
        return self.sd[key].to(self.device, torch.float32)

    def linear(self, x, name: str) -> torch.Tensor:
        w = self(name + ".weight")
        for up, down, scale in self.deltas.get(name, ()):
            w = w + scale * (up.to(self.device, torch.float32)
                             @ down.to(self.device, torch.float32))
        return F.linear(self.q(x), self.q(w), self(name + ".bias"))


def _attn(W: Weights, p: str, x, ctx, heads, eps, table):
    q = _rms(W.linear(x, p + "q"), W(p + "norm_q.weight"), eps)
    k = _rms(W.linear(ctx, p + "k"), W(p + "norm_k.weight"), eps)
    v = W.linear(ctx, p + "v")
    q, k, v = (a[0].unflatten(-1, (heads, -1)) for a in (q, k, v))
    if table is not None:
        q, k = rope.apply(q, table), rope.apply(k, table)
    return W.linear(attention(q, k, v).flatten(1)[None], p + "o")


def forward(W: Weights, cfg: dict, x: torch.Tensor, t: float,
            context: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Velocity [1, out_dim, F, H, W] of latents x [1, in_dim, F, H, W] at
    timestep t, for text embeddings [1, text_len, text_dim]."""
    dim, heads, eps = cfg["dim"], cfg["num_heads"], cfg["eps"]
    patch = tuple(cfg["patch_size"])
    h = F.conv3d(x, W("patch_embedding.weight"), W("patch_embedding.bias"),
                 stride=patch)
    grid = h.shape[2:]
    h = h.flatten(2).transpose(1, 2)
    tt = torch.tensor([float(t)], device=x.device)
    e = W.linear(F.silu(W.linear(sinusoid(cfg["freq_dim"], tt),
                                 "time_embedding.0")), "time_embedding.2")
    e0 = W.linear(F.silu(e), "time_projection.1").unflatten(1, (6, dim))
    ctx = W.linear(F.gelu(W.linear(context, "text_embedding.0"),
                          approximate="tanh"), "text_embedding.2")
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}."
        m = (W(p + "modulation") + e0).unbind(1)
        xs = F.layer_norm(h, (dim,), eps=eps) * (1 + m[1]) + m[0]
        y = _attn(W, p + "self_attn.", xs, xs, heads, eps, table)
        h = h + y * m[2]
        xc = F.layer_norm(h, (dim,), W(p + "norm3.weight"),
                          W(p + "norm3.bias"), eps)
        h = h + _attn(W, p + "cross_attn.", xc, ctx, heads, eps, None)
        xf = F.layer_norm(h, (dim,), eps=eps) * (1 + m[4]) + m[3]
        y = W.linear(F.gelu(W.linear(xf, p + "ffn.0"), approximate="tanh"),
                     p + "ffn.2")
        h = h + y * m[5]
    hm = (W("head.modulation") + e[:, None]).unbind(1)
    out = W.linear(F.layer_norm(h, (dim,), eps=eps) * (1 + hm[1]) + hm[0],
                   "head.head")
    c = cfg["out_dim"]
    u = out[0].view(*grid, *patch, c)
    u = torch.einsum("fhwpqrc->cfphqwr", u)
    return u.reshape(c, *(g * s for g, s in zip(grid, patch)))[None]


def lora_deltas(files, num_layers: int) -> Dict[str, List[Tuple]]:
    """{published module name: [(up, down, multiplier * alpha / rank)]} of
    LoRA state dicts in the kohya (``lora_unet_<name with _>.lora_down``,
    ``.lora_up``, ``.alpha``) or PEFT (``<name>.lora_A``, ``.lora_B``, no
    alpha: the rank) format, each with its multiplier."""
    names = [f"blocks.{i}.{a}.{b}" for i in range(num_layers)
             for a, b in [("self_attn", n) for n in "qkvo"]
             + [("cross_attn", n) for n in "qkvo"] + [("ffn", "0"),
                                                     ("ffn", "2")]]
    kohya = {"lora_unet_" + n.replace(".", "_"): n for n in names}
    deltas: Dict[str, List[Tuple]] = {}
    for sd, mult in files:
        for key, down in sd.items():
            if key.endswith(".lora_down.weight"):
                base = key[:-len(".lora_down.weight")]
                name, up = kohya[base], sd[base + ".lora_up.weight"]
                rank = down.shape[0]
                alpha = float(sd[base + ".alpha"]) if (
                    base + ".alpha") in sd else float(rank)
            elif key.endswith(".lora_A.weight"):
                name = key[:-len(".lora_A.weight")]
                up, rank = sd[name + ".lora_B.weight"], down.shape[0]
                alpha = float(rank)
            else:
                continue
            deltas.setdefault(name, []).append((up, down,
                                                mult * alpha / rank))
    return deltas
