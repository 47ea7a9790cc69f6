"""CLIP ViT-H/14 vision tower of image-to-video conditioning, PyTorch.

Counterpart of the JAX package's `models/clip_vision.py` (the reference's
XLM-Roberta-CLIP visual branch, `wan_image_encoder.py:211-299,470-552`): a
bias-free patch-14 conv, the CLS token and learned positions, a pre-norm
LayerNorm, then the first ``use_blocks`` (31) of the 32 pre-norm blocks,
giving [B, 257, 1280] features with no final norm or head. The blocks'
attention is plain fp32 softmax attention (JAX's is XLA's
`dot_product_attention`, no Pallas kernel; head_dim 80).

`preprocess_frames` resizes as ``jax.image.resize(..., "cubic")`` does:
Keys' cubic with a = -0.5, half-pixel centres, and the kernel widened by the
scale when shrinking (antialiasing); ``F.interpolate(mode="bicubic")`` uses
a = -0.75 and does not widen its kernel, so it is not used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention
from .wan_dit import _layer_norm, _linear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# the published Wan2.1-I2V file of the tower (its ``visual.*`` keys)
CLIP_FILE = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    use_blocks: int = 31       # i2v takes the 31-block features
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_VIT_H_14 = ClipVisionConfig()
CLIP_TINY = ClipVisionConfig(image_size=28, patch_size=14, dim=32,
                             num_heads=4, num_layers=3, use_blocks=2)


class _Norm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        p = cfg.patch_size
        self.weight = nn.Parameter(torch.zeros(cfg.dim, 3, p, p, dtype=dtype,
                                               device=device))


class _Block(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype, device):
        super().__init__()
        d, f = cfg.dim, cfg.dim * cfg.mlp_ratio
        lin = lambda i, o: nn.Linear(i, o, dtype=dtype, device=device)  # noqa
        self.norm1 = _Norm(d, dtype, device)
        self.qkv = lin(d, 3 * d)
        self.proj = lin(d, d)
        self.norm2 = _Norm(d, dtype, device)
        self.fc1 = lin(d, f)
        self.fc2 = lin(f, d)

    def forward(self, x, cfg: ClipVisionConfig):
        B, L, D = x.shape
        N = cfg.num_heads
        h = _layer_norm(x, cfg.norm_eps, self.norm1.scale, self.norm1.bias)
        qkv = _linear(h.to(x.dtype), self.qkv).reshape(B, L, 3, N, D // N)
        att = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                        backend="naive")
        x = x + _linear(att.reshape(B, L, D), self.proj).float()
        h = _layer_norm(x, cfg.norm_eps, self.norm2.scale, self.norm2.bias)
        h = F.gelu(_linear(h.to(x.dtype), self.fc1), approximate="none")
        return x + _linear(h, self.fc2).float()


class ClipVision(nn.Module):
    """images [B, 3, H, W], CLIP-normalized (`preprocess_frames`) ->
    features [B, 1 + patches, dim] in the images' dtype."""

    def __init__(self, cfg: ClipVisionConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg, dtype, device)
        self.cls = nn.Parameter(torch.zeros(1, 1, cfg.dim, dtype=dtype,
                                            device=device))
        self.pos = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, cfg.dim,
                                            dtype=dtype, device=device))
        self.pre_norm = _Norm(cfg.dim, dtype, device)
        self.blocks = nn.ModuleList(_Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = images.shape[0]
        kern = self.patch_embed.weight
        x = F.conv2d(images.to(kern.dtype), kern, stride=cfg.patch_size)
        x = x.reshape(B, cfg.dim, -1).transpose(1, 2)           # [B, P, D]
        x = torch.cat([self.cls.to(x.dtype).expand(B, 1, cfg.dim), x], dim=1)
        x = x + self.pos.to(x.dtype)
        x = _layer_norm(x, cfg.norm_eps, self.pre_norm.scale,
                        self.pre_norm.bias)
        for block in self.blocks[:cfg.use_blocks]:
            x = block(x, cfg)
        return x.to(images.dtype)


def clip_vision_forward(model: ClipVision, images: torch.Tensor
                        ) -> torch.Tensor:
    """JAX's `clip_vision_forward` on the module's weights."""
    return model(images)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of a Keys-cubic resize of one axis, computed in
    float64 as JAX's `compute_weight_mat` (antialiased: the kernel widened
    by n_in / n_out when shrinking; columns normalized; samples outside the
    input zeroed)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def cubic_resize(x: torch.Tensor, size) -> torch.Tensor:
    """[B, C, H, W] float -> [B, C, size[0], size[1]] with JAX's 'cubic'
    resize (an axis of unchanged length is left as it is)."""
    H, W = x.shape[-2:]
    oh, ow = size
    x = x.float()
    if oh != H:
        wh = torch.as_tensor(cubic_resize_matrix(H, oh), dtype=torch.float32,
                             device=x.device)
        x = torch.einsum("bchw,hH->bcHw", x, wh)
    if ow != W:
        ww = torch.as_tensor(cubic_resize_matrix(W, ow), dtype=torch.float32,
                             device=x.device)
        x = torch.einsum("bchw,wW->bchW", x, ww)
    return x


def preprocess_frames(frames: torch.Tensor, cfg: ClipVisionConfig
                      ) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> CLIP-normalized fp32 at ``image_size``
    (the reference resizes bicubic, then normalizes from [-1, 1],
    `wan_image_encoder.py:512-522`)."""
    size = cfg.image_size
    x = cubic_resize(frames, (size, size)) * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


_CLIP_TOP = {"patch_embed.weight": "visual.patch_embedding.weight",
             "cls": "visual.cls_embedding", "pos": "visual.pos_embedding",
             "pre_norm.scale": "visual.pre_norm.weight",
             "pre_norm.bias": "visual.pre_norm.bias"}
_CLIP_BLOCK = {"norm1": "norm1", "norm2": "norm2", "attn.to_qkv": "qkv",
               "attn.proj": "proj", "mlp.0": "fc1", "mlp.2": "fc2"}


def clip_key_map(cfg: ClipVisionConfig) -> Dict[str, str]:
    """{the port's `ClipVision` key: the published ``visual.*`` key}."""
    names = dict(_CLIP_TOP)
    for i in range(cfg.num_layers):
        for src, dst in _CLIP_BLOCK.items():
            w = "scale" if dst.startswith("norm") else "weight"
            s, d = f"visual.transformer.{i}.{src}", f"blocks.{i}.{dst}"
            names[f"{d}.{w}"] = s + ".weight"
            names[d + ".bias"] = s + ".bias"
    return names


def export_clip_state_dict(sd: Dict[str, torch.Tensor],
                           cfg: ClipVisionConfig) -> Dict[str, torch.Tensor]:
    """`ClipVision` state dict -> the published ``visual.*`` keys."""
    return {src: sd[dst] for dst, src in clip_key_map(cfg).items()}


def convert_clip_state_dict(sd: Dict[str, torch.Tensor],
                            cfg: ClipVisionConfig,
                            dtype: torch.dtype = torch.float32
                            ) -> Dict[str, torch.Tensor]:
    """The published tower's keys (``visual.*`` of XLMRobertaCLIP, with or
    without the reference wrapper's 'model.' prefix) -> `ClipVision` state
    dict in ``dtype``."""
    if not any(k.startswith("visual.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    return {dst: sd[src].to(dtype) for dst, src in clip_key_map(cfg).items()}


@torch.no_grad()
def init_clip_vision(cfg: ClipVisionConfig, generator: torch.Generator,
                     dtype=torch.float32, device=None) -> ClipVision:
    """Random weights drawn as JAX's `init_clip_vision` draws them (uniform
    ±1/sqrt(din) linear weights, zero biases, unit norms, N(0, 1/dim) patch
    conv, CLS and positions), from ``generator`` on ``device``."""
    model = ClipVision(cfg, dtype=dtype, device=device or generator.device)
    gdev = generator.device
    gain = 1.0 / math.sqrt(cfg.dim)
    for name, p in model.named_parameters():
        if name in ("patch_embed.weight", "cls", "pos"):
            p.copy_(gain * torch.randn(p.shape, generator=generator,
                                       device=gdev))
        elif name.endswith(".weight") and p.dim() == 2:
            bound = 1.0 / math.sqrt(p.shape[1])
            p.copy_(torch.empty(p.shape, device=gdev).uniform_(
                -bound, bound, generator=generator))
    return model
