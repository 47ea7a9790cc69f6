"""Camera-pose (Plücker-ray) control adapter, PyTorch.

Counterpart of the JAX package's `models/camera_adapter.py` (the reference's
`SimpleAdapter`, `wan_camera_adapter.py`): each frame's ray map is
pixel-unshuffled 8x, a stride-2 conv takes it to the DiT's patch grid, and
residual conv blocks follow; the output is added onto the patch embeddings
(`wan_transformer3d.py:871-874`, the DiT's ``y_camera``).
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn


def _conv(cin, cout, k, dtype, device):
    return nn.Conv2d(cin, cout, k, dtype=dtype, device=device)


class _ResBlock(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.conv1 = _conv(d, d, 3, dtype, device)
        self.conv2 = _conv(d, d, 3, dtype, device)


class CameraAdapter(nn.Module):
    """[B, in_dim, F, H, W] ray maps -> [B, out_dim, F, H / (8 s), W / (8 s)]
    features (s the conv's stride)."""

    def __init__(self, in_dim: int = 24, out_dim: int = 2048,
                 kernel_size: int = 2, stride: int = 2,
                 downscale_factor: int = 8, num_residual_blocks: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.downscale_factor, self.stride = downscale_factor, stride
        self.conv = _conv(in_dim * downscale_factor ** 2, out_dim,
                          kernel_size, dtype, device)
        self.res = nn.ModuleList(_ResBlock(out_dim, dtype, device)
                                 for _ in range(num_residual_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, Fr, H, W = x.shape
        y = x.transpose(1, 2).reshape(B * Fr, C, H, W)
        y = F.pixel_unshuffle(y, self.downscale_factor)
        y = _conv2d(y, self.conv, self.stride, 0)
        for rb in self.res:
            h = F.relu(_conv2d(y, rb.conv1, 1, 1))
            y = y + _conv2d(h, rb.conv2, 1, 1)
        O, Ho, Wo = y.shape[1:]
        return y.reshape(B, Fr, O, Ho, Wo).transpose(1, 2)


def _conv2d(x, conv: nn.Conv2d, stride: int, padding: int) -> torch.Tensor:
    """``conv`` in the input's dtype (JAX casts the kernel to it)."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    stride=stride, padding=padding)


def camera_adapter_forward(adapter: CameraAdapter, x: torch.Tensor
                           ) -> torch.Tensor:
    """JAX's `camera_adapter_forward` on the module's weights."""
    return adapter(x)


@torch.no_grad()
def init_camera_adapter(generator: torch.Generator, in_dim: int = 24,
                        out_dim: int = 2048, kernel_size: int = 2,
                        stride: int = 2, downscale_factor: int = 8,
                        num_residual_blocks: int = 1, dtype=torch.float32,
                        device=None) -> CameraAdapter:
    """Random weights as JAX's `init_camera_adapter` draws them (uniform
    ±1/sqrt(fan-in) kernels, zero biases), from ``generator``."""
    adapter = CameraAdapter(in_dim, out_dim, kernel_size, stride,
                            downscale_factor, num_residual_blocks, dtype,
                            device or generator.device)
    for name, p in adapter.named_parameters():
        if name.endswith(".bias"):
            p.zero_()
        else:
            b = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.empty(p.shape, device=generator.device).uniform_(
                -b, b, generator=generator))
    return adapter

