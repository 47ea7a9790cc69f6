"""RGB <-> I420 (YUV 4:2:0) with video-range BT.601 coefficients.

Counterpart of `videocof_tpu/utils/colorspace.py`: `rgb_to_i420` on the
host in numpy, `i420_to_rgb01` on the host through cv2, and
`i420_to_rgbm11`, the torch twin of `i420_to_rgbm11_jax`, which the
pipeline runs on the device when the video arrives as codec-native I420
planes (half the bytes of uint8 RGB).

Y = 16 + (65.481 R + 128.553 G + 24.966 B) / 255,
U = 128 + (-37.797 R - 74.203 G + 112 B) / 255,
V = 128 + (112 R - 93.786 G - 18.214 B) / 255; chroma is 2x2 mean-pooled.
Per frame the planes are packed as one [H * 3/2, W] uint8 image: H rows of
Y, then U (H/2 x W/2) row-major in H/4 rows of width W, then V likewise,
the layout ``cv2.cvtColor(..., COLOR_YUV2RGB_I420)`` takes.
"""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_i420(u8: np.ndarray) -> np.ndarray:
    """[B, 3, T, H, W] uint8 RGB -> [B, T, H*3//2, W] uint8 I420; needs
    H % 4 == 0 and W % 2 == 0 (the I420 row packing)."""
    B, C, T, H, W = u8.shape
    if C != 3 or H % 4 or W % 2:
        raise ValueError(f"I420 packing needs 3 channels, H % 4 == 0 and "
                         f"W % 2 == 0, got {u8.shape}")
    x = u8.astype(np.float32)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    u = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    v = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0

    def pool(c):
        return c.reshape(B, T, H // 2, 2, W // 2, 2).mean(axis=(3, 5))

    def q(c):
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    uq = q(pool(u)).reshape(B, T, H // 4, W)
    vq = q(pool(v)).reshape(B, T, H // 4, W)
    return np.concatenate([q(y), uq, vq], axis=2)


def i420_to_rgbm11(i420: torch.Tensor) -> torch.Tensor:
    """[B, T, H*3//2, W] uint8 I420 -> [B, 3, T, H, W] float32 in [-1, 1]
    on ``i420``'s device (nearest-neighbour chroma upsample, the arithmetic
    of `i420_to_rgbm11_jax`)."""
    B, T, Hp, W = i420.shape
    H = (Hp * 2) // 3
    f = torch.float32

    def chroma(rows):
        c = i420[:, :, rows].reshape(B, T, H // 2, W // 2)
        c = c.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return c.to(f) - 128.0

    y = i420[:, :, :H].to(f)
    u, v = chroma(slice(H, H + H // 4)), chroma(slice(H + H // 4, None))
    c = 1.164 * (y - 16.0)
    rgb = torch.stack([c + 1.596 * v, c - 0.391 * u - 0.813 * v,
                       c + 2.018 * u], dim=1)          # [B, 3, T, H, W]
    return rgb.clamp(0.0, 255.0) * (2.0 / 255.0) - 1.0


def i420_to_rgb01(i420: np.ndarray) -> np.ndarray:
    """[B, T, H*3//2, W] uint8 I420 -> [B, 3, T, H, W] float32 in [0, 1] on
    the host, through cv2's COLOR_YUV2RGB_I420 (I420 frames come only from
    `video_io.load_video_frames`, which needs cv2 too)."""
    import cv2
    B, T, Hp, W = i420.shape
    H = (Hp * 2) // 3
    out = np.empty((B, 3, T, H, W), np.float32)
    for bi in range(B):
        for ti in range(T):
            rgb = cv2.cvtColor(i420[bi, ti], cv2.COLOR_YUV2RGB_I420)
            out[bi, :, ti] = rgb.transpose(2, 0, 1)
    return out / 255.0
