"""3D rotary position embeddings with chain-of-frames (CoF) segment restarts.

Counterpart of `videocof_tpu/models/rope.py`. The segment logic is data: the
temporal position of every latent frame is an integer array built on the
host, the per-token angle tables are float64 numpy, and the rotation is an
elementwise op on tensors.

Frequency layout: for head_dim d the complex half c = d//2 splits into
(t, h, w) sections of size (c - 2*(c//3), c//3, c//3); each section uses
theta^(2i/section_dim) inverse frequencies over its own axis position.
Channels are rotated in consecutive (interleaved) pairs, not halves.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def rope_section_dims(head_dim: int) -> Tuple[int, int, int]:
    """(t, h, w) split of the d//2 complex frequency slots."""
    c = head_dim // 2
    return (c - 2 * (c // 3), c // 3, c // 3)


def _inv_freqs(section: int, theta: float) -> np.ndarray:
    dim = 2 * section
    return 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)


@functools.lru_cache(maxsize=8)
def rope_angle_tables(head_dim: int, max_pos: int = 1024,
                      theta: float = 10000.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-axis angle tables (pos x section) in float64; cached per geometry."""
    ct, ch, cw = rope_section_dims(head_dim)
    pos = np.arange(max_pos, dtype=np.float64)
    return tuple(np.outer(pos, _inv_freqs(c, theta)) for c in (ct, ch, cw))


def riflex_angle_table(head_dim: int, k: int, L_test: int,
                       L_test_scale: Optional[float] = None,
                       max_pos: int = 1024, theta: float = 10000.0
                       ) -> np.ndarray:
    """RIFLEx temporal angle table (pos x temporal section), float64: the
    intrinsic frequency k is shrunk so that an extrapolated length stays
    within one period, ``freq[k-1] = 0.9 * 2 pi / L_test``, optionally
    divided by ``L_test_scale``."""
    ct, _, _ = rope_section_dims(head_dim)
    inv = _inv_freqs(ct, theta).copy()
    inv[k - 1] = 0.9 * 2.0 * np.pi / L_test
    if L_test_scale is not None:
        inv[k - 1] = inv[k - 1] / L_test_scale
    pos = np.arange(max_pos, dtype=np.float64)
    return np.outer(pos, inv)


def cof_temporal_positions(f: int, f_src: Optional[int] = None,
                           f_ground: int = 0) -> np.ndarray:
    """Temporal RoPE position of each latent frame:
      * default              -> [0, 1, ..., f-1]
      * paired (src, tgt)    -> [0..f_src-1, 0..f_tgt-1]
      * CoF (src, ground, tgt) -> [1..f_src, 0 x f_ground, 1..f_tgt]
    """
    if f_src is None:
        return np.arange(f, dtype=np.int32)
    if f_ground and f_ground > 0:
        f_tgt = f - f_src - f_ground
        if f_tgt < 0:
            raise ValueError(f"{f} frames < {f_src} source + {f_ground} ground")
        return np.concatenate([
            1 + np.arange(f_src, dtype=np.int32),
            np.zeros(f_ground, dtype=np.int32),
            1 + np.arange(f_tgt, dtype=np.int32),
        ])
    f_tgt = f - f_src
    if f_tgt < 0:
        raise ValueError(f"{f} frames < {f_src} source frames")
    return np.concatenate([np.arange(f_src, dtype=np.int32),
                           np.arange(f_tgt, dtype=np.int32)])


def build_rope_cos_sin(grid: Tuple[int, int, int], head_dim: int,
                       f_src: Optional[int] = None, f_ground: int = 0,
                       max_pos: int = 1024, theta: float = 10000.0,
                       temporal_table: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense per-token cos/sin tables [f*h*w, head_dim//2], float32 numpy,
    computed from float64 angles. ``temporal_table`` replaces the temporal
    angle table (RIFLEx)."""
    f, h, w = grid
    tab_t, tab_h, tab_w = rope_angle_tables(head_dim, max_pos, theta)
    if temporal_table is not None:
        tab_t = temporal_table
    ang_t = tab_t[cof_temporal_positions(f, f_src, f_ground)]
    ang_h, ang_w = tab_h[:h], tab_w[:w]
    ct, ch, cw = ang_t.shape[1], ang_h.shape[1], ang_w.shape[1]
    out = np.empty((f, h, w, ct + ch + cw), dtype=np.float64)
    out[..., :ct] = ang_t[:, None, None, :]
    out[..., ct:ct + ch] = ang_h[None, :, None, :]
    out[..., ct + ch:] = ang_w[None, None, :, :]
    out = out.reshape(f * h * w, ct + ch + cw)
    return np.cos(out).astype(np.float32), np.sin(out).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rotate consecutive channel pairs of ``x`` [B, L, N, D] by per-token
    angles: cos/sin [L, D//2], or [B, L, D//2] for per-sample tables (the
    ragged batch, where each sample carries its own geometry's table). The
    rotation runs in ``compute_dtype`` (default fp32); the result is in x's
    dtype."""
    cd = torch.float32 if compute_dtype is None else compute_dtype
    L, D = x.shape[-3], x.shape[-1]
    xf = x.to(cd).unflatten(-1, (D // 2, 2))
    a, b = xf[..., 0], xf[..., 1]
    lead = cos.shape[:-2]     # () or (B,)
    c = cos.reshape(*lead, L, 1, D // 2).to(cd)
    s = sin.reshape(*lead, L, 1, D // 2).to(cd)
    ra = (a * c - b * s).to(x.dtype)
    rb = (a * s + b * c).to(x.dtype)
    return torch.stack([ra, rb], dim=-1).flatten(-2)
