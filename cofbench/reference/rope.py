"""Wan's 3D rotary embedding (``rope_params`` / ``rope_apply``) with the
chain-of-frames temporal positions and RIFLEx, in float64 complex numbers
as Wan computes it."""

from __future__ import annotations

import math
from typing import Optional

import torch


def _inv_freq(dim: int, theta: float) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)


def temporal_positions(frames: int, source: Optional[int], ground: int
                       ) -> torch.Tensor:
    """Each latent frame's temporal position: 0..f-1 plainly; with the
    chain of frames [1..source, 0 x ground, 1..target] (repeat-RoPE: the
    reasoning frames sit at 0, source and target restart at 1)."""
    if source is None:
        return torch.arange(frames)
    target = frames - source - ground
    return torch.cat([torch.arange(1, source + 1),
                      torch.zeros(ground, dtype=torch.long),
                      torch.arange(1, target + 1)])


def rope_table(grid, head_dim: int, source: Optional[int], ground: int,
               riflex_k: Optional[int] = None, riflex_frames: int = 66,
               theta: float = 10000.0) -> torch.Tensor:
    """exp(i * angle) of every token and frequency slot: [f*h*w, head_dim/2]
    complex128. The slots split (t, h, w) as Wan's ``d - 4 (d // 6)``,
    ``2 (d // 6)``, ``2 (d // 6)`` channels; RIFLEx sets the temporal
    frequency ``k`` to ``0.9 * 2 pi / riflex_frames``."""
    f, h, w = grid
    sixth = head_dim // 6
    t_dim, s_dim = head_dim - 4 * sixth, 2 * sixth
    inv_t = _inv_freq(t_dim, theta)
    if riflex_k is not None:
        inv_t[riflex_k - 1] = 0.9 * 2.0 * math.pi / riflex_frames
    inv_s = _inv_freq(s_dim, theta)
    pos_t = temporal_positions(f, source, ground).double()
    ang_t = torch.outer(pos_t, inv_t)
    ang_h = torch.outer(torch.arange(h, dtype=torch.float64), inv_s)
    ang_w = torch.outer(torch.arange(w, dtype=torch.float64), inv_s)
    ang = torch.cat([ang_t[:, None, None].expand(f, h, w, -1),
                     ang_h[None, :, None].expand(f, h, w, -1),
                     ang_w[None, None, :].expand(f, h, w, -1)], dim=-1)
    return torch.polar(torch.ones_like(ang), ang).reshape(f * h * w, -1)


def apply(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive channel pairs of x [L, N, D] by the table
    [L, D/2]; float64 inside, x's dtype out."""
    xc = torch.view_as_complex(x.double().unflatten(-1, (-1, 2)).contiguous())
    return torch.view_as_real(xc * table[:, None]).flatten(-2).to(x.dtype)
