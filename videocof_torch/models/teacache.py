"""TeaCache: timestep-embedding-aware step skipping.

Counterpart of `videocof_tpu/models/teacache.py`. The skip signal is the
relative L1 distance between successive timestep modulations ``e0``, which
depends only on the timestep schedule and the time-MLP weights, not on the
latents; so the whole skip plan is computed once per (timesteps, weights)
before the loop. On a skipped step the block stack is bypassed and the
cached token-stream residual re-added (`WanDiT.forward_with_residual`); the
head still runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .wan_dit import WanDiT, _linear, sinusoidal_embedding_1d

# Published per-model rescale polynomials (TeaCache, arXiv:2411.19108).
TEACACHE_COEFFICIENTS = {
    "wan2.1-t2v-1.3b": [-5.21862437e+04, 9.23041404e+03, -5.28275948e+02,
                        1.36987616e+01, -4.99875664e-02],
    "wan2.1-t2v-14b": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03,
                       5.87365115e+01, -3.15583525e-01],
    "wan2.1-i2v-14b-480p": [2.57151496e+05, -3.54229917e+04, 1.40286849e+03,
                            -1.35890334e+01, 1.32517977e-01],
    "wan2.1-i2v-14b-720p": [8.10705460e+03, 2.13393892e+03, -3.72934672e+02,
                            1.66203073e+01, -4.17769401e-02],
}

# Checkpoint-name alias -> coefficient set, in the reference's order: every
# Fun/VACE/Wan2.2 family name maps onto one of the four published
# polynomials. Substring match, first hit wins.
_ALIAS_CHAIN = (
    (("wan2.1-t2v-1.3b", "wan2.1-fun-1.3b", "wan2.1-fun-v1.1-1.3b",
      "wan2.1-vace-1.3b"), "wan2.1-t2v-1.3b"),
    (("wan2.1-t2v-14b",), "wan2.1-t2v-14b"),
    (("wan2.1-i2v-14b-480p",), "wan2.1-i2v-14b-480p"),
    (("wan2.1-i2v-14b-720p", "wan2.1-fun-14b", "wan2.2-fun",
      "wan2.2-i2v-a14b", "wan2.2-t2v-a14b", "wan2.2-ti2v-5b",
      "wan2.2-s2v", "wan2.1-vace-14b", "wan2.2-vace-fun"),
     "wan2.1-i2v-14b-720p"),
)


def get_teacache_coefficients(model_name: str) -> Optional[List[float]]:
    """The coefficient set of a checkpoint name; a name matching no alias
    falls back on its size ("1.3b", "14b"), else None."""
    low = model_name.lower()
    for aliases, key in _ALIAS_CHAIN:
        if any(a in low for a in aliases):
            return TEACACHE_COEFFICIENTS[key]
    if "1.3b" in low:
        return TEACACHE_COEFFICIENTS["wan2.1-t2v-1.3b"]
    if "14b" in low:
        return TEACACHE_COEFFICIENTS["wan2.1-t2v-14b"]
    return None


@torch.no_grad()
def timestep_modulations(dit: WanDiT, timesteps: Sequence[float]
                         ) -> np.ndarray:
    """e0 [N, 6 * dim] for each timestep, fp32, as `WanDiT.forward` computes
    it."""
    dev = dit.time_proj.fc.weight.device
    t = torch.as_tensor(np.asarray(timesteps, np.float32), device=dev)
    e = sinusoidal_embedding_1d(dit.cfg.freq_dim, t)
    e = _linear(e, dit.time_mlp.fc1, torch.float32)
    e = _linear(F.silu(e), dit.time_mlp.fc2, torch.float32)
    e0 = _linear(F.silu(e), dit.time_proj.fc, torch.float32)
    return e0.cpu().numpy()


def plan_teacache_skips(dit: WanDiT, timesteps: Sequence[float],
                        coefficients: Sequence[float], rel_l1_thresh: float,
                        num_skip_start_steps: int = 0) -> List[bool]:
    """True = skip the block stack at that step (replay the cached
    residual). The accumulated rescaled distance skips while it stays below
    the threshold and resets on a computed step; step 0 and the first
    ``num_skip_start_steps`` always compute."""
    e0 = timestep_modulations(dit, timesteps)
    poly = np.polynomial.Polynomial(list(reversed(list(coefficients))))
    skips: List[bool] = []
    acc = 0.0
    prev = None
    for i in range(len(timesteps)):
        if i < num_skip_start_steps or prev is None:
            skips.append(False)
            acc = 0.0
        else:
            rel = float(np.mean(np.abs(e0[i] - prev)) /
                        (np.mean(np.abs(prev)) + 1e-12))
            acc += float(poly(rel))
            skip = acc < rel_l1_thresh
            skips.append(skip)
            if not skip:
                acc = 0.0
        prev = e0[i]
    return skips
