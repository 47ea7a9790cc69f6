"""The benchmark's arithmetic that holds for every family: the H100's
published peaks, a kernel's bound and the FLOP and bytes of one attention
call (a frozen copy of `chip_smoke.py`'s ``bound`` and ``kernel_work``).
Each family counts its own model's FLOP (`cofbench/families/`)."""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds a kernel can take: the larger of its operations
    over the bf16 peak and its bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attention_work(B, Lq, Lk, N, D, eb=2) -> Tuple[float, float]:
    """(FLOP, bytes) of one forward attention call: QK^T and PV, and q, k,
    v read once and o written once."""
    mm = B * N * Lq * Lk * D
    return 4.0 * mm, float(eb * (2 * B * Lq * N * D + 2 * B * Lk * N * D))
