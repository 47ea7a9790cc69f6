"""Timing and tracing instrumentation.

Counterpart of `videocof_tpu/utils/profiling.py`: a device-synchronized
timer decorator with structured records (the reference's ``timer`` /
``timer_record``, `utils/utils.py:352-412`), a trace context and the
analytic FLOPs of a Wan DiT forward that MFU is reported against. JAX's
``xla_trace`` captures an XLA profiler trace; here the context is
``torch_trace`` over ``torch.profiler`` (a Chrome trace file for
chrome://tracing or Perfetto, the CUDA activity included on a card).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_RECORDS: List[Dict] = []


def _sync() -> None:
    """Wait for all queued work on the current CUDA device (nothing to
    wait for without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def timer(fn=None, *, name: Optional[str] = None, record: bool = True):
    """Decorator: device-synchronized wall-clock seconds of each call,
    appended to the in-process records and printed on rank 0."""

    def wrap(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def inner(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            _sync()
            dt = time.perf_counter() - t0
            if record:
                _RECORDS.append({"name": label, "seconds": dt,
                                 "ts": time.time()})
            if _rank() == 0:
                print(f"[timer] {label}: {dt:.3f}s", file=sys.stderr)
            return out

        return inner

    return wrap(fn) if fn is not None else wrap


def records() -> List[Dict]:
    return list(_RECORDS)


def dump_records(path: str) -> None:
    """The records as a jsonl file (the reference writes Excel rows)."""
    with open(path, "w") as f:
        for r in _RECORDS:
            f.write(json.dumps(r) + "\n")


def reset_records() -> None:
    _RECORDS.clear()


@contextlib.contextmanager
def torch_trace(logdir: str, name: str = "trace.json"):
    """Profile the block (CPU, and CUDA where a card is present) with
    ``torch.profiler`` and write its Chrome trace to ``logdir/name``;
    yields the profiler (``key_averages()`` for a table)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, name))


def dit_matmul_flops(cfg, num_tokens: int, text_len: int = None) -> float:
    """Analytic matmul and attention FLOPs of one Wan DiT forward at
    ``num_tokens`` (batch 1), JAX's arithmetic: the self-attention's q, k,
    v, o over the tokens, the cross-attention's q and o over the tokens and
    k and v over the text, the FFN, both attentions' QK^T and PV, the head
    and the patch embedding."""
    L = num_tokens
    d, f = cfg.dim, cfg.ffn_dim
    Lt = text_len or cfg.text_len
    per_block = 2 * L * (4 * d * d) + 2 * (L + Lt) * d * d * 2 \
        + 2 * L * (2 * d * f)
    attn = 4 * L * L * d + 4 * L * Lt * d        # self + cross (qk + pv)
    pt, ph, pw = cfg.patch_size
    head = 2 * L * d * (pt * ph * pw * cfg.out_dim)
    embed = 2 * L * (cfg.in_dim * pt * ph * pw) * d
    return cfg.num_layers * (per_block + attn) + head + embed
