"""Tracing instrumentation.

Counterpart of `videocof_tpu/utils/profiling.py`: a trace context, the
program's spans and the analytic FLOPs of a Wan DiT forward that MFU is
reported against. JAX's ``xla_trace`` captures an XLA profiler trace; here
the context is ``torch_trace`` over ``torch.profiler`` (a Chrome trace file
for chrome://tracing or Perfetto, the CUDA activity included on a card).

``span(name)`` marks a piece of the program on that trace: while a
profiler records it is a ``record_function`` range (a ``user_annotation``
event on the host's timeline, beside the kernels it launched, on the same
clock, nested in the span that encloses it on the calling thread); with no
profiler in the process it costs one flag check and records nothing. The
flag is the process's, so a span on another thread (a server's request)
reaches a profiler that records all threads. The profiler keeps the spans
and writes them with its trace; this module keeps none.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` on a recording profiler's timeline;
    the shared no-op context when no profiler is on (no allocation, no
    device synchronisation)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner

    return wrap


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
