"""The profiler reader: a `torch.profiler` trace of the measured window,
reduced to device kernels (each with the harness span its launch fell in),
the union of the device's busy intervals (kernels, copies and memsets, as
`chip_smoke.profile_kernels` takes it), the idle gaps named by what the
host was doing, and the kernel classes the per-layer metrics sum over."""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "cof."
# the port's attention kernels (B1 forward and its LSE variant, B4 and its
# K pre-pass), as their names appear in the trace
ATTENTION_KERNELS = ("flash_fwd_kernel", "int8_attn_kernel",
                     "k_prepass_kernel")
# cuDNN's convolutions (checked first: some are CUTLASS kernels), then the
# cuBLAS and CUTLASS matrix products
CONV_MARKS = ("implicit_gemm", "implicit_convolve", "fprop", "dgrad",
              "wgrad", "winograd", "cudnn", "conv2d", "conv3d", "convolve")
GEMM_MARKS = ("gemm", "nvjet", "cutlass")


def kernel_class(name: str) -> str:
    """"attention", "gemm", "conv" or "other"."""
    if any(k in name for k in ATTENTION_KERNELS):
        return "attention"
    low = name.lower()
    if any(k in low for k in CONV_MARKS):
        return "conv"
    if any(k in low for k in GEMM_MARKS):
        return "gemm"
    return "other"


@dataclass
class Kernel:
    name: str
    start_us: float
    dur_us: float
    span: Optional[str]

    @property
    def cls(self) -> str:
        return kernel_class(self.name)


@dataclass
class Trace:
    kernels: List[Kernel]
    busy_us: float
    window_us: float
    gaps: Dict[str, float] = field(default_factory=dict)   # label -> us

    def device_us(self, cls: Optional[str] = None,
                  span: Optional[str] = None) -> float:
        return sum(k.dur_us for k in self.kernels
                   if (cls is None or k.cls == cls)
                   and (span is None or k.span == span))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for k in self.kernels:
            by[k.name] = by.get(k.name, 0.0) + k.dur_us
        return [(name[:160], us / 1e6) for name, us in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        return [(label, us / 1e6) for label, us in
                sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]]


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def _innermost(spans, t):
    """The shortest span (lo, hi, name) holding host time t."""
    best = None
    for lo, hi, name in spans:
        if lo <= t <= hi and (best is None or hi - lo < best[1] - best[0]):
            best = (lo, hi, name)
    return best[2] if best else None


def read_events(events, window: Tuple[float, float]) -> Trace:
    """Reduce Chrome-trace events to a `Trace`; ``window`` is the measured
    window's (start, end) on the trace's clock in microseconds."""
    w0, w1 = window
    spans, launches, kernels, busy = [], {}, [], []
    for ev in events:
        cat, name = ev.get("cat"), ev.get("name", "")
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((ev["ts"], ev["ts"] + ev["dur"], name))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ev["ts"]
    spans.sort()
    for ev in events:
        cat = ev.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        lo, hi = ev["ts"], ev["ts"] + ev["dur"]
        if hi < w0 or lo > w1:
            continue
        busy.append((max(lo, w0), min(hi, w1)))
        if cat == "kernel":
            t = launches.get(ev.get("args", {}).get("correlation"))
            kernels.append(Kernel(ev["name"], lo, ev["dur"],
                                  None if t is None else
                                  _innermost(spans, t)))
    trace = Trace(kernels, union_us(busy), w1 - w0)
    # idle gaps on the device, each named by the host span at its middle
    end, merged = w0, []
    for lo, hi in sorted(busy):
        if lo > end:
            merged.append((end, lo))
        end = max(end, hi)
    if w1 > end:
        merged.append((end, w1))
    for lo, hi in merged:
        label = _innermost(spans, 0.5 * (lo + hi)) or "outside the spans"
        trace.gaps[label] = trace.gaps.get(label, 0.0) + (hi - lo)
    return trace


def read_profile(prof, window_label: str = "cof.window") -> Trace:
    """Export ``prof``'s Chrome trace to a temporary file, read it, delete
    it. The window is the ``window_label`` span's extent."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    marks = [ev for ev in events if ev.get("cat") == "user_annotation"
             and ev.get("name") == window_label]
    if not marks:
        raise RuntimeError(f"the trace holds no {window_label!r} span")
    w = marks[0]
    return read_events(events, (w["ts"], w["ts"] + w["dur"]))
