"""The program's own spans in a traced run: the ``videocof.*`` ranges that
`videocof_torch.utils.profiling.span` records on `torch.profiler`'s
timeline, reduced from the exported Chrome-trace events (the events
`trace.read_profile` reads) on the trace's clock.

Each span keeps its extent, its parent (the innermost program span that
holds it), the device kernels whose launch (the `cuda_runtime` event of the
kernel's correlation, as `trace.read_events` takes it) falls inside it, and
the device's idle time inside it. The device is busy where a kernel, copy
or memset runs, as `trace.py` takes it. `gap_labels` names each idle gap
of the window by the innermost span, the program's or the harness's, that
the host was in at the gap's middle: what the device waited on.

`call_idle_ms`, `dit_block_ms` and `vae_device_s` are the per-layer numbers
these spans give; each is None where the run holds no device kernel (a CPU
run) or no such span (a program without spans)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from cofbench.trace import SPAN_PREFIX, union_us

PREFIX = "videocof."
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Span:
    name: str
    start_us: float
    end_us: float
    parent: Optional[int] = None     # index of the enclosing program span
    kernels: List[Tuple[float, float]] = field(default_factory=list)
    idle_us: float = 0.0             # device idle inside, in the window

    def busy_us(self) -> float:
        """The union of the kernels launched inside it."""
        return union_us(self.kernels)


@dataclass
class Spans:
    spans: List[Span]
    kernels: int                     # device kernels in the window
    # the window's idle gaps (start, end, the innermost span at the middle)
    gaps: List[Tuple[float, float, str]]

    def named(self, *names) -> List[Span]:
        return [s for s in self.spans if s.name in names]

    def gap_labels(self) -> Dict[str, float]:
        """Idle microseconds by the innermost span of each gap."""
        table: Dict[str, float] = {}
        for lo, hi, label in self.gaps:
            table[label] = table.get(label, 0.0) + (hi - lo)
        return table


def _idle_gaps(events, w0: float, w1: float) -> List[Tuple[float, float]]:
    busy = sorted((max(ev["ts"], w0), min(ev["ts"] + ev["dur"], w1))
                  for ev in events if ev.get("cat") in DEVICE
                  and ev["ts"] + ev["dur"] >= w0 and ev["ts"] <= w1)
    gaps, end = [], w0
    for lo, hi in busy:
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def _innermost(ranges, points) -> List[Optional[int]]:
    """For each of the sorted ``points``, the index of the innermost of the
    nested ``ranges`` (start, end, ...), sorted by start, that holds it."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and ranges[stack[-1]][1] < ranges[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def read_events(events, window: Tuple[float, float]) -> Spans:
    """Reduce Chrome-trace events to the program's spans that meet
    ``window`` (start, end, in the trace's microseconds)."""
    w0, w1 = window
    marks, launches = [], {}
    for ev in events:
        cat, name = ev.get("cat"), ev.get("name", "")
        if cat == "user_annotation" and name.startswith(
                (PREFIX, SPAN_PREFIX)):
            lo, hi = ev["ts"], ev["ts"] + ev["dur"]
            if hi >= w0 and lo <= w1:
                marks.append((lo, hi, name))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ev["ts"]
    # outer before inner where two start together
    marks.sort(key=lambda m: (m[0], -m[1]))
    kernels = sorted(
        (launches[c], ev["ts"], ev["dur"]) for ev in events
        if ev.get("cat") == "kernel" and ev["ts"] + ev["dur"] >= w0
        and ev["ts"] <= w1
        and (c := ev.get("args", {}).get("correlation")) in launches)
    launch_ts = [k[0] for k in kernels]
    gaps = _idle_gaps(events, w0, w1)
    gap_lo = [g[0] for g in gaps]
    idle_before = [0.0]
    for lo, hi in gaps:
        idle_before.append(idle_before[-1] + hi - lo)

    def idle_in(lo, hi):
        lo, hi = max(lo, w0), min(hi, w1)
        if hi <= lo:
            return 0.0
        a = max(bisect.bisect_right(gap_lo, lo) - 1, 0)
        b = bisect.bisect_left(gap_lo, hi)
        total = idle_before[b] - idle_before[a]
        if gaps and gaps[a][0] < lo:
            total -= min(gaps[a][1], lo) - gaps[a][0]
        if b > a and gaps[b - 1][1] > hi:
            total -= gaps[b - 1][1] - max(gaps[b - 1][0], hi)
        return total

    program = [m for m in marks if m[2].startswith(PREFIX)]
    spans, stack = [], []
    for i, (lo, hi, name) in enumerate(program):
        while stack and program[stack[-1]][1] < hi:
            stack.pop()
        a, b = (bisect.bisect_left(launch_ts, lo),
                bisect.bisect_right(launch_ts, hi))
        spans.append(Span(name, lo, hi, stack[-1] if stack else None,
                          [(k[1], k[1] + k[2]) for k in kernels[a:b]],
                          idle_in(lo, hi)))
        stack.append(i)
    labels = _innermost(marks, [0.5 * (lo + hi) for lo, hi in gaps])
    return Spans(spans, len(kernels), [
        (lo, hi, "outside the spans" if j is None else marks[j][2])
        for (lo, hi), j in zip(gaps, labels)])


def call_idle_ms(s: Spans) -> Optional[float]:
    """Device idle milliseconds inside the program's call, an edit: the
    idle time inside each ``videocof.edit`` span (clipped to the window),
    averaged over them."""
    edits = s.named("videocof.edit")
    if not s.kernels or not edits:
        return None
    return sum(e.idle_us for e in edits) / 1e3 / len(edits)


def dit_block_ms(s: Spans) -> Optional[float]:
    """Device-busy milliseconds of the kernels launched inside a DiT block
    span, averaged over the block spans."""
    blocks = s.named("videocof.dit.block")
    if not s.kernels or not blocks:
        return None
    return sum(b.busy_us() for b in blocks) / 1e3 / len(blocks)


def vae_device_s(s: Spans) -> Optional[float]:
    """Device-busy seconds of the kernels launched inside the VAE's encode
    and decode spans, an edit (the edits counted by their spans)."""
    edits = s.named("videocof.edit")
    vae = s.named("videocof.vae_encode", "videocof.vae_decode")
    if not s.kernels or not edits or not vae:
        return None
    return sum(v.busy_us() for v in vae) / 1e6 / len(edits)


def below_call_share(s: Spans) -> Optional[float]:
    """The share of the device's idle time inside the ``videocof.edit``
    spans that lies in gaps labelled by a program span below them (not by
    the edit's own span, nor by a harness span)."""
    edits = s.named("videocof.edit")
    inside = sum(e.idle_us for e in edits)
    if not s.kernels or inside <= 0.0:
        return None
    below = sum(max(0.0, min(hi, e.end_us) - max(lo, e.start_us))
                for lo, hi, label in s.gaps
                if label.startswith(PREFIX) and label != "videocof.edit"
                for e in edits)
    return below / inside
