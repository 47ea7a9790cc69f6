"""The measured window: a closed loop of one client sending edits back to
back. Every edit that starts before ``seconds`` have passed is finished
and counted; the window runs from its start to the end of the last one."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

from .trace import Trace

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Window:
    """What the metric readers (`cofbench/metrics/<name>.py`) read; they
    reach the model through ``family``, found by the configuration's
    ``family`` under the checkout ``root``."""
    config: dict
    mix: object
    seconds: float = 0.0
    edits: int = 0
    timings: List[dict] = field(default_factory=list)
    trace: Optional[Trace] = None
    setup_s: float = 0.0
    peak_bytes: int = 0
    flops: dict = field(default_factory=dict)    # one edit's, by layer
    root: Path = ROOT

    @property
    def family(self):
        from cofbench import families
        return families.load(self.config["family"], self.root)


def closed_loop(edit: Callable[[int, Optional[dict]], object],
                seconds: float, timed: bool, sync: Callable[[], None]):
    """Run ``edit(i, timings)`` for i = 0, 1, ... while the window is
    younger than ``seconds`` at an edit's start. Returns (outputs, the
    per-edit stage walls when ``timed``, the window's seconds)."""
    outputs, timings = [], []
    sync()
    t0 = time.perf_counter()
    while not outputs or time.perf_counter() - t0 < seconds:
        stages = {} if timed else None
        outputs.append(edit(len(outputs), stages))
        if timed:
            timings.append(stages)
    sync()
    return outputs, timings, time.perf_counter() - t0
