"""The program's spans in a traced window of a cell, beside untraced ones:

    python3 cofbench/span_report.py --workload <cell> --seed <n>
                                    --seconds <s> [--rounds <r>]

The pipeline is built and warmed up as `run.py` builds it. Each round then
runs three windows of ``--seconds`` (every edit begun inside one is
finished): untraced; traced as ``run.py --trace 1`` traces (the harness's
``cof.*`` spans, the stage walls taken); and traced with the program's spans
off (where the program has them), for their cost, before the traced one in
odd rounds and after it in even ones. The traced window's
events, exported once, are reduced by `cofbench.spans` (the program's spans,
their kernels and idle time, the idle gaps by innermost span) and by
`trace.read_events` (the benchmark's per-layer readers). The last line of
standard output is JSON. It checks nothing against the reference: it
reports time, not correctness."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import types
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def export_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one enter and exit of `span`, with no profiler
    recording and under one; None where the program has no spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        from videocof_torch.utils.profiling import span
    except ImportError:
        return {"off": None, "on": None}

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with span("videocof.cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6
    off = loop()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on = loop()
    return {"off": off, "on": on}


def program_spans_off():
    """Turn the program's spans off (their flag reads no profiler); returns
    the undo, or None where the program has no spans."""
    try:
        from videocof_torch.utils import profiling
        real = profiling._autograd_profiler
    except (ImportError, AttributeError):
        return None
    profiling._autograd_profiler = types.SimpleNamespace(
        _is_profiler_enabled=False)
    return lambda: setattr(profiling, "_autograd_profiler", real)


def summary(sp, edits: int) -> dict:
    """Each program span name: its count, and the device-busy and idle
    seconds inside it, an edit (a span's own with its children's)."""
    out = {}
    for s in sp.spans:
        row = out.setdefault(s.name, {"count": 0, "busy_s": 0.0,
                                      "idle_s": 0.0})
        row["count"] += 1
        row["busy_s"] += s.busy_us() / 1e6
        row["idle_s"] += s.idle_us / 1e6
    return {name: {k: v / edits for k, v in row.items()}
            for name, row in out.items()}


def report(man: dict, cell: str, seed: int, seconds: float, rounds: int,
           device, root: Path = ROOT) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cofbench import check, families, run, spans, trace
    from cofbench.window import Window, closed_loop
    work, config, mix = run.cell_files(man, cell, root)
    fam = families.load(config["family"], root)
    dtype = getattr(torch, run.DTYPES[config["precision"]])
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    system = fam.system(config, seed, device, dtype)
    fam.warm_up(system, config, mix, seed, device)
    fam.instrument(system, config, mix, seed, check.limits(cell, root))
    out = {"cell": cell, "seed": seed, "setup_s": time.perf_counter() - T0,
           "span_cost_us": span_cost_us(), "rounds": []}
    count = [0]

    def one(i, timings):
        fam.unit(system, config, mix, seed, count[0], device, timings)
        count[0] += 1

    def traced_window():
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("cof.window"):
                outs, timings, secs = closed_loop(one, seconds, True, sync)
        return prof, outs, timings, secs

    def spans_off_edit_s():
        undo = program_spans_off()
        if undo is None:
            return None
        try:
            _, outs, _, secs = traced_window()
        finally:
            undo()
        return secs / len(outs)

    for r in range(rounds):
        row = {}
        outs, _, secs = closed_loop(one, seconds, False, sync)
        row["untraced_edit_s"] = secs / len(outs)
        if r == 0:
            fam.trace_spans(system)
        if r % 2:
            row["traced_spans_off_edit_s"] = spans_off_edit_s()
        prof, outs, timings, secs = traced_window()
        row["traced_edit_s"] = secs / len(outs)
        t = time.perf_counter()
        events = export_events(prof)
        del prof
        mark = next(ev for ev in events if ev.get("cat") ==
                    "user_annotation" and ev.get("name") == "cof.window")
        window = (mark["ts"], mark["ts"] + mark["dur"])
        tr = trace.read_events(events, window)
        sp = spans.read_events(events, window)
        del events
        row["export_and_read_s"] = time.perf_counter() - t
        w = Window(config, mix, seconds=secs, edits=len(outs),
                   timings=timings, trace=tr,
                   flops=fam.unit_flops(config, mix), root=root)
        row["edits"] = w.edits
        row["busy_s"] = tr.busy_us / 1e6
        row["window_s"] = tr.window_us / 1e6
        row["per_layer"] = {m["name"]: mod.read(w) for m, mod in
                            run.readers(man, "per_layer", cell, root)}
        row["spans"] = {
            "call_idle_ms": spans.call_idle_ms(sp),
            "dit_block_ms": spans.dit_block_ms(sp),
            "vae_device_s": spans.vae_device_s(sp),
            "below_call_share": spans.below_call_share(sp)}
        row["span_names"] = summary(sp, w.edits)
        row["idle_gaps_s"] = sorted(
            ((k, v / 1e6) for k, v in sp.gap_labels().items()),
            key=lambda kv: -kv[1])
        row["harness_idle_gaps_s"] = tr.top_gaps(20)
        if not r % 2:
            row["traced_spans_off_edit_s"] = spans_off_edit_s()
        out["rounds"].append(row)
        print(f"span_report: round {r}: {json.dumps(row)[:400]}",
              file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    os.environ.pop("VIDEOCOF_ATTENTION_TYPE", None)
    os.environ.pop("VIDEOCOF_TIMING", None)
    import torch

    from cofbench import run
    if not torch.cuda.is_available():
        print("span_report: no CUDA device; no result", file=sys.stderr)
        return 3
    print(f"span_report: card {run.card_note()}", file=sys.stderr,
          flush=True)
    out = report(run.manifest(), args.workload, args.seed, args.seconds,
                 args.rounds, torch.device("cuda"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
