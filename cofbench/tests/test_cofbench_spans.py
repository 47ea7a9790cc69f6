"""The reader of the program's spans (`cofbench/spans.py`) on hand-written
traces: parents by nesting, kernels by launch, idle time inside a span, gap
labels by the innermost span of either prefix, and the numbers read from
them; the program's spans added to a trace leave the benchmark's reader
(`trace.read_events`) and every per-layer metric as they were; and a traced
CPU run of the tiny cell, which has spans but no device kernels, reads None
for each number."""

from __future__ import annotations

import json

import pytest

from cofbench import spans
from cofbench.trace import read_events

W = (0, 1000)


def ann(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def kernel(corr, name, launch, ts, dur):
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
             "dur": 1, "args": {"correlation": corr}},
            {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
             "args": {"correlation": corr}}]


def harness_events():
    """One edit in the harness's spans: the DiT's kernels in ``cof.dit``,
    a VAE kernel in ``cof.vae_decode``, a copy after it."""
    ev = [ann("cof.window", 0, 1000), ann("cof.edit", 100, 795),
          ann("cof.dit", 200, 300), ann("cof.vae_decode", 600, 100)]
    ev += kernel(1, "flash_fwd_kernel", 210, 220, 100)
    ev += kernel(2, "nvjet_tst_x", 260, 320, 80)
    ev += kernel(3, "elementwise_kernel", 400, 400, 50)
    ev += kernel(4, "sm80_xmma_fprop_implicit_gemm", 610, 620, 60)
    ev.append({"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 750,
               "dur": 50})
    return ev


def program_events():
    """The program's spans of the same edit: the call, a step with one
    block (around the first two kernels) and the head, the RoPE tables
    built on the host, the VAE's decode and the frames' host copy."""
    return [ann("videocof.edit", 105, 785), ann("videocof.step", 190, 320),
            ann("videocof.dit", 205, 290), ann("videocof.dit.block", 208, 60),
            ann("videocof.rope", 520, 80), ann("videocof.vae_decode", 605, 90),
            ann("videocof.frames_out", 700, 185)]


def test_spans_nest_and_take_the_kernels_launched_inside():
    sp = spans.read_events(harness_events() + program_events(), W)
    names = [s.name for s in sp.spans]
    assert names == ["videocof.edit", "videocof.step", "videocof.dit",
                     "videocof.dit.block", "videocof.rope",
                     "videocof.vae_decode", "videocof.frames_out"]
    parent = {s.name: (None if s.parent is None else names[s.parent])
              for s in sp.spans}
    assert parent == {"videocof.edit": None,
                      "videocof.step": "videocof.edit",
                      "videocof.dit": "videocof.step",
                      "videocof.dit.block": "videocof.dit",
                      "videocof.rope": "videocof.edit",
                      "videocof.vae_decode": "videocof.edit",
                      "videocof.frames_out": "videocof.edit"}
    by = {s.name: s for s in sp.spans}
    assert by["videocof.dit.block"].kernels == [(220, 320), (320, 400)]
    assert by["videocof.dit.block"].busy_us() == 180.0
    assert by["videocof.dit"].busy_us() == 230.0      # the head's too
    assert by["videocof.edit"].busy_us() == 290.0     # copies not kernels
    assert sp.kernels == 4


def test_idle_inside_spans_and_gap_labels():
    sp = spans.read_events(harness_events() + program_events(), W)
    by = {s.name: s for s in sp.spans}
    # the device: busy 220-450, 620-680 and 750-800
    assert by["videocof.edit"].idle_us == (220 - 105) + (620 - 450) + \
        (750 - 680) + (890 - 800)
    assert by["videocof.dit"].idle_us == (220 - 205) + (495 - 450)
    assert by["videocof.rope"].idle_us == 80
    assert by["videocof.frames_out"].idle_us == (750 - 700) + (885 - 800)
    assert by["videocof.dit.block"].idle_us == 220 - 208
    # each gap by the innermost span at its middle, of either prefix: 0-220
    # at 110 in the call, before its first kernel; 450-620 in the RoPE
    # build; 680-750 in the frames' copy; 800-1000 at 900, after the edit
    assert [g[2] for g in sp.gaps] == ["videocof.edit", "videocof.rope",
                                       "videocof.frames_out", "cof.window"]
    assert sp.gap_labels() == {"videocof.edit": 220.0,
                               "videocof.rope": 170.0,
                               "videocof.frames_out": 70.0,
                               "cof.window": 200.0}


def test_numbers_read_from_the_spans():
    sp = spans.read_events(harness_events() + program_events(), W)
    assert spans.call_idle_ms(sp) == pytest.approx(0.445)
    assert spans.dit_block_ms(sp) == pytest.approx(0.180)
    assert spans.vae_device_s(sp) == pytest.approx(60e-6)
    # of the 445 us idle inside the call, the RoPE build's 170 and the
    # copy's 70 lie in gaps labelled below it; 115 before the first kernel
    # (the call's own) and 90 at its end (the window's) do not
    assert spans.below_call_share(sp) == pytest.approx((170 + 70) / 445)


def test_a_program_without_spans_reads_none():
    sp = spans.read_events(harness_events(), W)
    assert sp.spans == [] and sp.kernels == 4
    for number in (spans.call_idle_ms, spans.dit_block_ms,
                   spans.vae_device_s, spans.below_call_share):
        assert number(sp) is None


def _window(events, mix, config):
    from cofbench.families import wan_yardstick as yardstick
    from cofbench.window import Window
    return Window(config, mix, seconds=1e-3, edits=1,
                  timings=[{"text": 0.1, "encode+latents": 0.2,
                            "step0": 0.3, "decode": 0.4}],
                  trace=read_events(events, W),
                  flops=yardstick.edit_flops(config, mix))


def test_program_spans_leave_the_benchmarks_readings_unchanged():
    from cofbench.families.wan_mix import Mix
    from cofbench.run import ROOT, manifest, readers
    config = json.loads((ROOT / "cofbench/configs/wan21-t2v-1.3b.json")
                        .read_text())
    mix = Mix.load(ROOT / "cofbench/traffic/cof_edit.json")
    base = read_events(harness_events(), W)
    added = read_events(harness_events() + program_events(), W)
    assert [k.span for k in added.kernels] == [k.span for k in base.kernels]
    assert added.gaps == base.gaps and added.busy_us == base.busy_us
    man = manifest()
    cell = man["workloads"][0]["name"]
    for m, mod in readers(man, "per_layer", cell):
        a = mod.read(_window(harness_events(), mix, config))
        b = mod.read(_window(harness_events() + program_events(), mix,
                             config))
        assert a == b, m["name"]


def test_traced_cpu_run_reads_none_for_the_device_numbers(checkout):
    from cofbench import span_report
    from cofbench.tests import tiny
    root, _ = checkout
    man = json.loads((root / "BENCHMARK.json").read_text())
    out = span_report.report(man, tiny.CELL, 3000000019, 0.1, 2, "cpu",
                             root=root)
    row, odd = out["rounds"]
    assert row["spans"] == {"call_idle_ms": None, "dit_block_ms": None,
                            "vae_device_s": None, "below_call_share": None}
    names = row["span_names"]
    assert names["videocof.edit"]["count"] == 1.0
    assert names["videocof.dit.block"]["count"] == \
        tiny.DIT["num_layers"] * tiny.mix().steps
    assert row["traced_spans_off_edit_s"] > 0
    assert odd["traced_spans_off_edit_s"] > 0
    assert out["span_cost_us"]["off"] < out["span_cost_us"]["on"]
