"""The port's profiling utilities (`utils/profiling.py`): `dit_matmul_flops`
equal to the JAX package's for the Wan2.1 1.3B and 14B at the edit's 29,640
and the 4x edit's 107,640 tokens, the trace context writing a Chrome trace,
and the program's spans: free with no profiler recording (no
`record_function`, no synchronisation), nested `user_annotation` events
under one (a span on another thread too, under a profiler of all threads),
the span sites of a tiny chain-of-frames edit (the block spans under
checkpointing too), and an edit whose frames, latents and stage walls are
the same with the profiler on and off."""

import json
import math
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videocof_torch import configs
from videocof_torch.models.t5_encoder import init_t5_encoder
from videocof_torch.models.wan_dit import init_wan_dit
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline
from videocof_torch.utils import profiling

torch.set_num_threads(1)

STEPS = 2
# the DiT over the tiny VAE's 4 latent channels
DIT = configs.WAN_TINY.replace(in_dim=4, out_dim=4)
EDIT_SPANS = {"videocof.edit", "videocof.video_in", "videocof.text",
              "videocof.tokenize", "videocof.latents", "videocof.vae_encode",
              "videocof.rope", "videocof.schedule", "videocof.step",
              "videocof.dit", "videocof.dit.block", "videocof.sampler",
              "videocof.vae_decode", "videocof.frames_out"}


@pytest.mark.parametrize("tokens", [29_640, 107_640])
@pytest.mark.parametrize("name", ["WAN21_T2V_1_3B", "WAN21_T2V_14B"])
def test_dit_matmul_flops_matches_jax(name, tokens):
    from videocof_tpu import configs as jconfigs
    from videocof_tpu.utils import profiling as jprof
    want = jprof.dit_matmul_flops(getattr(jconfigs, name), tokens)
    assert profiling.dit_matmul_flops(getattr(configs, name), tokens) == want
    assert profiling.dit_matmul_flops(getattr(configs, name), tokens,
                                      text_len=226) == \
        jprof.dit_matmul_flops(getattr(jconfigs, name), tokens, text_len=226)


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path), "t.json") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    trace = json.loads((tmp_path / "t.json").read_text())
    assert trace["traceEvents"]


def test_span_without_a_profiler_records_and_synchronises_nothing(
        monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))

    @profiling.spanned("t.fn")
    def f(x):
        return x + 1

    with profiling.span("t.outer"):
        with profiling.span("t.inner"):
            assert f(1) == 2
    assert calls == []
    # one shared context, whatever the name
    assert profiling.span("t.a") is profiling.span("t.b")


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [ev for ev in events if ev.get("cat") == "user_annotation"]


def test_nested_spans_are_nested_annotations(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                torch.ones(8) * 2
            with profiling.span("t.inner"):
                torch.ones(8) + 2
    ann = _annotations(prof, tmp_path)
    outer = [ev for ev in ann if ev["name"] == "t.outer"]
    inner = [ev for ev in ann if ev["name"] == "t.inner"]
    assert len(outer) == 1 and len(inner) == 2
    o = outer[0]
    for ev in inner:
        assert o["ts"] <= ev["ts"] and \
            ev["ts"] + ev["dur"] <= o["ts"] + o["dur"]
    a, b = sorted(inner, key=lambda ev: ev["ts"])
    assert a["ts"] + a["dur"] <= b["ts"]


def _tiny_pipeline():
    gen = torch.Generator().manual_seed(0)
    dit = init_wan_dit(DIT, gen)
    t5 = init_t5_encoder(configs.T5_TINY.replace(dim=DIT.text_dim), gen)
    vae = WanVAE(configs.VAE_TINY)
    with torch.no_grad():
        for p in vae.parameters():
            if p.dim() > 1:
                bound = 1.0 / math.sqrt(p[0].numel())
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=gen))
            else:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
    return WanPipeline(dit, vae, t5, dtype=torch.float32, device="cpu")


def _edit(pipe, timings=None):
    video = torch.randint(0, 256, (1, 3, 5, 32, 32),
                          generator=torch.Generator().manual_seed(1),
                          dtype=torch.uint8)
    return pipe(video, "remove the ball", source_frames=5,
                reasoning_frames=4, num_inference_steps=STEPS, cot=True,
                repeat_rope=True, max_sequence_length=16, seed=3,
                output_latents=True, timings=timings)


@pytest.fixture(scope="module")
def traced_edit(tmp_path_factory):
    """A tiny edit traced on the CPU, the same edit untraced: (the traced
    run's annotations, its output and stage walls, the untraced output and
    stage walls, the pipeline)."""
    pipe = _tiny_pipeline()
    plain_t = {}
    plain = _edit(pipe, plain_t)
    traced_t = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _edit(pipe, traced_t)
    ann = _annotations(prof, tmp_path_factory.mktemp("trace"))
    return ann, (traced, traced_t), (plain, plain_t), pipe


def test_edit_records_each_span_site(traced_edit):
    ann, _, _, pipe = traced_edit
    names = [ev["name"] for ev in ann]
    assert EDIT_SPANS <= set(names)
    count = {n: names.count(n) for n in EDIT_SPANS}
    assert count["videocof.edit"] == 1
    assert count["videocof.step"] == count["videocof.dit"] == \
        count["videocof.sampler"] == STEPS
    assert count["videocof.dit.block"] == \
        pipe.dit.cfg.num_layers * STEPS
    assert count["videocof.vae_decode"] == 2     # ground, then edit
    assert count["videocof.vae_encode"] == count["videocof.latents"] == 1
    # every program span lies inside the edit's
    edit = next(ev for ev in ann if ev["name"] == "videocof.edit")
    for ev in ann:
        if ev["name"] in EDIT_SPANS:
            assert edit["ts"] <= ev["ts"] and \
                ev["ts"] + ev["dur"] <= edit["ts"] + edit["dur"]


def test_block_spans_nest_in_steps(traced_edit):
    ann, _, _, pipe = traced_edit
    steps = [ev for ev in ann if ev["name"] == "videocof.step"]
    blocks = [ev for ev in ann if ev["name"] == "videocof.dit.block"]
    for s in steps:
        inside = [b for b in blocks if s["ts"] <= b["ts"]
                  and b["ts"] + b["dur"] <= s["ts"] + s["dur"]]
        assert len(inside) == pipe.dit.cfg.num_layers


def test_profiler_leaves_the_edit_bit_identical(traced_edit):
    _, (traced, _), (plain, _), _ = traced_edit
    assert np.array_equal(traced.videos, plain.videos)
    assert np.array_equal(traced.latents, plain.latents)


def test_timings_keep_their_keys_under_the_profiler(traced_edit):
    _, (_, traced_t), (_, plain_t), _ = traced_edit
    want = ["text", "encode+latents"] + [f"step{i}" for i in range(STEPS)] \
        + ["decode"]
    assert list(traced_t) == list(plain_t) == want


def test_block_spans_show_checkpoint_recomputation(tmp_path):
    cfg = configs.WAN_TINY
    dit = init_wan_dit(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, cfg.in_dim, 2, 4, 4, generator=gen)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen)
    cos = torch.ones(8, cfg.head_dim // 2)
    sin = torch.zeros(8, cfg.head_dim // 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = dit(x, torch.tensor([500.0]), ctx, cos, sin, remat_blocks=True)
        out.square().mean().backward()
    names = [ev["name"] for ev in _annotations(prof, tmp_path)]
    # each block once in the forward and once recomputed in the backward
    assert names.count("videocof.dit.block") == 2 * cfg.num_layers


def test_span_on_another_thread_reaches_a_profiler_of_all_threads(tmp_path):
    from torch._C._profiler import _ExperimentalConfig

    def request():
        with profiling.span("t.request"):
            torch.ones(8) * 2
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        worker = threading.Thread(target=request)
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    assert [ev["name"] for ev in _annotations(prof, tmp_path)] == [
        "t.request"]
