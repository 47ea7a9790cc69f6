"""The plain reference held against the program (`videocof_torch`) on the
CPU at its test presets' sizes, both in float32 on the same drawn weights:
the tokenizer, umT5, the VAE's encode and decode, the DiT (LoRA merged,
repeat-RoPE, RIFLEx), Flow-UniPC and a whole edit; the streamed reference
VAE against the whole-clip one; and the one-step check's capture against
what the program's DiT took. The test imports both; the reference imports
nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cofbench.families import wan_layouts as inputs
from cofbench.families import wan_layouts as layouts
from cofbench.families import wan_program as program
from cofbench.reference import dit, edit, rope, t5, tokenizer, unipc, vae
from cofbench.tests import tiny

F32 = torch.float32
SEED = 4100000007


@pytest.fixture(scope="module")
def weights():
    cfg = tiny.CONFIG
    return {"dit": inputs.dit_weights(cfg, SEED, "cpu", F32),
            "vae": inputs.vae_weights(cfg, SEED, "cpu", F32),
            "t5": inputs.t5_weights(cfg, SEED, "cpu", F32),
            "lora": inputs.lora_files(cfg, SEED, "cpu", F32)}


@pytest.fixture(scope="module")
def pipe(weights):
    w = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
         else [({n: t.clone() for n, t in sd.items()}, m) for sd, m in v]
         for k, v in weights.items()}
    return program.build(tiny.CONFIG, w["dit"], w["vae"], w["t5"], w["lora"],
                         "cpu", dtype=F32)


def test_tokenizer_is_the_programs_fallback():
    from videocof_torch.data.tokenizer import WanTokenizer
    text = "Remove the Man in the red jacket from the video."
    want = WanTokenizer(vocab_size=128)([text], max_length=16)
    got = tokenizer.tokenize(text, 16, 128)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_t5(weights, pipe):
    ids, mask = (torch.as_tensor(a) for a in tokenizer.tokenize(
        "add a red fox in the background", 16, tiny.T5["vocab"]))
    want = pipe.t5(ids, mask)
    got = t5.encode(weights["t5"], tiny.T5, ids, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_vae_encode_and_decode(weights, pipe):
    W = vae.Weights(weights["vae"], "cpu")
    gen = torch.Generator().manual_seed(1)
    clip = torch.rand(1, 3, 9, 32, 32, generator=gen) * 2 - 1
    torch.testing.assert_close(vae.encode(W, tiny.VAE, clip),
                               pipe.vae.encode(clip)[0], rtol=1e-4,
                               atol=1e-5)
    z = torch.randn(1, 4, 3, 4, 4, generator=gen)
    torch.testing.assert_close(vae.decode(W, tiny.VAE, z),
                               pipe.vae.decode(z), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("riflex_k", [None, 2])
def test_dit_with_lora_and_repeat_rope(weights, pipe, riflex_k):
    from videocof_torch.models.rope import riflex_angle_table
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    cfg = tiny.DIT
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, cfg["in_dim"], 5, 4, 4, generator=gen)
    ctx = torch.randn(1, cfg["text_len"], cfg["text_dim"], generator=gen)
    grid, head = (5, 2, 2), cfg["dim"] // cfg["num_heads"]
    table = riflex_angle_table(head, riflex_k, 66) if riflex_k else None
    cos, sin = (torch.as_tensor(a) for a in make_rope_for_geometry(
        pipe.dit.cfg, grid, f_src=2, f_ground=1, temporal_table=table))
    want = pipe.dit(x, torch.tensor([937.0]), ctx, cos, sin,
                    attn_backend="naive")
    D = dit.Weights(weights["dit"], dit.lora_deltas(weights["lora"],
                                                    cfg["num_layers"]), "cpu")
    got = dit.forward(D, cfg, x, 937.0, ctx,
                      rope.rope_table(grid, head, 2, 1, riflex_k))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_lora_deltas_cover_every_adapted_linear(weights):
    deltas = dit.lora_deltas(weights["lora"], tiny.DIT["num_layers"])
    names = {n for n, _, _ in layouts.lora_modules(tiny.DIT)}
    assert set(deltas) == names
    assert all([s for _, _, s in deltas[n]] == [2.0 / 4, 0.5] for n in names)


@pytest.mark.parametrize("steps,shift", [(4, 3.0), (1, 3.0), (6, 5.0)])
def test_unipc(steps, shift):
    from videocof_torch.schedulers import get_scheduler
    gen = torch.Generator().manual_seed(3)
    sched = get_scheduler("unipc")
    sched.set_timesteps(steps, shift=shift)
    np.testing.assert_array_equal(unipc.timesteps(steps, shift),
                                  sched.timesteps)
    state, ref = sched.init_state(torch.zeros(2, 3)), unipc.UniPC(steps, shift)
    xa = xb = torch.randn(2, 3, generator=gen)
    for i in range(steps):
        v = torch.randn(2, 3, generator=gen)
        xa, state = sched.step(v, i, xa, state)
        xb = ref.step(v, i, xb)
    torch.testing.assert_close(xb, xa, rtol=1e-6, atol=1e-6)


def test_temporal_positions_restart_per_segment():
    assert rope.temporal_positions(7, 3, 1).tolist() == [1, 2, 3, 0, 1, 2, 3]
    assert rope.temporal_positions(4, None, 0).tolist() == [0, 1, 2, 3]


def test_whole_edit_against_the_program(pipe):
    mix = tiny.mix()
    e = mix.edit(SEED, 3, tiny.VAE["z_dim"], "cpu")
    frames, latents = program.edit(pipe, mix, e)
    ref_frames, ref_latents = edit.run(tiny.CONFIG, mix, SEED, 3, "cpu",
                                       served_dtype=F32)
    got = np.rint(frames * 255.0)
    assert got.shape == tuple(ref_frames.shape)
    # the same arithmetic in another order: at most one level, rarely
    diff = np.abs(got - ref_frames.numpy())
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(latents, ref_latents.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_stage_products_of_a_float32_program_match(pipe):
    from cofbench.families import wan as check
    mix = tiny.mix()
    kept = program.keep_text(pipe)
    e = mix.edit(SEED, 4, tiny.VAE["z_dim"], "cpu")
    frames, latents = program.edit(pipe, mix, e)
    ref = edit.check_products(tiny.CONFIG, mix, SEED, 4, kept[-1], latents,
                              "cpu", served_dtype=F32, whole=True)
    got = check.numbers({"frames": frames, "latents": latents,
                         "context": kept[-1]}, ref, mix.latent_grid()[0])
    assert max(got["text_rel_l2"], got["source_rel_l2"],
               got["latent_rel_l2"], got["edit_rel_l2"]) < 1e-5, got
    assert got["frame_rms"] < 0.05, got


@pytest.mark.parametrize("frames", [1, 5, 9, 13])
def test_streamed_vae_equals_the_whole_clip(weights, frames):
    from cofbench.check import rel
    W = vae.Weights(weights["vae"], "cpu")
    gen = torch.Generator().manual_seed(frames)
    clip = torch.rand(1, 3, frames, 32, 32, generator=gen) * 2 - 1
    assert rel(vae.encode(W, tiny.VAE, clip, streamed=True),
               vae.encode(W, tiny.VAE, clip)) <= 1e-5
    z = torch.randn(1, 4, (frames - 1) // 4 + 1, 4, 4, generator=gen)
    assert rel(vae.decode(W, tiny.VAE, z, streamed=True),
               vae.decode(W, tiny.VAE, z)) <= 1e-5


def test_the_kept_step_is_what_the_dit_took_and_reads_zero_in_float32():
    from cofbench.families import wan
    mix = tiny.mix(**tiny.STEP_MIX)
    s = wan.system(tiny.CONFIG, SEED, "cpu", F32)
    real, seen = s.pipe.dit.forward_with_residual, []

    def spy(x, t, context, *args, **kw):
        out = real(x, t, context, *args, **kw)
        seen.append((x.clone(), t.clone(), context.clone(), out[0].clone()))
        return out
    s.pipe.dit.forward_with_residual = spy
    wan.instrument(s, tiny.CONFIG, mix, SEED, tiny.STEP_LIMITS)
    out = wan.unit(s, tiny.CONFIG, mix, SEED, 2, "cpu")
    calls = out["dit"]
    assert len(seen) == len(calls["velocity"]) == mix.steps
    x, t, context, v = seen[calls["keep"]]
    for got, want in zip((calls["inputs"][k] for k in ("x", "t", "context")),
                         (x, t, context)):
        assert torch.equal(got, want)
    for got, (_, _, _, want) in zip(calls["velocity"], seen):
        assert torch.equal(got, want)
    found = wan.check(tiny.CONFIG, mix, SEED, 2, out, "cpu", F32,
                      tiny.STEP_LIMITS)
    assert set(found) == set(tiny.STEP_LIMITS)
    assert max(v for k, v in found.items() if k != "frame_rms") < 1e-5, found
    assert found["frame_rms"] < 0.05, found
