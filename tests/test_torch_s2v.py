"""Speech-to-video in the port against the JAX package on the CPU: the
per-sample RoPE, the segment-modulated block, the audio injection (naive at
head_dim 24, the flash backend's plain version at 128), `wan_s2v_forward`
and `speech_to_video`, with the same weights (carried by
`videocof_torch.convert`), audio features and noise; and the runtime LoRA
adapters the port's forward fuses into each block, against JAX's forward
on the same LoRA merged (a departure: JAX's forward skips them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import lora as jlora
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_dit_s2v as js2v
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import S2VPipeline as JaxS2V
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models import wan_dit_s2v as s2v_mod
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import S2VPipeline

from _lora_files import kohya_lora, runtime_lora

torch.set_num_threads(1)

as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
DCFG_HD128 = DCFG.replace(dim=256, ffn_dim=512, num_heads=2)
AUDIO_DIM = 16
PROMPT = "a person talking"


def _live(sp, key):
    """``sp`` with random injector output projections (zero at init)."""
    sp = jax.tree.map(lambda a: a, sp)
    for i, layer in sp["audio_injector"]["layers"].items():
        k = jax.random.PRNGKey(key + i)
        layer["o"] = {"kernel": 0.1 * jax.random.normal(
            k, layer["o"]["kernel"].shape), "bias": layer["o"]["bias"] + 0.01}
    return sp


def _pair(cfg, seed, inject=(0,)):
    tcfg = convert.config_from(WanDiTConfig, cfg)
    dp = jdit.init_wan_dit(jax.random.PRNGKey(seed), cfg)
    sp = _live(js2v.init_s2v_params(jax.random.PRNGKey(seed + 1), cfg,
                                    audio_dim=AUDIO_DIM,
                                    inject_layers=inject), seed)
    dit = WanDiT(tcfg)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    s2v = s2v_mod.WanS2V(tcfg, AUDIO_DIM, inject_layers=inject)
    s2v.load_state_dict(convert.s2v_from_jax(as_np(sp)))
    return dp, sp, dit, s2v


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * np.abs(want).max())


def test_apply_rope_per_sample_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 24)).astype(np.float32)
    ang = rng.uniform(0, 6, (2, 12, 12))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    want = js2v.apply_rope_per_sample(*(jnp.asarray(a) for a in (x, cos,
                                                                 sin)))
    got = s2v_mod.apply_rope_per_sample(*(torch.from_numpy(a)
                                          for a in (x, cos, sin)))
    _close(got.numpy(), want, 1e-6)


def test_s2v_block_matches_jax():
    """One block with two segments of different modulations (seg_ids mixed
    0/1) and per-sample RoPE tables: 1e-4 relative (fp32)."""
    dp, _, dit, _ = _pair(DCFG, 2)
    rng = np.random.default_rng(1)
    B, L = 2, 20
    x = rng.standard_normal((B, L, DCFG.dim)).astype(np.float32)
    e0 = rng.standard_normal((B, 6, 2, DCFG.dim)).astype(np.float32)
    seg = (rng.uniform(size=L) > 0.6).astype(np.int64)
    ctx = rng.standard_normal((B, 16, DCFG.dim)).astype(np.float32)
    ang = rng.uniform(0, 6, (B, L, DCFG.head_dim // 2))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    bp = jax.tree.map(lambda a: a[0], dp["blocks"])
    want = js2v.s2v_block_apply(bp, DCFG, jnp.asarray(x), jnp.asarray(e0),
                                jnp.asarray(seg.astype(np.int32)),
                                jnp.asarray(ctx),
                                (jnp.asarray(cos), jnp.asarray(sin)))
    with torch.no_grad():
        got = s2v_mod.s2v_block_apply(
            dit.blocks[0], convert.config_from(WanDiTConfig, DCFG),
            torch.from_numpy(x), torch.from_numpy(e0), torch.from_numpy(seg),
            torch.from_numpy(ctx), (torch.from_numpy(cos),
                                    torch.from_numpy(sin)))
    _close(got.numpy(), want)


@pytest.mark.parametrize("cfg,backend", [(DCFG, None),
                                         (DCFG_HD128, "flash")])
def test_audio_inject_matches_jax(cfg, backend):
    """Each latent frame's tokens against that frame's 4 audio tokens; at
    head_dim 128 the port takes the flash backend (its plain version on the
    CPU: kernel B1's arithmetic, B * f rows of 4 keys), below it the naive
    one, as JAX's: 1e-4 relative."""
    _, sp, _, s2v = _pair(cfg, 3)
    tcfg = convert.config_from(WanDiTConfig, cfg)
    rng = np.random.default_rng(2)
    grid = (3, 2, 4)
    x = rng.standard_normal((2, 24, cfg.dim)).astype(np.float32)
    audio = rng.standard_normal((2, 3, 4, cfg.dim)).astype(np.float32)
    want = js2v.audio_inject(sp["audio_injector"]["layers"][0], cfg,
                             jnp.asarray(x), jnp.asarray(audio), grid)
    calls = []
    real = s2v_mod.attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw.get("backend")))
        return real(q, k, v, backend=backend or kw.get("backend"))

    s2v_mod.attention = spy
    try:
        with torch.no_grad():
            got = s2v_mod.audio_inject(s2v.audio_injector.layers["0"], tcfg,
                                       torch.from_numpy(x),
                                       torch.from_numpy(audio), grid)
    finally:
        s2v_mod.attention = real
    n, hd = cfg.num_heads, cfg.dim // cfg.num_heads
    assert calls == [((6, 8, n, hd), (6, 4, n, hd),
                      None if hd == 128 else "naive")]
    _close(got.numpy(), want)


@pytest.mark.parametrize("inject", [(0,), (0, 1)])
def test_wan_s2v_forward_matches_jax(inject):
    """The whole S2V forward with audio at each inject layer: 1e-4
    relative to the velocity's scale."""
    dp, sp, dit, s2v = _pair(DCFG, 4, inject)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, J_VAE.z_dim, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, J_T5.dim)).astype(np.float32)
    audio = rng.standard_normal((2, 3, AUDIO_DIM)).astype(np.float32)
    t = np.array([600.0, 20.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(DCFG, (3, 4, 4))
    cos, sin = np.stack([cos, cos]), np.stack([sin, sin])
    seg = np.zeros(48, np.int64)
    seg[40:] = 1
    want = js2v.wan_s2v_forward(
        dp, sp, DCFG, *(jnp.asarray(a) for a in (x, t, ctx, cos, sin)),
        jnp.asarray(seg.astype(np.int32)), audio_feats=jnp.asarray(audio),
        inject_layers=inject)
    with torch.no_grad():
        got = s2v_mod.wan_s2v_forward(
            dit, s2v, *(torch.from_numpy(a) for a in (x, t, ctx, cos, sin,
                                                      seg)),
            audio_feats=torch.from_numpy(audio))
    _close(got.numpy(), want)
    with pytest.raises(ValueError, match="frames"):
        s2v_mod.wan_s2v_forward(
            dit, s2v, *(torch.from_numpy(a) for a in (x, t, ctx, cos, sin,
                                                      seg)),
            audio_feats=torch.from_numpy(audio[:, :2]))


@pytest.fixture(scope="module")
def pipes():
    dp, sp, dit, s2v = _pair(DCFG, 5)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxS2V(dp, DCFG, vp, J_VAE, tp, J_T5, dtype=jnp.float32,
                   s2v_params=sp, inject_layers=(0,))
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jpipe, S2VPipeline(dit, vae, t5, dtype=torch.float32,
                              device="cpu", s2v=s2v)


@pytest.mark.parametrize("guidance,with_audio", [(1.0, True), (4.0, True),
                                                 (4.0, False)])
def test_speech_to_video_matches_jax(pipes, guidance, with_audio):
    """End to end with the same audio features and noise (CFG carries the
    audio on both branches): the latents within 2e-4, the frames within
    one uint8 level."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    audio = rng.standard_normal((1, 3, AUDIO_DIM)).astype(np.float32) \
        if with_audio else None
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=2,
              guidance_scale=guidance, negative_prompt="silent",
              max_sequence_length=16, noise=noise, output_latents=True)
    want = jpipe.speech_to_video(PROMPT, audio, **kw)
    timings = {}
    got = pipe.speech_to_video(PROMPT, audio, timings=timings, **kw)
    assert set(timings) == {"text", "latents", "step0", "step1", "decode"}
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3
    if with_audio:
        with pytest.raises(ValueError, match="latent"):
            pipe.speech_to_video(PROMPT, audio[:, :2], **kw)


def test_init_injector_is_a_no_op(pipes):
    """`init_s2v_params`'s zero output projections: with or without audio
    the trajectory is the same (JAX's own property)."""
    _, live = pipes
    s2v = s2v_mod.init_s2v_params(
        convert.config_from(WanDiTConfig, DCFG),
        torch.Generator().manual_seed(0), audio_dim=AUDIO_DIM)
    pipe = S2VPipeline(live.dit, live.vae, live.t5, dtype=torch.float32,
                       device="cpu", s2v=s2v)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    audio = rng.standard_normal((1, 3, AUDIO_DIM)).astype(np.float32)
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=2,
              guidance_scale=1.0, max_sequence_length=16, noise=noise,
              output_latents=True)
    a = pipe.speech_to_video(PROMPT, audio, **kw)
    b = pipe.speech_to_video(PROMPT, None, **kw)
    np.testing.assert_array_equal(a.latents, b.latents)


@pytest.mark.parametrize("inject", [(0,), (0, 1)])
def test_departure_s2v_runtime_lora_matches_jax_merged(inject):
    """The port's `wan_s2v_forward` fuses the DiT's ``runtime_lora`` into
    each block (`s2v_block_apply(lora=)`); JAX's skips it. The port with
    runtime adapters against JAX's forward on the same LoRA merged into the
    base weights (`merge_lora`): 1e-4 relative to the velocity's scale, as
    `test_wan_s2v_forward_matches_jax`; both far from the un-adapted
    forward."""
    dp, sp, dit, s2v = _pair(DCFG, 7, inject)
    sd = kohya_lora(DCFG, 8)
    merged = jlora.merge_lora(dp, DCFG, sd, multiplier=1.3)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, J_VAE.z_dim, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, J_T5.dim)).astype(np.float32)
    audio = rng.standard_normal((2, 3, AUDIO_DIM)).astype(np.float32)
    t = np.array([450.0, 900.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(DCFG, (3, 4, 4))
    cos, sin = np.stack([cos, cos]), np.stack([sin, sin])
    seg = np.zeros(48, np.int64)
    seg[32:] = 1
    args = (x, t, ctx, cos, sin)
    want = js2v.wan_s2v_forward(
        merged, sp, DCFG, *(jnp.asarray(a) for a in args),
        jnp.asarray(seg.astype(np.int32)), audio_feats=jnp.asarray(audio),
        inject_layers=inject)
    with torch.no_grad():
        fwd = lambda: s2v_mod.wan_s2v_forward(  # noqa: E731
            dit, s2v, *(torch.from_numpy(a) for a in (*args, seg)),
            audio_feats=torch.from_numpy(audio)).numpy()
        unadapted = fwd()
        dit.runtime_lora = runtime_lora(sd, dit.cfg, 1.3)
        got = fwd()
    _close(got, want)
    moved = np.linalg.norm(got - unadapted) / np.linalg.norm(unadapted)
    assert moved > 1e-2, moved
