"""The port's standard-edit pieces against the JAX package: the Euler and
DPM++ samplers, TeaCache's coefficients and skip plan, the DiT's TeaCache
residual forward, and the stepwise edit with classifier-free guidance,
TeaCache and cfg-skip through the int8 attention backend (JAX's Pallas int8
kernel in interpret mode, spied on; the port's plain version of B4). Weights
are carried by `videocof_torch.convert`; inputs and noise are numpy from a
seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videocof_tpu.ops.int8_attention as jax_int8_module
from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import t5_encoder as jt5, teacache as jtc
from videocof_tpu.models import wan_dit as jdit, wan_vae as jvae
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_tpu.schedulers import get_scheduler as jax_get_scheduler
from videocof_torch import convert
from videocof_torch.configs import (GenerationConfig, T5Config, WanDiTConfig,
                                    WanVAEConfig)
from videocof_torch.models import teacache, wan_dit
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline
from videocof_torch.schedulers import SCHEDULERS, get_scheduler

torch.set_num_threads(1)

DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
DCFG_HD128 = DCFG.replace(dim=256, ffn_dim=512, num_heads=2)
PROMPT = "remove the red ball from the table"


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


def _dit_pair(jcfg, seed=0):
    params = jdit.init_wan_dit(jax.random.PRNGKey(seed), jcfg)
    model = wan_dit.WanDiT(convert.config_from(WanDiTConfig, jcfg))
    model.load_state_dict(convert.dit_from_jax(_as_np(params)))
    return params, model


# ------------------------------------------------------------------ samplers

@pytest.mark.parametrize("name,kw", [
    ("flow", {}), ("euler", {}),
    ("dpm++", {"solver_order": 1}), ("flow_dpm++", {"solver_order": 2}),
    ("dpm++", {"solver_order": 3}),
])
@pytest.mark.parametrize("steps", [6, 20])
def test_scheduler_matches_jax(name, kw, steps):
    """The float64 grid and plans are equal; a trajectory on a fixed
    velocity field agrees to fp32 rounding."""
    a, b = get_scheduler(name, **kw), jax_get_scheduler(name, **kw)
    np.testing.assert_array_equal(a.set_timesteps(steps, shift=3.0),
                                  b.set_timesteps(steps, shift=3.0))
    np.testing.assert_array_equal(a.sigmas, b.sigmas)
    if hasattr(b, "plans"):
        assert [dataclasses.asdict(p) for p in a.plans] == \
            [dataclasses.asdict(p) for p in b.plans]
    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal((1, 4, 5, 6, 6)).astype(np.float32)
    w = rng.standard_normal(x0.shape).astype(np.float32)
    xa, xb = torch.from_numpy(x0), jnp.asarray(x0)
    sa, sb = a.init_state(xa), b.init_state(xb)
    for i, t in enumerate(a.timesteps):
        va = np.tanh(xa.numpy()) * w + float(t) / 1000.0
        vb = np.tanh(np.asarray(xb)) * w + float(t) / 1000.0
        xa, sa = a.step(torch.from_numpy(va.astype(np.float32)), i, xa, sa)
        xb, sb = b.step(jnp.asarray(vb.astype(np.float32)), i, xb, sb)
        np.testing.assert_allclose(xa.numpy(), np.asarray(xb), rtol=1e-5,
                                   atol=1e-5)


def test_scheduler_table():
    from videocof_tpu.schedulers import SCHEDULERS as JAX_SCHEDULERS
    assert set(SCHEDULERS) == set(JAX_SCHEDULERS) == {"euler", "unipc",
                                                       "dpm++", "ddim"}
    # DDIM (CogVideoX's sampler) by both names, its grid JAX's
    for name in ("ddim", "cogvideox_ddim"):
        a, b = get_scheduler(name), jax_get_scheduler(name)
        assert type(a).__name__ == type(b).__name__ == "DDIMScheduler"
        np.testing.assert_array_equal(a.set_timesteps(7), b.set_timesteps(7))
    with pytest.raises(ValueError):
        get_scheduler("nope")
    with pytest.raises(ValueError):
        get_scheduler("dpm++", solver_order=4)


# ------------------------------------------------------------------ TeaCache

NAMES = ("Wan2.1-T2V-1.3B", "models/Wan2.1-Fun-1.3B-InP",
         "Wan2.1-Fun-V1.1-1.3B-Control", "wan2.1-vace-1.3b", "Wan2.1-T2V-14B",
         "Wan2.1-I2V-14B-480P", "Wan2.1-I2V-14B-720P", "Wan2.1-Fun-14B-InP",
         "Wan2.2-T2V-A14B", "Wan2.2-TI2V-5B", "Wan2.1-VACE-14B",
         "my-1.3b-finetune", "my-14b-finetune", "unknown-model")


def test_teacache_coefficients_match_jax():
    assert teacache.TEACACHE_COEFFICIENTS == jtc.TEACACHE_COEFFICIENTS
    for name in NAMES:
        assert teacache.get_teacache_coefficients(name) == \
            jtc.get_teacache_coefficients(name), name


@pytest.mark.parametrize("sampler,steps,thresh,start", [
    ("unipc", 50, 0.10, 5), ("unipc", 50, 0.03, 5), ("unipc", 50, 1e9, 2),
    ("dpm++", 20, 0.10, 0), ("unipc", 12, -1e9, 0),
])
def test_teacache_plan_matches_jax(sampler, steps, thresh, start):
    params, model = _dit_pair(DCFG_HD128)
    sched = get_scheduler(sampler)
    sched.set_timesteps(steps, shift=3.0)
    coeffs = teacache.get_teacache_coefficients("wan2.1-t2v-1.3b")
    np.testing.assert_allclose(
        teacache.timestep_modulations(model, sched.timesteps),
        jtc.timestep_modulations(params, DCFG_HD128, sched.timesteps),
        rtol=1e-5, atol=1e-5)
    got = teacache.plan_teacache_skips(model, sched.timesteps, coeffs, thresh,
                                       start)
    assert got == jtc.plan_teacache_skips(params, DCFG_HD128,
                                          sched.timesteps, coeffs, thresh,
                                          start)
    assert not any(got[:max(start, 1)])


def test_dit_residual_forward_matches_jax():
    """Computing: (velocity, stream - stream0) as JAX; skipping: the cached
    residual replayed onto another input, head run, residual passed on."""
    jcfg = DCFG.replace(token_pad_multiple=32)     # padded keys, masked
    params, model = _dit_pair(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, jcfg.in_dim, 3, 8, 8)).astype(np.float32)
    x2 = rng.standard_normal(x.shape).astype(np.float32)
    ctx = rng.standard_normal((2, jcfg.text_len, jcfg.text_dim)
                              ).astype(np.float32)
    t = np.array([937.0, 937.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(jcfg, (3, 4, 4), f_src=1,
                                           f_ground=1)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    want_v, want_r = jdit.wan_dit_forward_with_residual(
        params, jcfg, j(x), j(t), j(ctx), j(cos), j(sin))
    want_sv, want_sr = jdit.wan_dit_forward_with_residual(
        params, jcfg, j(x2), j(t * 0.5), j(ctx), j(cos), j(sin),
        residual=want_r, skip_blocks=True)
    tt = torch.from_numpy
    with torch.no_grad():
        got_v, got_r = model.forward_with_residual(
            tt(x), tt(t), tt(ctx), tt(cos), tt(sin))
        got_sv, got_sr = model.forward_with_residual(
            tt(x2), tt(t * 0.5), tt(ctx), tt(cos), tt(sin), residual=got_r,
            skip_blocks=True)
        plain = model(tt(x), tt(t), tt(ctx), tt(cos), tt(sin))
    assert got_r.shape == (2, 64, jcfg.dim)        # 48 tokens padded to 64
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **tol)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **tol)
    np.testing.assert_allclose(got_sv.numpy(), np.asarray(want_sv), **tol)
    np.testing.assert_allclose(got_sr.numpy(), np.asarray(want_sr), **tol)
    np.testing.assert_array_equal(plain.numpy(), got_v.numpy())
    with pytest.raises(ValueError):
        model.forward_with_residual(tt(x), tt(t), tt(ctx), tt(cos), tt(sin),
                                    skip_blocks=True)


# ----------------------------------------------------------------- the edit

def _pipelines(dcfg, jax_backend, port_backend):
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), dcfg)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxPipeline(dp, dcfg, vp, J_VAE, tp, J_T5, dtype=jnp.float32,
                        attn_backend=jax_backend)
    dit = wan_dit.WanDiT(convert.config_from(WanDiTConfig, dcfg))
    dit.load_state_dict(convert.dit_from_jax(_as_np(dp)))
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(_as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(_as_np(tp)))
    pipe = WanPipeline(dit, vae, t5, dtype=torch.float32,
                       attn_backend=port_backend, device="cpu")
    return jpipe, pipe


STEPS = 6
# steps 0-3 with CFG, 4-5 cond-only (cfg_off_after = 6 - round(6 * 0.34));
# skip step 2 (a CFG step replaying step 1's batch-2 residual) and step 4 (a
# cond-only step replaying the cond rows of step 3's); step 0's True is
# overridden, as JAX does
EDIT_KW = dict(source_frames=9, reasoning_frames=4, num_inference_steps=STEPS,
               guidance_scale=5.0, enable_teacache=True,
               teacache_forced_plan=[True, False, True, False, True, False],
               cfg_skip_ratio=0.34, output_latents=True)


def _inputs():
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (1, 3, 9, 32, 32), dtype=np.uint8)
    noise = rng.standard_normal((1, J_VAE.z_dim, 4, 4, 4)).astype(np.float32)
    return video, noise


def test_cfg_teacache_int8_edit_matches_jax(monkeypatch):
    """The stepwise edit (`VIDEOCOF_STEPWISE=1`) at head_dim 128 through the
    int8 backend on both sides: JAX's Pallas int8 kernel (spied on: JAX
    would drop to XLA attention silently for a head_dim it cannot take),
    the port's plain version of B4. Tolerance: where q or k differ in their
    last bit between the two frameworks' linears, an element can cross a
    rounding boundary of the int8 quantization, one level, about 1e-3 of
    an attention output (see `tests/test_torch_int8_attention.py`); the
    flash backend's edit agrees to 2e-4."""
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    calls = []
    real = jax_int8_module.int8_flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(jax_int8_module, "int8_flash_attention", spy)
    jpipe, pipe = _pipelines(DCFG_HD128, "int8", "int8")
    video, noise = _inputs()
    neg = GenerationConfig().negative_prompt
    want = jpipe(video, PROMPT, negative_prompt=neg, noise=noise,
                 fused_sampling=False, **EDIT_KW)
    # traced once per compiled step variant that computes (the block stack
    # is a scan): self- and cross-attention, at batch 2 (CFG) and 1
    assert sorted(s[0] for s in calls) == [1, 1, 2, 2]
    timings = {}
    got = pipe(video, PROMPT, negative_prompt=neg, noise=noise,
               timings=timings, **EDIT_KW)
    assert set(timings) == {"text", "encode+latents", "decode", "step0",
                            "step1", "step2 skipped", "step3",
                            "step4 skipped", "step5"}
    assert got.videos.shape == want.videos.shape == (1, 3, 10, 32, 32)
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-3,
                               atol=2e-3)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3


def test_cfg_sequential_equals_batched():
    """Two batch-B forwards per CFG step give the batched step's edit; the
    embeddings hooks give the text path's."""
    _, pipe = _pipelines(DCFG, None, None)
    video, noise = _inputs()
    kw = dict(EDIT_KW, negative_prompt="blurry", noise=noise,
              sampler="dpm++", solver_order=3)
    batched = pipe(video, PROMPT, **kw)
    hooked = pipe(video, PROMPT, **kw,
                  prompt_embeds=pipe.encode_prompt([PROMPT]),
                  negative_prompt_embeds=pipe.encode_prompt(["blurry"]))
    np.testing.assert_array_equal(hooked.latents, batched.latents)
    pipe.cfg_sequential = True
    sequential = pipe(video, PROMPT, **kw)
    np.testing.assert_allclose(sequential.latents, batched.latents,
                               rtol=1e-5, atol=1e-5)
    pipe.cfg_sequential = False
    plain = pipe(video, PROMPT, **dict(kw, guidance_scale=1.0))
    assert np.abs(plain.latents - batched.latents).max() > 1e-3
