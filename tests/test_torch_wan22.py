"""The port's Wan2.2 dual-expert pipeline (`Wan22Pipeline`) and
text-to-video against the JAX package's, on the tiny configs with the same
weights (carried by `videocof_torch.convert`) and the same noise: the
boundary split and the expert routing, the per-expert TeaCache plan, the
dual-expert chain-of-frames edit and `text_to_video` with
``guidance_scale_2`` (JAX run stepwise: ``VIDEOCOF_STEPWISE=1``,
``fused_sampling=False``), and the one-expert `WanPipeline.text_to_video`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import Wan22Pipeline as JaxWan22
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_tpu.schedulers import get_scheduler as jget_scheduler
from videocof_torch import convert
from videocof_torch.configs import (T5Config, WAN22_T2V_A14B, WAN22_TI2V_5B,
                                    WanDiTConfig, WanVAEConfig)
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.teacache import TEACACHE_COEFFICIENTS
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import (Wan22Pipeline, WanPipeline,
                                     latent_frame_count)
from videocof_torch.schedulers import get_scheduler

torch.set_num_threads(1)

DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
PROMPT = "replace the red car with a blue bicycle"
LAT_TOL = dict(rtol=2e-4, atol=2e-4)   # final latents, the port vs JAX


@pytest.fixture(autouse=True)
def _jax_stepwise(monkeypatch):
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")


def test_configs_match_jax():
    from videocof_tpu import configs as jc
    assert WAN22_T2V_A14B == convert.config_from(WanDiTConfig,
                                                 jc.WAN22_T2V_A14B)
    assert WAN22_TI2V_5B == convert.config_from(WanDiTConfig,
                                                jc.WAN22_TI2V_5B)


@pytest.fixture(scope="module")
def pipelines():
    """(JAX's Wan22Pipeline, the port's) with two experts of different
    weights, and the JAX base pipeline and the port's of the first."""
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    dp2 = jdit.init_wan_dit(jax.random.PRNGKey(3), DCFG)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jargs = (dp, DCFG, vp, J_VAE, tp, J_T5)
    jmoe = JaxWan22(*jargs, dtype=jnp.float32, dit_params_2=dp2)
    jbase = JaxPipeline(*jargs, dtype=jnp.float32)

    def dit(params):
        m = WanDiT(convert.config_from(WanDiTConfig, DCFG))
        m.load_state_dict(convert.dit_from_jax(as_np(params)))
        return m
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    moe = Wan22Pipeline(dit(dp), vae, t5, dtype=torch.float32,
                        device="cpu", dit_2=dit(dp2))
    base = WanPipeline(moe.dit, vae, t5, dtype=torch.float32, device="cpu")
    return jmoe, moe, jbase, base


@pytest.mark.parametrize("steps,shift", [(4, 5.0), (4, 3.0), (10, 5.0),
                                         (50, 5.0), (50, 12.0)])
def test_split_idx_and_routing_match_jax(pipelines, steps, shift):
    jmoe, moe, _, _ = pipelines
    sched, jsched = get_scheduler("unipc"), jget_scheduler("unipc")
    sched.set_timesteps(steps, shift=shift)
    jsched.set_timesteps(steps, shift=shift)
    split = moe._split_idx(sched)
    assert split == jmoe._split_idx(jsched)
    assert 0 < split < steps
    for i, t in enumerate(sched.timesteps):
        high = jmoe.expert_for_timestep(float(t)) is jmoe.dit_params_2
        assert (moe.expert_for_timestep(float(t)) is moe.dit_2) == high
        assert high == (i < split)
    plan = moe._expert_plan(sched, 5.0)
    assert [d is moe.dit_2 for d, _ in plan] == [i < split
                                                for i in range(steps)]
    one = Wan22Pipeline(moe.dit, moe.vae, moe.t5, device="cpu")
    assert one._split_idx(sched) == 0


@pytest.mark.parametrize("steps,thresh,warmup,forced", [
    (50, 0.10, 5, None), (20, 0.3, 2, None), (12, 0.2, 0, None),
    (10, 0.1, 5, [True] * 10)])
def test_per_expert_teacache_plan_matches_jax(pipelines, steps, thresh,
                                              warmup, forced):
    jmoe, moe, _, _ = pipelines
    sched, jsched = get_scheduler("unipc"), jget_scheduler("unipc")
    sched.set_timesteps(steps, shift=5.0)
    jsched.set_timesteps(steps, shift=5.0)
    args = (steps, True, thresh, warmup, None, forced, True, 0.2)
    skips, cfg_off = moe._plan_t2v_teacache(sched, *args)
    jskips, jcfg_off = jmoe._plan_t2v_teacache(jsched, *args)
    assert skips == list(jskips) and cfg_off == jcfg_off
    split = moe._split_idx(sched)
    assert not skips[0] and not skips[split]
    if forced is None:
        coeffs = TEACACHE_COEFFICIENTS["wan2.1-i2v-14b-720p"]
        assert moe._plan_t2v_teacache(sched, steps, True, thresh, warmup,
                                      coeffs, None, True, 0.2)[0] == skips


def _edit_inputs(cot=True):
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (1, 3, 9, 32, 32), dtype=np.uint8)
    cond = latent_frame_count(9)
    noise = rng.standard_normal(
        (1, J_VAE.z_dim, cond + 1 if cot else cond, 4, 4)
    ).astype(np.float32)
    return video, noise


@pytest.mark.parametrize("kw", [
    dict(num_inference_steps=4, guidance_scale=1.0),
    dict(num_inference_steps=4, guidance_scale=4.0, guidance_scale_2=3.0),
    dict(num_inference_steps=6, guidance_scale=3.0, guidance_scale_2=2.0,
         enable_teacache=True, teacache_forced_plan=[False, True] * 3,
         cfg_skip_ratio=0.34),
    dict(num_inference_steps=4, guidance_scale=2.0, cot=False),
])
def test_dual_expert_edit_matches_jax(pipelines, kw):
    jmoe, moe, _, _ = pipelines
    video, noise = _edit_inputs(kw.get("cot", True))
    kw = dict(kw, source_frames=9, reasoning_frames=4, shift=5.0,
              noise=noise, output_latents=True)
    want = jmoe(video, PROMPT, fused_sampling=False, **kw)
    timings = {}
    got = moe(video, PROMPT, timings=timings, **kw)
    steps = kw["num_inference_steps"]
    assert len([k for k in timings if k.startswith("step")]) == steps
    assert got.videos.shape == want.videos.shape
    np.testing.assert_allclose(got.latents, want.latents, **LAT_TOL)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3


def test_the_experts_both_run(pipelines):
    """Each expert runs its own steps: 2 high-noise and 2 base forwards at
    4 steps and shift 5, counted at the first block's calls."""
    _, moe, _, _ = pipelines
    video, noise = _edit_inputs()
    calls = {"dit": 0, "dit_2": 0}
    hooks = [getattr(moe, name).blocks[0].register_forward_pre_hook(
        lambda *_, n=name: calls.__setitem__(n, calls[n] + 1))
        for name in calls]
    try:
        moe(video, PROMPT, source_frames=9, num_inference_steps=4,
            guidance_scale=1.0, noise=noise)
    finally:
        for h in hooks:
            h.remove()
    assert calls == {"dit": 2, "dit_2": 2}


@pytest.mark.parametrize("kw", [
    dict(guidance_scale=4.0, guidance_scale_2=3.0),
    dict(guidance_scale=1.0),
    dict(guidance_scale=3.0, enable_teacache=True, teacache_threshold=0.5,
         teacache_skip_start_steps=1),
])
def test_text_to_video_matches_jax(pipelines, kw):
    jmoe, moe, _, _ = pipelines
    noise = np.random.default_rng(1).standard_normal(
        (1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    kw = dict(kw, height=32, width=32, num_frames=9, num_inference_steps=4,
              noise=noise, output_latents=True)
    want = jmoe.text_to_video(PROMPT, fused_sampling=False, **kw)
    got = moe.text_to_video(PROMPT, **kw)
    assert got.videos.shape == want.videos.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(got.latents, want.latents, **LAT_TOL)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3


@pytest.mark.parametrize("guidance", [1.0, 5.0])
def test_one_expert_text_to_video_matches_jax(pipelines, guidance):
    _, _, jbase, base = pipelines
    noise = np.random.default_rng(2).standard_normal(
        (2, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=3,
              guidance_scale=guidance, noise=noise, output_latents=True,
              negative_prompt="blurry")
    prompts = [PROMPT, "a quiet lake"]
    want = jbase.text_to_video(prompts, fused_sampling=False, **kw)
    timings = {}
    got = base.text_to_video(prompts, timings=timings, **kw)
    assert set(timings) == {"text", "latents", "decode",
                            *(f"step{i}" for i in range(3))}
    assert got.videos.shape == want.videos.shape == (2, 3, 9, 32, 32)
    np.testing.assert_allclose(got.latents, want.latents, **LAT_TOL)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3
