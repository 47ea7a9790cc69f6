"""The port's chain-of-frames edit end to end against the JAX package's
`WanPipeline`, on the tiny configs of `tests/test_pipeline_e2e.py`, with the
same weights (carried by `videocof_torch.convert`) and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline, latent_frame_count

torch.set_num_threads(1)

DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
DCFG_HD128 = DCFG.replace(dim=256, ffn_dim=512, num_heads=2)
PROMPT = "remove the red ball from the table"


def _pipelines(dcfg, jax_backend, port_backend):
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), dcfg)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxPipeline(dp, dcfg, vp, J_VAE, tp, J_T5, dtype=jnp.float32,
                        attn_backend=jax_backend)
    dit = WanDiT(convert.config_from(WanDiTConfig, dcfg))
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    pipe = WanPipeline(dit, vae, t5, dtype=torch.float32,
                       attn_backend=port_backend, device="cpu")
    return jpipe, pipe


@pytest.mark.parametrize("dcfg,steps,jax_backend,port_backend", [
    (DCFG, 2, None, None), (DCFG, 4, None, None),
    (DCFG_HD128, 2, "pallas", "flash"),
])
def test_cot_edit_matches_jax(monkeypatch, dcfg, steps, jax_backend,
                              port_backend):
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    jpipe, pipe = _pipelines(dcfg, jax_backend, port_backend)
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (1, 3, 9, 32, 32), dtype=np.uint8)
    cond = latent_frame_count(9)
    noise = rng.standard_normal((1, J_VAE.z_dim, cond + 1, 4, 4)
                                ).astype(np.float32)
    kw = dict(source_frames=9, reasoning_frames=4, num_inference_steps=steps,
              noise=noise, output_latents=True)
    want = jpipe(video, PROMPT, fused_sampling=False, **kw)
    timings = {}
    got = pipe(video, PROMPT, timings=timings, **kw)

    assert set(timings) == {"text", "encode+latents", "decode",
                            *(f"step{i}" for i in range(steps))}
    assert got.videos.shape == want.videos.shape == (1, 3, 10, 32, 32)
    assert got.ground_videos.shape == (1, 3, 1, 32, 32)
    assert got.edit_videos.shape == (1, 3, 9, 32, 32)
    # the frozen source latents are the encoded source, untouched
    mu = pipe.prepare_cot_latents(pipe._prepare_video(video), 1, noise=noise)
    np.testing.assert_allclose(got.latents[:, :, :cond],
                               mu[:, :, :cond].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    # frames are quantized to uint8: a latent ulp may flip one level
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3


def test_guards():
    jpipe, pipe = _pipelines(DCFG, None, None)
    video = np.zeros((1, 3, 9, 32, 32), np.uint8)
    # DDIM (CogVideoX's sampler) runs in the port's Wan edit; JAX's raises
    # there (its stepwise loop jits DDIM's step over a state that is no
    # pytree: `test_torch_ddim.py::test_departure_wan_edit_with_ddim`)
    noise = np.random.default_rng(0).standard_normal(
        (1, J_VAE.z_dim, latent_frame_count(9) + 1, 4, 4)).astype(np.float32)
    kw = dict(source_frames=9, guidance_scale=5.0, sampler="ddim",
              num_inference_steps=2, noise=noise, output_latents=True)
    with pytest.raises(TypeError):
        jpipe(video, "x", fused_sampling=False, **kw)
    out = pipe(video, "x", **kw)
    assert np.isfinite(out.latents).all()
    with pytest.raises(ValueError):
        pipe(video, ["a", "b"], source_frames=9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            WanPipeline(pipe.dit, pipe.vae, pipe.t5)   # device defaults to CUDA


def test_videocof_timing_prints_each_stage(monkeypatch, capsys):
    """``VIDEOCOF_TIMING=1``, read when the pipeline is built: one stderr
    line a stage in JAX's format (``[pipeline] <label>: <s>s``), with and
    without ``timings=``; JAX's stepwise edit prints its lines in the same
    format, among them the shared stages."""
    import re
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    line = re.compile(r"^\[pipeline\] ([^:]+): \d+\.\d\ds$")
    rng = np.random.default_rng(3)
    video = rng.integers(0, 256, (1, 3, 9, 32, 32), dtype=np.uint8)
    kw = dict(source_frames=9, reasoning_frames=4, num_inference_steps=2)
    stages = ["text", "encode+latents", "step0", "step1", "decode"]
    jpipe, pipe = _pipelines(DCFG, None, None)
    capsys.readouterr()
    pipe(video, PROMPT, **kw)
    assert capsys.readouterr().err == ""          # read at construction
    monkeypatch.setenv("VIDEOCOF_TIMING", "1")
    jpipe, pipe = _pipelines(DCFG, None, None)
    assert pipe.verbose_timing and jpipe.verbose_timing
    for timings in (None, {}):
        capsys.readouterr()
        pipe(video, PROMPT, timings=timings, **kw)
        err = capsys.readouterr().err.splitlines()
        assert [line.match(ln).group(1) for ln in err] == stages, err
        if timings is not None:
            assert list(timings) == stages
    capsys.readouterr()
    jpipe(video, PROMPT, fused_sampling=False, **kw)
    jax_lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("[pipeline]")]
    labels = [line.match(ln).group(1) for ln in jax_lines]
    assert {"text", "encode+latents", "decode"} <= set(labels), jax_lines
