"""The port's ragged batch (`videocof_torch.pipeline.batch_edit`) against the
JAX package's `batch_edit` and against the port's own per-item runs, on the
tiny configs with the same weights (carried by `videocof_torch.convert`) and
the same per-item noise: items of 9 and 17 frames (as
`tests/test_varlen_pipeline.py`), with and without CFG; one case at head_dim
64 with JAX's key-masked Pallas kernel in interpret mode against the port's
flash backend (B1's plain version on the CPU). Also the DiT's ``seq_lens``
and per-sample RoPE tables through the token pad, against JAX's forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videocof_tpu.ops.flash_attention as jfa
from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_tpu.pipeline import batch_edit as jax_batch_edit
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT, make_rope_for_geometry
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline, batch_edit, latent_frame_count

torch.set_num_threads(1)

DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
DCFG_HD64 = DCFG.replace(dim=128, ffn_dim=256, num_heads=2)
FRAMES = (9, 17)
REL = 1e-5        # the batch against the port's own per-item runs (fp32)


def _pipelines(dcfg, port_backend):
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), dcfg)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxPipeline(dp, dcfg, vp, J_VAE, tp, J_T5, dtype=jnp.float32)
    dit = WanDiT(convert.config_from(WanDiTConfig, dcfg))
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jpipe, WanPipeline(dit, vae, t5, dtype=torch.float32,
                              attn_backend=port_backend, device="cpu")


def _jax_noise(monkeypatch, pipe, seeds):
    """The port's latent preparation gets, item by item, the noise that
    JAX's draws from ``PRNGKey(seed)`` where it would draw its own; returns
    those noises as drawn."""
    real = pipe.prepare_cot_latents
    noises, it = [], iter(seeds)
    sc = J_VAE.spatial_compression_ratio

    def prepare(video, ground, generator=None, noise=None):
        if noise is not None:            # a per-item run's own noise
            return real(video, ground, noise=noise)
        B, _, T, H, W = video.shape
        shape = (B, J_VAE.z_dim, latent_frame_count(T) + ground, H // sc,
                 W // sc)
        noises.append(np.array(jax.random.normal(
            jax.random.PRNGKey(next(it)), shape, jnp.float32)))
        return real(video, ground, noise=noises[-1])

    monkeypatch.setattr(pipe, "prepare_cot_latents", prepare)
    return noises


def _inputs(dcfg):
    rng = np.random.default_rng(7)
    videos = [np.random.default_rng(i).uniform(-1, 1, (3, f, 32, 32))
              .astype(np.float32) for i, f in enumerate(FRAMES)]
    embeds = [rng.standard_normal((dcfg.text_len, dcfg.text_dim))
              .astype(np.float32) for _ in FRAMES]
    negs = [rng.standard_normal((dcfg.text_len, dcfg.text_dim))
            .astype(np.float32) for _ in FRAMES]
    return videos, embeds, negs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dcfg,guidance,pallas", [
    (DCFG, 1.0, False), (DCFG, 4.5, False), (DCFG_HD64, 1.0, True)],
    ids=["hd24-g1", "hd24-g4.5", "hd64-pallas"])
def test_batch_edit_matches_jax_and_per_item(monkeypatch, dcfg, guidance,
                                             pallas):
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    masked = []
    if pallas:
        # JAX's key-masked Pallas kernel (interpret mode on the CPU), spied
        # on to prove it ran; at head_dim 24 JAX would drop to XLA
        monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "pallas")
        real = jfa._flash_core_masked
        monkeypatch.setattr(jfa, "_flash_core_masked", lambda *a: (
            masked.append(a[3].shape), real(*a))[1])
    jpipe, pipe = _pipelines(dcfg, "flash" if pallas else None)
    videos, embeds, negs = _inputs(dcfg)
    cfg = guidance > 1.0
    kw = dict(reasoning_frames=4, num_inference_steps=2,
              guidance_scale=guidance,
              negative_prompt_embeds=negs if cfg else None, seeds=[3, 4],
              output_latents=True)
    want = jax_batch_edit(jpipe, videos, list(FRAMES), embeds, **kw)
    if pallas:
        # key masks over the batch's 44 tokens (item 0's 28)
        assert masked and all(m[-1] == 44 for m in masked), masked
    noises = _jax_noise(monkeypatch, pipe, [3, 4])
    got = batch_edit(pipe, videos, list(FRAMES), embeds, **kw)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.latents.shape == w.latents.shape
        np.testing.assert_allclose(g.latents, w.latents, rtol=2e-4,
                                   atol=2e-4, err_msg=f"item {i}")
        assert g.videos.shape == w.videos.shape
        assert g.ground_videos.shape == w.ground_videos.shape
        # frames are quantized to uint8: a latent ulp may flip one level
        assert np.abs(g.videos - w.videos).max() * 255 <= 1.0 + 1e-3
        # the port's own per-item run of the same item, with the same noise
        one = pipe(videos[i][None], "p", source_frames=FRAMES[i],
                   reasoning_frames=4, num_inference_steps=2,
                   guidance_scale=guidance, prompt_embeds=embeds[i][None],
                   negative_prompt_embeds=negs[i][None] if cfg else None,
                   noise=noises[i], output_latents=True)
        assert _rel(g.latents, one.latents) <= REL, f"item {i}"
        assert np.abs(g.videos - one.videos).max() * 255 <= 1.0 + 1e-3


def test_batch_edit_checks_its_arguments():
    _, pipe = _pipelines(DCFG, None)
    videos, embeds, _ = _inputs(DCFG)
    with pytest.raises(ValueError, match="negative_prompt_embeds"):
        batch_edit(pipe, videos, list(FRAMES), embeds, guidance_scale=4.5)
    with pytest.raises(ValueError, match="source_frames"):
        batch_edit(pipe, videos, [9], embeds)


def test_dit_seq_lens_and_per_sample_tables_match_jax():
    """A ragged batch through the DiT with a token pad (``token_pad_multiple``
    8): per-sample tables padded with the identity rotation, ``seq_lens``
    superseding the pad mask; the output against JAX's forward."""
    dcfg = DCFG.replace(token_pad_multiple=8)
    params = jdit.init_wan_dit(jax.random.PRNGKey(0), dcfg)
    dit = WanDiT(convert.config_from(WanDiTConfig, dcfg))
    dit.load_state_dict(convert.dit_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    grid, frames = (2, 2), (3, 5)          # 12 and 20 tokens, padded to 24
    x = rng.standard_normal((2, dcfg.in_dim, frames[1], 4, 4)).astype(np.float32)
    x[0, :, frames[0]:] = 0.0
    tables = [make_rope_for_geometry(dit.cfg, (f,) + grid, f_src=f // 2,
                                     f_ground=1) for f in frames]
    L = frames[1] * grid[0] * grid[1]
    cos, sin = (np.stack([np.pad(t[j], ((0, L - len(t[j])), (0, 0)),
                                 constant_values=1.0 - j) for t in tables])
                for j in (0, 1))
    seq_lens = np.array([frames[0] * 4, L], np.int32)
    t = np.array([700.0, 300.0], np.float32)
    ctx = rng.standard_normal((2, 7, dcfg.text_dim)).astype(np.float32)
    want = jdit.wan_dit_forward(params, dcfg, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx), jnp.asarray(cos),
                                jnp.asarray(sin), attn_backend="naive",
                                seq_lens=jnp.asarray(seq_lens))
    with torch.no_grad():
        got = dit(*(torch.from_numpy(a) for a in (x, t, ctx, cos, sin)),
                  seq_lens=torch.from_numpy(seq_lens))
        # each row alone, at its own length, with its own [L, D/2] table
        alone = dit(torch.from_numpy(x[:1, :, :frames[0]]),
                    torch.from_numpy(t[:1]), torch.from_numpy(ctx[:1]),
                    *(torch.from_numpy(a) for a in tables[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert _rel(got[:1, :, :frames[0]], alone) <= REL
