"""4x length extrapolation in the port against the JAX package: RIFLEx's
temporal table and the RoPE tables built on it (bit for bit), per-sample
tables in the rotation, the CoF positions bounded at 4x, the tiny pipeline
at 4x length (33 frames at 16x16, as `tests/test_length_extrapolation.py`)
with and without RIFLEx, and the paired ``cot=False`` edit, with the same
weights (carried by `videocof_torch.convert`) and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import rope as jrope
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models import rope
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT, make_rope_for_geometry
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline, latent_frame_count

torch.set_num_threads(1)

# head_dim 128: RIFLEx's k = 6 needs a temporal section of at least 6
# frequencies (WAN_TINY's head_dim 24 has 4)
DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim, dim=256, ffn_dim=512, num_heads=2)
PROMPT = "remove the cube"


@pytest.mark.parametrize("head_dim,k,L_test,scale", [
    (128, 6, 66, None), (128, 6, 66, 4.0), (128, 1, 20, None),
    (24, 4, 34, 2.5)])
def test_riflex_tables_match_jax_bitwise(head_dim, k, L_test, scale):
    table = rope.riflex_angle_table(head_dim, k, L_test, scale)
    want = jrope.riflex_angle_table(head_dim, k, L_test, scale)
    assert table.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(table, want)
    default = rope.rope_angle_tables(head_dim)[0]
    changed = np.any(table != default, axis=0)
    assert changed.tolist() == [i == k - 1 for i in range(table.shape[1])]
    # CoF geometry at 4x: 34 source + 1 ground + 34 target latent frames
    grid = (69, 2, 3)
    for kw in (dict(f_src=34, f_ground=1), dict(f_src=34), {}):
        got = rope.build_rope_cos_sin(grid, head_dim, temporal_table=table,
                                      **kw)
        exp = jrope.build_rope_cos_sin(grid, head_dim, temporal_table=want,
                                       **kw)
        for g, w in zip(got, exp):
            np.testing.assert_array_equal(g, w)


def test_cof_positions_bounded_at_4x():
    # 4x the 33-frame training geometry: 133 source frames, 34 latent frames
    f_src = latent_frame_count(133)
    f = f_src + 1 + f_src
    pos = rope.cof_temporal_positions(f, f_src=f_src, f_ground=1)
    np.testing.assert_array_equal(
        pos, jrope.cof_temporal_positions(f, f_src=f_src, f_ground=1))
    assert (pos.min(), pos.max()) == (0, f_src)
    assert rope.cof_temporal_positions(f).max() == f - 1


def test_per_sample_tables_match_jax():
    """[B, L, D/2] tables rotate each sample by its own table, as JAX's, and
    as the [L, D/2] rotation of each sample alone."""
    L, D = 12, 128
    cos, sin = np.stack([np.stack(make_rope_for_geometry(
        convert.config_from(WanDiTConfig, DCFG), (f, 2, 2), f_src=f // 2,
        f_ground=1))[:, :L] for f in (3, 5)], axis=1)   # [2, B, L, D/2]
    x = np.random.default_rng(0).standard_normal((2, L, 3, D)
                                                 ).astype(np.float32)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                          torch.from_numpy(sin))
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos),
                            jnp.asarray(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    for b in range(2):
        alone = rope.apply_rope(torch.from_numpy(x[b:b + 1]),
                                torch.from_numpy(cos[b]),
                                torch.from_numpy(sin[b]))
        torch.testing.assert_close(got[b:b + 1], alone, rtol=0, atol=0)


@pytest.fixture(scope="module")
def pipelines():
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxPipeline(dp, DCFG, vp, J_VAE, tp, J_T5, dtype=jnp.float32)
    dit = WanDiT(convert.config_from(WanDiTConfig, DCFG))
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jpipe, WanPipeline(dit, vae, t5, dtype=torch.float32, device="cpu")


def _both(pipelines, monkeypatch, video, noise, **kw):
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    jpipe, pipe = pipelines
    kw = dict(kw, noise=noise, output_latents=True)
    want = jpipe(video, PROMPT, fused_sampling=False, **kw)
    got = pipe(video, PROMPT, **kw)
    assert got.videos.shape == want.videos.shape
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    # frames are quantized to uint8: a latent ulp may flip one level
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3
    return got, want


@pytest.mark.parametrize("riflex_k", [None, 6])
def test_pipeline_at_4x_length_matches_jax(pipelines, monkeypatch, riflex_k):
    """4x the 9-frame tiny geometry: 9 source + 1 ground + 9 target latent
    frames, the source and target streamed through the VAE."""
    rng = np.random.default_rng(0)
    video = rng.uniform(-1, 1, (1, 3, 33, 16, 16)).astype(np.float32)
    cond = latent_frame_count(33)
    noise = rng.standard_normal((1, J_VAE.z_dim, cond + 1, 2, 2)
                                ).astype(np.float32)
    got, _ = _both(pipelines, monkeypatch, video, noise, source_frames=33,
                   reasoning_frames=4, num_inference_steps=2,
                   riflex_k=riflex_k)
    assert got.ground_videos.shape == (1, 3, 1, 16, 16)
    assert got.edit_videos.shape == (1, 3, 33, 16, 16)
    assert np.isfinite(got.videos).all()


def test_riflex_changes_the_edit(pipelines):
    """RIFLEx reaches the DiT: its tables change the trajectory."""
    _, pipe = pipelines
    video = np.random.default_rng(1).uniform(-1, 1, (1, 3, 33, 16, 16)
                                             ).astype(np.float32)
    latents = {k: pipe(video, PROMPT, source_frames=33, num_inference_steps=1,
                       riflex_k=k, output_latents=True).latents
               for k in (None, 6)}
    assert np.abs(latents[None] - latents[6]).max() > 1e-4


@pytest.mark.parametrize("repeat_rope", [True, False])
def test_paired_edit_matches_jax(pipelines, monkeypatch, repeat_rope):
    """``cot=False``: [src | tgt] latents, no reasoning frames, the edit
    segment decoded alone."""
    rng = np.random.default_rng(2)
    video = rng.integers(0, 256, (1, 3, 9, 32, 32), dtype=np.uint8)
    cond = latent_frame_count(9)
    noise = rng.standard_normal((1, J_VAE.z_dim, cond, 4, 4)
                                ).astype(np.float32)
    got, want = _both(pipelines, monkeypatch, video, noise, source_frames=9,
                      num_inference_steps=2, cot=False,
                      repeat_rope=repeat_rope)
    assert got.latents.shape == (1, J_VAE.z_dim, 2 * cond, 4, 4)
    assert got.videos.shape == (1, 3, 9, 32, 32)
    assert got.ground_videos is None and want.ground_videos is None
    np.testing.assert_array_equal(got.edit_videos, got.videos)
