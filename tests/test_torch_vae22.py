"""The port's Wan2.2 VAE (`videocof_torch/models/wan_vae22.py`, its
streaming twin `wan_vae22_streaming.py`) against the JAX package's on
`WAN22_VAE_TINY` with the same weights (carried by
`videocof_torch.convert`): the pixel patchify and the parameter-free
AvgDown3D / DupUp3D shortcuts, encode and decode, streaming equal to
whole-sequence (as `tests/test_wan_vae22.py` holds JAX's), the published
``Wan2.2_VAE.pth`` converter, and the chain-of-frames edit and
text-to-video through the Wan2.2 VAE. JAX's streaming chunk steps are
compiled (``jit_cache``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, WAN_TINY as J_WAN
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae22 as jv22
from videocof_tpu.models import wan_vae22_streaming as jstream
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_torch import convert
from videocof_torch.configs import (T5Config, WAN22_VAE_TINY, WanDiTConfig,
                                    Wan22VAEConfig)
from videocof_torch.models import wan_vae22 as v22
from videocof_torch.models import wan_vae22_streaming as stream
from videocof_torch.models import weights
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.pipeline import WanPipeline, latent_frame_count

from _published_layouts import vae22_published_name

torch.set_num_threads(1)

CFG = WAN22_VAE_TINY
J_CFG = jv22.WAN22_VAE_TINY
TOL = dict(rtol=1e-4, atol=1e-4)   # the port's VAE against JAX's (fp32)
SELF = dict(rtol=1e-5, atol=2e-5)  # streaming against whole-sequence (JAX's)
PROMPT = "remove the boat from the lake"


def _u8_close(got, want):
    """uint8 frames equal, but for one level on at most 1e-3 of the values
    (a float ulp may sit on a rounding boundary)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def pair():
    params = jv22.init_wan22_vae(jax.random.PRNGKey(0), J_CFG)
    # give the zero-initialized attention proj weights so the per-frame
    # attention is exercised
    for part, seed in (("encoder", 5), ("decoder", 6)):
        proj = params[part]["mid_attn"]["proj"]
        proj["kernel"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed), proj["kernel"].shape, jnp.float32)
    model = v22.Wan22VAE(CFG)
    model.load_state_dict(convert.vae_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model


def test_config_and_init_match_jax():
    assert CFG == convert.config_from(Wan22VAEConfig, J_CFG)
    assert Wan22VAEConfig() == convert.config_from(Wan22VAEConfig,
                                                   jv22.Wan22VAEConfig())
    want = convert.vae_from_jax(jax.tree.map(
        np.asarray, jv22.init_wan22_vae(jax.random.PRNGKey(0), J_CFG)))
    got = v22.init_wan22_vae(CFG, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.state_dict().items()} == {
        k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("shape", [(1, 3, 5, 8, 10), (2, 4, 1, 4, 6)])
def test_patchify2_round_trip_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = v22.patchify2(torch.tensor(x), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jv22.patchify2(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(v22.unpatchify2(got, 2).numpy(), x)


@pytest.mark.parametrize("T", [4, 5])
@pytest.mark.parametrize("ft,fs,cin,cout", [(1, 1, 8, 8), (1, 2, 8, 16),
                                            (2, 2, 8, 16), (2, 2, 8, 8)])
def test_avg_down_dup_up_match_jax(T, ft, fs, cin, cout):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, cin, T, 8, 8)).astype(np.float32)
    down = v22.avg_down3d(torch.tensor(x), cout, ft, fs)
    np.testing.assert_allclose(down.numpy(), np.asarray(
        jv22.avg_down3d(jnp.asarray(x), cout, ft, fs)), rtol=1e-6, atol=1e-6)
    z = rng.standard_normal((1, cout, T, 4, 4)).astype(np.float32)
    for trim in (True, False):
        np.testing.assert_array_equal(
            v22.dup_up3d(torch.tensor(z), cin, ft, fs, trim).numpy(),
            np.asarray(jv22.dup_up3d(jnp.asarray(z), cin, ft, fs, trim)))


@pytest.mark.parametrize("frames", [1, 9, 13])
def test_encode_matches_jax(pair, frames):
    params, model = pair
    x = np.random.default_rng(3).uniform(
        -1, 1, (1, 3, frames, 32, 32)).astype(np.float32)
    mu, lv = model.encode(torch.tensor(x))
    jmu, jlv = jv22.encode(params, J_CFG, jnp.asarray(x))
    assert mu.shape == (1, CFG.z_dim, latent_frame_count(frames), 2, 2)
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(jlv), **TOL)


@pytest.mark.parametrize("latent_frames", [1, 3])
def test_decode_matches_jax(pair, latent_frames):
    params, model = pair
    z = np.random.default_rng(4).standard_normal(
        (1, CFG.z_dim, latent_frames, 2, 2)).astype(np.float32)
    got = model.decode(torch.tensor(z)).detach()
    want = np.asarray(jv22.decode(params, J_CFG, jnp.asarray(z)))
    assert got.shape == (1, 3, 1 + 4 * (latent_frames - 1), 32, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_streaming_encode_equals_whole_and_jax(pair, chunk):
    params, model = pair
    x = np.random.default_rng(5).uniform(
        -1, 1, (1, 3, 13, 16, 16)).astype(np.float32)
    with torch.no_grad():
        whole = model.encode(torch.tensor(x))
        got = stream.encode_streaming(model, torch.tensor(x),
                                      chunk_latent=chunk)
    want = jstream.encode_streaming(params, J_CFG, jnp.asarray(x),
                                    jit_cache={}, chunk_latent=chunk)
    for g, w, j in zip(got, whole, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **SELF)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("T,chunk", [(3, 1), (3, 2), (4, 2), (1, 2)])
def test_streaming_decode_equals_whole_and_jax(pair, T, chunk):
    params, model = pair
    z = np.random.default_rng(6).standard_normal(
        (1, CFG.z_dim, T, 2, 2)).astype(np.float32)
    with torch.no_grad():
        whole = model.decode(torch.tensor(z))
        got = stream.decode_streaming(model, torch.tensor(z),
                                      chunk_latent=chunk)
        chunks = list(stream.decode_streaming_chunks(
            model, torch.tensor(z), chunk_latent=chunk))
        u8 = stream.decode_streaming_u8(model, torch.tensor(z),
                                        chunk_latent=chunk)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **SELF)
    np.testing.assert_allclose(
        torch.cat(chunks, dim=2).clamp(-1, 1).numpy(), got.numpy(), **SELF)
    np.testing.assert_allclose(got.numpy(), np.asarray(jstream.decode_streaming(
        params, J_CFG, jnp.asarray(z), jit_cache={}, chunk_latent=chunk)),
        **TOL)
    want_u8 = np.asarray(jstream.decode_streaming_u8(
        params, J_CFG, jnp.asarray(z), jit_cache={}, chunk_latent=chunk))
    assert u8.dtype == torch.uint8 and u8.shape == want_u8.shape
    _u8_close(u8.numpy(), want_u8)


def _published_state_dict(seed):
    rng = np.random.default_rng(seed)
    model = v22.Wan22VAE(CFG)
    return {vae22_published_name(k, CFG): rng.standard_normal(
        tuple(v.shape)).astype(np.float32)
        for k, v in model.state_dict().items()}


@pytest.mark.parametrize("prefix", ["", "model."])
def test_converter_matches_jax_on_the_published_layout(prefix):
    sd = {prefix + k: v for k, v in _published_state_dict(7).items()}
    want = convert.vae_from_jax(jax.tree.map(
        np.asarray, jv22.convert_wan22_vae_state_dict(sd, J_CFG)))
    got = v22.convert_wan22_vae_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG)
    assert set(got) == set(want) == set(v22.Wan22VAE(CFG).state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_load_vae_state_dict_reads_wan22_vae_pth(tmp_path):
    sd = _published_state_dict(8)
    path = str(tmp_path / "Wan2.2_VAE.pth")
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in sd.items()}, path)
    got = weights.load_vae_state_dict(path, CFG, torch.bfloat16)
    model = v22.Wan22VAE(CFG, dtype=torch.bfloat16)
    model.load_state_dict(got)
    want = jv22.convert_wan22_vae_state_dict(
        {k: np.asarray(torch.tensor(v).to(torch.bfloat16).float())
         for k, v in sd.items()}, J_CFG)
    for k, v in convert.vae_from_jax(jax.tree.map(np.asarray, want)).items():
        assert torch.equal(got[k].float(), v), k


# ------------------------------------------------------- through the pipeline

DCFG = J_WAN.replace(in_dim=J_CFG.z_dim, out_dim=J_CFG.z_dim,
                     text_dim=J_T5.dim)


@pytest.fixture(scope="module")
def pipelines(pair):
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    vp, vae = pair
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxPipeline(dp, DCFG, vp, J_CFG, tp, J_T5, dtype=jnp.float32)
    dit = WanDiT(convert.config_from(WanDiTConfig, DCFG))
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    pipe = WanPipeline(dit, vae, t5, dtype=torch.float32, device="cpu")
    return jpipe, pipe


def test_cot_edit_through_vae22_matches_jax(pipelines, monkeypatch):
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    jpipe, pipe = pipelines
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (1, 3, 9, 32, 32), dtype=np.uint8)
    cond = latent_frame_count(9)
    noise = rng.standard_normal((1, CFG.z_dim, cond + 1, 2, 2)
                                ).astype(np.float32)
    kw = dict(source_frames=9, reasoning_frames=4, num_inference_steps=2,
              noise=noise, output_latents=True)
    want = jpipe(video, PROMPT, fused_sampling=False, **kw)
    got = pipe(video, PROMPT, **kw)
    assert pipe._vae_streaming() is stream
    assert got.videos.shape == want.videos.shape == (1, 3, 10, 32, 32)
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3


def test_text_to_video_through_vae22_matches_jax(pipelines, monkeypatch):
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    jpipe, pipe = pipelines
    noise = np.random.default_rng(1).standard_normal(
        (1, CFG.z_dim, 3, 2, 2)).astype(np.float32)
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=2,
              guidance_scale=1.0, noise=noise, output_latents=True)
    want = jpipe.text_to_video(PROMPT, fused_sampling=False, **kw)
    got = pipe.text_to_video(PROMPT, **kw)
    assert got.videos.shape == want.videos.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3
