"""The port's streaming Wan2.1 VAE (`videocof_torch/models/wan_vae_streaming.py`)
against the JAX package's, and against the port's own whole-sequence VAE, on
the tiny config with the same weights (carried by `videocof_torch.convert`):
chunk sizes 1-4, clip lengths with and without a remainder chunk, the uint8
decode, and the pipeline's dispatch between the two VAEs. JAX's chunk steps
are compiled (``jit_cache``), as its pipeline runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.models import wan_vae_streaming as jstream
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models import wan_vae_streaming as stream
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)   # the port's VAE against JAX's (fp32)
SELF_REL = 1e-5                    # streaming against whole-sequence


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _u8_close(got, want):
    """uint8 frames equal, but for at most one level on at most 1e-3 of the
    values (a float ulp may sit on a rounding boundary)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def pair():
    params = jvae.init_wan_vae(jax.random.PRNGKey(0), J_VAE)
    # the reference zero-inits the attention proj; give it weights so the
    # per-frame attention is exercised
    for part, seed in (("encoder", 5), ("decoder", 6)):
        proj = params[part]["mid_attn"]["proj"]
        proj["kernel"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed), proj["kernel"].shape, jnp.float32)
    model = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    model.load_state_dict(convert.vae_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model


@pytest.fixture(scope="module")
def jit_cache():
    """JAX's compiled chunk steps, shared by the tests (they retrace per
    shape): eager JAX takes seconds a call."""
    return {}


@pytest.mark.parametrize("chunk", [1, 2, 3, 4])
@pytest.mark.parametrize("frames", [9, 13])
def test_encode_streaming_matches_jax_and_whole(pair, jit_cache, frames,
                                               chunk):
    params, model = pair
    x = np.random.default_rng(frames).uniform(
        -1, 1, (1, 3, frames, 16, 16)).astype(np.float32)
    want, want_lv = jstream.encode_streaming(params, J_VAE, jnp.asarray(x),
                                             jit_cache=jit_cache,
                                             chunk_latent=chunk)
    with torch.no_grad():
        got, got_lv = stream.encode_streaming(model, torch.from_numpy(x),
                                              chunk_latent=chunk)
        whole, whole_lv = model.encode(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 4, 1 + (frames - 1) // 4, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lv.numpy(), np.asarray(want_lv), **TOL)
    assert _rel(got, whole) <= SELF_REL
    assert _rel(got_lv, whole_lv) <= SELF_REL


def test_encode_streaming_needs_whole_latent_frames(pair):
    with pytest.raises(ValueError, match="1 \\+ 4k"):
        stream.encode_streaming(pair[1], torch.zeros(1, 3, 8, 16, 16))


# (latent frames, chunk): 5 = 1 + 4 divides by 1, 2 and 4 and leaves a
# remainder of 1 at chunk 3; 6 = 1 + 5 leaves remainders at 2, 3 and 4
DECODE_CASES = [(5, 1), (5, 2), (5, 3), (5, 4), (6, 2), (6, 3), (6, 4)]


@pytest.mark.parametrize("T,chunk", DECODE_CASES)
def test_decode_streaming_matches_jax_and_whole(pair, jit_cache, T, chunk):
    params, model = pair
    z = np.random.default_rng(T + 10 * chunk).standard_normal(
        (1, 4, T, 2, 2)).astype(np.float32)
    want_chunks = list(jstream.decode_streaming_chunks(
        params, J_VAE, jnp.asarray(z), jit_cache=jit_cache,
        chunk_latent=chunk))
    want = jnp.clip(jnp.concatenate(want_chunks, axis=2), -1.0, 1.0)
    with torch.no_grad():
        got = stream.decode_streaming(model, torch.from_numpy(z),
                                      chunk_latent=chunk)
        chunks = list(stream.decode_streaming_chunks(
            model, torch.from_numpy(z), chunk_latent=chunk))
        whole = model.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (1, 3, 1 + 4 * (T - 1), 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert _rel(got, whole) <= SELF_REL
    # the generator yields JAX's chunks, unclipped, in order
    assert [c.shape[2] for c in chunks] == [c.shape[2] for c in want_chunks]
    for c, w in zip(chunks, want_chunks):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("T,chunk", [(1, 3), (5, 3), (7, 3)])
def test_decode_streaming_u8_matches_jax_and_whole(pair, jit_cache, T,
                                                   chunk):
    params, model = pair
    z = np.random.default_rng(T).standard_normal(
        (1, 4, T, 2, 2)).astype(np.float32)
    want = np.asarray(jstream.decode_streaming_u8(
        params, J_VAE, jnp.asarray(z), jit_cache=jit_cache,
        chunk_latent=chunk,
        compute_dtype=jnp.float32))
    with torch.no_grad():
        got = stream.decode_streaming_u8(model, torch.from_numpy(z),
                                         chunk_latent=chunk,
                                         compute_dtype=torch.float32)
        whole = model.decode(torch.from_numpy(z))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    _u8_close(got.numpy(), want)
    _u8_close(got.numpy(), torch.round(whole * 127.5 + 127.5).numpy())


def test_pipeline_vae_dispatch(pair, monkeypatch):
    """JAX's threshold and chunks; the pipeline's encode, decode and uint8
    decode on both sides of the threshold run the VAE it should pick."""
    params, model = pair
    dcfg = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                         text_dim=J_T5.dim)
    jpipe = JaxPipeline(None, dcfg, params, J_VAE, None, J_T5)
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    pipe = WanPipeline(WanDiT(convert.config_from(WanDiTConfig, dcfg)), model,
                       t5, dtype=torch.float32, device="cpu")
    assert (pipe.vae_streaming_threshold_frames, pipe.vae_decode_chunk,
            pipe.vae_encode_chunk) == (jpipe.vae_streaming_threshold_frames,
                                       jpipe.vae_decode_chunk,
                                       jpipe.vae_encode_chunk) == (2, 3, 4)
    calls = []
    for name in ("encode_streaming", "decode_streaming",
                 "decode_streaming_u8"):
        real = getattr(stream, name)
        monkeypatch.setattr(stream, name, lambda *a, _r=real, _n=name, **k: (
            calls.append((_n, k["chunk_latent"])), _r(*a, **k))[1])
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for frames in (1, 13):
            x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, frames, 16, 16))
                                 .astype(np.float32))
            calls.clear()
            got = pipe.vae_encode(x)
            assert calls == ([("encode_streaming", 4)] if frames > 2 else [])
            want = model.encode(x)[0]
            assert _rel(got, want) <= SELF_REL
        for T in (2, 6):
            z = torch.from_numpy(rng.standard_normal((1, 4, T, 2, 2))
                                 .astype(np.float32))
            calls.clear()
            got, u8 = pipe.vae_decode(z), pipe.decode_to_u8(z)
            assert calls == ([("decode_streaming", 3),
                              ("decode_streaming_u8", 3)] if T > 2 else [])
            want = model.decode(z)
            assert _rel(got, want) <= SELF_REL
            _u8_close(u8.numpy(), torch.round(want * 127.5 + 127.5).numpy())
