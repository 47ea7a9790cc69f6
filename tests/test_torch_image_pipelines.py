"""The port's CogVideoX, QwenImage and Flux pipelines end to end against the
JAX package's on the CPU, on the same tiny weights (carried by
`videocof_torch.convert`), text embeddings and starting latents (JAX's
draw, handed to the port through ``latents=``): guidance on and off, the
VAE and no-VAE branches, and CogVideoX's ``fused=True`` (JAX's one scan
over the DDIM plan; the port's stepwise loop). Tolerance 2e-4, the
pipelines' (`tests/test_torch_vace.py`), on pixels in [0, 1] or latents."""

import numpy as np
import pytest
import torch

from videocof_tpu.pipeline import image_pipelines as jip
from videocof_torch.pipeline import image_pipelines as ip

from _family_models import (J_FLUX, J_QWEN, cog_pipelines, flux_pipelines,
                            jax_latents, qwen_pipelines, text)

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
HW = dict(height=32, width=32)


@pytest.mark.parametrize("cfg", [True, False])
@pytest.mark.parametrize("layout", ["2b", "5b"])
def test_cogvideox_matches_jax(cfg, layout):
    jpipe, pipe = cog_pipelines(layout)
    emb, neg = text(0, 1, 8, 32), text(1, 1, 8, 32)
    kw = dict(height=32, width=48, num_frames=9, num_inference_steps=3,
              guidance_scale=6.0, seed=3)
    want = jpipe(emb, neg if cfg else None, **kw)
    got = pipe(emb, neg if cfg else None,
               latents=jax_latents(3, (1, 3, 4, 4, 6)), **kw)
    assert got.shape == want.shape == (1, 3, 9, 32, 48)
    assert got.dtype == np.float32 and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, **TOL)


def test_cogvideox_fused_equals_stepwise():
    """JAX holds its fused trajectory equal to its stepwise one; the port
    takes ``fused=True`` and runs the stepwise loop: the same output as
    its own ``fused=False``, and JAX's fused output within 2e-4."""
    jpipe, pipe = cog_pipelines()
    emb, neg = text(0, 1, 8, 32), text(1, 1, 8, 32)
    kw = dict(height=32, width=48, num_frames=9, num_inference_steps=4,
              guidance_scale=6.0, seed=5)
    lat = jax_latents(5, (1, 3, 4, 4, 6))
    want = jpipe(emb, neg, fused=True, **kw)
    fused = pipe(emb, neg, fused=True, latents=lat, **kw)
    stepwise = pipe(emb, neg, fused=False, latents=lat, **kw)
    np.testing.assert_array_equal(fused, stepwise)
    np.testing.assert_allclose(fused, want, **TOL)


@pytest.mark.parametrize("cfg", [True, False])
@pytest.mark.parametrize("with_vae", [True, False])
def test_qwenimage_matches_jax(cfg, with_vae):
    """True CFG (two forwards a step) or none; one-frame Wan-VAE decode
    to [0, 1], or the unpacked latents."""
    jpipe, pipe = qwen_pipelines(with_vae)
    emb = text(2, 1, 6, J_QWEN.joint_attention_dim)
    neg = text(3, 1, 6, J_QWEN.joint_attention_dim)
    kw = dict(num_inference_steps=3, true_cfg_scale=4.0, seed=7, **HW)
    want = jpipe(emb, neg if cfg else None, **kw)
    got = pipe(emb, neg if cfg else None,
               latents=jax_latents(7, (1, J_QWEN.in_channels // 4, 4, 4)),
               **kw)
    assert got.shape == want.shape == ((1, 3, 32, 32) if with_vae
                                       else (1, 4, 4, 4))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("guidance", [True, False])
@pytest.mark.parametrize("with_vae", [True, False])
def test_flux_matches_jax(guidance, with_vae):
    """Guidance-distilled (the guidance embedding) or not; pixels through
    the KL-VAE's ``decode_fn``, or the unpacked latents."""
    jpipe, pipe = flux_pipelines(guidance, with_vae)
    cfg = J_FLUX[guidance]
    emb = text(4, 1, 6, cfg.joint_attention_dim)
    pooled = text(5, 1, 1, cfg.pooled_projection_dim)[:, 0]
    kw = dict(num_inference_steps=3, guidance=3.5, seed=9, **HW)
    want = jpipe(emb, pooled, **kw)
    got = pipe(emb, pooled,
               latents=jax_latents(9, (1, cfg.in_channels // 4, 4, 4)), **kw)
    assert got.shape == want.shape == ((1, 3, 8, 8) if with_vae
                                       else (1, 4, 4, 4))
    np.testing.assert_allclose(got, want, **TOL)


def test_pack_unpack_match_jax():
    import jax.numpy as jnp
    z = np.random.default_rng(0).standard_normal((2, 3, 4, 6)).astype(
        np.float32)
    packed = ip._pack_latents(torch.from_numpy(z))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jip._pack_latents(
                                      jnp.asarray(z))))
    np.testing.assert_array_equal(
        ip._unpack_latents(packed, 4, 6).numpy(), z)


def test_seeded_draws_and_wrong_latents():
    """Without ``latents`` each pipeline draws from a generator seeded with
    ``seed``: one seed, one output; a start of the wrong shape raises."""
    _, pipe = flux_pipelines(True, with_vae=False)
    emb = text(4, 1, 6, J_FLUX[True].joint_attention_dim)
    pooled = text(5, 1, 1, J_FLUX[True].pooled_projection_dim)[:, 0]
    a = pipe(emb, pooled, num_inference_steps=2, seed=1, **HW)
    b = pipe(emb, pooled, num_inference_steps=2, seed=1, **HW)
    c = pipe(emb, pooled, num_inference_steps=2, seed=2, **HW)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="latents"):
        pipe(emb, pooled, num_inference_steps=2, latents=np.zeros((1, 4)),
             **HW)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pipe = flux_pipelines(True, with_vae=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ip.FluxPipeline(pipe.dit)
