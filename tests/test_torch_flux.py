"""The port's Flux transformer and 2D KL-VAE decoder against the JAX package
on the CPU, on the same weights (carried by `videocof_torch.convert`) and
numpy inputs, in float32: `rope_from_ids`, the timestep sinusoid, the
double- and single-stream blocks, the forward with and without the guidance
embedding, the decoder with and without its post-quant conv and mid-block
attention, and `decode_latents`. Tolerances: the RoPE tables 1e-6 (fp32
cos/sin of angles up to 300 rad), the modules 1e-5 relative and absolute
(the port's naive attention, the plain version of kernel B1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.models import flux as jflux
from videocof_tpu.models import kl_vae as jkl
from videocof_torch import convert
from videocof_torch.models import flux as flux_lib
from videocof_torch.models import kl_vae

from _family_models import flux, kl, on_device

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
T = torch.from_numpy
CFG = jflux.FLUX_TINY


@pytest.mark.parametrize("seed,lo,hi", [(0, 0, 64), (1, -40, 300),
                                        (2, 0, 4096)])
def test_rope_from_ids(seed, lo, hi):
    ids = np.random.default_rng(seed).integers(lo, hi, (37, 3)).astype(
        np.float32)
    for cfg in (CFG, jflux.FLUX_DEV):
        wc, ws = jflux.rope_from_ids(cfg, jnp.asarray(ids))
        gc, gs = flux_lib.rope_from_ids(cfg, T(ids))
        assert gc.shape == (37, cfg.attention_head_dim // 2)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **ROPE_TOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **ROPE_TOL)


def test_sincos_256():
    """Timesteps and Flux-dev's guidance (3.5) scaled by 1000. XLA's fp32
    exp and torch's differ by one ulp in some of the 128 frequencies, so
    each row holds to 1e-6 plus one ulp of the largest frequency (1.2e-7)
    times its angle's factor."""
    t = np.array([0.0, 1.5, 999.0, 3500.0], np.float32)
    got = flux_lib._sincos_256(T(t)).numpy()
    want = np.asarray(jflux._sincos_256(jnp.asarray(t)))
    bound = 1e-6 + 1.2e-7 * np.abs(t)[:, None]
    assert (np.abs(got - want) <= bound).all()


def _streams(seed=1, B=2, Li=16, Lt=6):
    rng = np.random.default_rng(seed)
    D = CFG.inner_dim
    img = rng.standard_normal((B, Li, D)).astype(np.float32)
    txt = rng.standard_normal((B, Lt, D)).astype(np.float32)
    temb = rng.standard_normal((B, D)).astype(np.float32)
    ids = rng.integers(0, 8, (Lt + Li, 3)).astype(np.float32)
    return img, txt, temb, ids


def test_dual_block():
    p, m = flux(cfg=CFG)
    img, txt, temb, ids = _streams()
    rope = jflux.rope_from_ids(CFG, jnp.asarray(ids))
    bp = jax.tree.map(lambda a: jnp.asarray(a[1]), p["blocks"])
    wi, wt = jflux.flux_dual_block(bp, CFG, jnp.asarray(img),
                                   jnp.asarray(txt), jnp.asarray(temb), rope)
    with torch.no_grad():
        gi, gt = flux_lib.flux_dual_block(
            m.blocks[1], m.cfg, T(img), T(txt), T(temb),
            flux_lib.rope_from_ids(m.cfg, T(ids)))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


def test_single_block():
    """Attention and the MLP in parallel, concatenated before proj_out."""
    p, m = flux(cfg=CFG)
    img, txt, temb, ids = _streams()
    x = np.concatenate([txt, img], axis=1)
    rope = jflux.rope_from_ids(CFG, jnp.asarray(ids))
    bp = jax.tree.map(lambda a: jnp.asarray(a[0]), p["single_blocks"])
    want = jflux.flux_single_block(bp, CFG, jnp.asarray(x),
                                   jnp.asarray(temb), rope)
    with torch.no_grad():
        got = flux_lib.flux_single_block(
            m.single_blocks[0], m.cfg, T(x), T(temb),
            flux_lib.rope_from_ids(m.cfg, T(ids)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("guidance", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_forward_matches_jax(guidance, B):
    cfg = CFG.replace(guidance_embeds=guidance)
    p, m = flux(cfg=cfg)
    rng = np.random.default_rng(B)
    Li, Lt = 16, 6
    x = rng.standard_normal((B, Li, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((B, Lt, cfg.joint_attention_dim)).astype(
        np.float32)
    pooled = rng.standard_normal((B, cfg.pooled_projection_dim)).astype(
        np.float32)
    t = rng.uniform(0, 1, B).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    iids = np.stack([np.zeros_like(yy), yy, xx], -1).reshape(Li, 3).astype(
        np.float32)
    tids = np.zeros((Lt, 3), np.float32)
    g = np.full((B,), 3.5, np.float32) if guidance else None
    want = jax.jit(jflux.flux_forward, static_argnums=1)(
        on_device(p), cfg, jnp.asarray(x), jnp.asarray(ctx),
        jnp.asarray(pooled), jnp.asarray(t), jnp.asarray(iids),
        jnp.asarray(tids), None if g is None else jnp.asarray(g))
    with torch.no_grad():
        got = m(T(x), T(ctx), T(pooled), T(t), T(iids), T(tids),
                guidance=None if g is None else T(g))
    assert got.shape == (B, Li, cfg.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_configs_match_jax():
    for name in ("FLUX_DEV", "FLUX_TINY"):
        assert getattr(flux_lib, name) == convert.config_from(
            flux_lib.FluxConfig, getattr(jflux, name)), name
    assert flux_lib.FLUX_FP8_EXCLUDE == jflux.FLUX_FP8_EXCLUDE
    for name in ("FLUX_KL_VAE", "SD_KL_VAE", "KL_VAE_TINY"):
        assert getattr(kl_vae, name) == convert.config_from(
            kl_vae.KLVAEConfig, getattr(jkl, name)), name


@pytest.mark.parametrize("post_quant", [False, True])
@pytest.mark.parametrize("attn", [False, True])
def test_kl_decoder_matches_jax(post_quant, attn):
    cfg = jkl.KL_VAE_TINY.replace(use_post_quant_conv=post_quant,
                                  mid_block_add_attention=attn)
    p, vae = kl(cfg)
    z = np.random.default_rng(0).standard_normal((2, 4, 6, 8)).astype(
        np.float32)
    want = jax.jit(jkl.decode, static_argnums=1)(on_device(p), cfg,
                                                 jnp.asarray(z))
    with torch.no_grad():
        got = vae.decode(T(z))
    assert got.shape == (2, 3, 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_latents_and_decode_fn():
    """The scale and shift before the decode, the clip after it."""
    p, vae = kl()
    z = 3.0 * np.random.default_rng(1).standard_normal((1, 4, 6, 8)).astype(
        np.float32)
    want = jkl.decode_latents(on_device(p), jkl.KL_VAE_TINY, jnp.asarray(z))
    got = kl_vae.make_decode_fn(vae)(T(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.min() >= -1.0 and got.max() <= 1.0
