"""The port's CogVideoX transformer and causal 3D VAE against the JAX
package on the CPU, on the same weights (carried by
`videocof_torch.convert`) and numpy inputs, in float32: the forward of the
2B layout (3D sincos positions, no temporal patch), of the 5B layout
(RoPE on the video tokens, ``patch_size_t`` None) and of the 1.5 layout
(``patch_size_t`` 2), one block, the position tables, the VAE's encode and
decode. Tolerances: the position tables exact (both float64 numpy), the
modules 1e-5 relative and absolute (the port's naive attention, the plain
version of kernel B1), the VAE's pixels 2e-5 (eight stages of fp32
convolutions in other summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.models import cogvideox as jcog
from videocof_tpu.models import cogvideox_vae as jcvae
from videocof_torch import convert
from videocof_torch.models import cogvideox as cog

from _family_models import J_COG, cogvideox, cogvideox_vae, on_device

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
VAE_TOL = dict(rtol=2e-5, atol=2e-5)
T = torch.from_numpy


def _inputs(cfg, B=2, F=3, H=8, W=12, Lt=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, cfg.in_channels, H, W)).astype(np.float32)
    ctx = rng.standard_normal((B, Lt, cfg.text_embed_dim)).astype(np.float32)
    t = rng.uniform(0, 999, B).astype(np.float32)
    return x, ctx, t


@pytest.mark.parametrize("layout", ["2b", "5b"])
@pytest.mark.parametrize("B", [1, 2])
def test_forward_matches_jax(layout, B):
    p, m = cogvideox(layout)
    x, ctx, t = _inputs(J_COG[layout], B=B)
    want = jax.jit(jcog.cogvideox_forward, static_argnums=1)(
        on_device(p), J_COG[layout], jnp.asarray(x), jnp.asarray(ctx),
        jnp.asarray(t))
    with torch.no_grad():
        got = m(T(x), T(ctx), T(t))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_15_layout_temporal_patch():
    """The 1.5 layout: 2 frames a patch in time (features (C, pt, p, p))."""
    jcfg = J_COG["5b"].replace(patch_size_t=2)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jcog.init_cogvideox(jax.random.PRNGKey(3), jcfg))
    m = cog.CogVideoX(convert.config_from(cog.CogVideoXConfig, jcfg))
    m.load_state_dict(convert.cogvideox_from_jax(p))
    x, ctx, t = _inputs(jcfg, F=4)
    want = jax.jit(jcog.cogvideox_forward, static_argnums=1)(
        on_device(p), jcfg, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(t))
    with torch.no_grad():
        got = m(T(x), T(ctx), T(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["2b", "5b"])
def test_block_matches_jax(layout):
    """One block on fp32 streams, RoPE on the video tokens for the 5B."""
    cfg = J_COG[layout]
    p, m = cogvideox(layout)
    rng = np.random.default_rng(1)
    D = cfg.inner_dim
    vid = rng.standard_normal((2, 24, D)).astype(np.float32)
    txt = rng.standard_normal((2, 8, D)).astype(np.float32)
    temb = rng.standard_normal((2, cfg.time_embed_dim)).astype(np.float32)
    rope = None
    if cfg.use_rotary_positional_embeddings:
        rope = jcog.get_3d_rope_cos_sin(cfg, (2, 3, 4))
    bp = jax.tree.map(lambda a: jnp.asarray(a[0]), p["blocks"])
    wv, wt = jcog.cog_block_apply(
        bp, cfg, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(temb),
        None if rope is None else tuple(jnp.asarray(a) for a in rope))
    with torch.no_grad():
        gv, gt = cog.cog_block_apply(
            m.blocks[0], m.cfg, T(vid), T(txt), T(temb),
            None if rope is None else tuple(T(a) for a in rope))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


@pytest.mark.parametrize("grid,scales", [((2, 3, 4), (1.875, 1.0)),
                                         ((13, 30, 45), (1.875, 1.0)),
                                         ((1, 4, 4), (1.0, 2.0))])
def test_sincos_table_exact(grid, scales):
    f, h, w = grid
    np.testing.assert_array_equal(
        cog.get_3d_sincos_pos_embed(1920, (h, w), f, *scales),
        jcog.get_3d_sincos_pos_embed(1920, (h, w), f, *scales))


@pytest.mark.parametrize("grid", [(2, 3, 4), (13, 30, 45)])
def test_rope_tables_exact(grid):
    for cfg in (J_COG["5b"], jcog.COGVIDEOX_5B):
        mine = cog.get_3d_rope_cos_sin(cfg, grid)
        theirs = jcog.get_3d_rope_cos_sin(cfg, grid)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)


def test_configs_match_jax():
    for name in ("COGVIDEOX_2B", "COGVIDEOX_5B", "COGVIDEOX_TINY"):
        assert getattr(cog, name) == convert.config_from(
            cog.CogVideoXConfig, getattr(jcog, name)), name


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_vae_encode_matches_jax(frames):
    p, vae = cogvideox_vae()
    video = np.random.default_rng(frames).uniform(
        -1, 1, (1, 3, frames, 16, 24)).astype(np.float32)
    mu, lv = jax.jit(jcvae.encode, static_argnums=1)(
        on_device(p), jcvae.COGVIDEOX_VAE_TINY, jnp.asarray(video))
    with torch.no_grad():
        gmu, glv = vae.encode(T(video))
    np.testing.assert_allclose(gmu.numpy(), np.asarray(mu), **VAE_TOL)
    np.testing.assert_allclose(glv.numpy(), np.asarray(lv), **VAE_TOL)


@pytest.mark.parametrize("latent_frames", [1, 2, 3])
def test_vae_decode_matches_jax(latent_frames):
    """Odd and even latent frame counts: the first frame resized apart
    from the rest in SpatialNorm3D, the temporal upsample keeping it."""
    p, vae = cogvideox_vae()
    z = np.random.default_rng(latent_frames).standard_normal(
        (1, 4, latent_frames, 2, 3)).astype(np.float32)
    want = jax.jit(jcvae.decode, static_argnums=1)(
        on_device(p), jcvae.COGVIDEOX_VAE_TINY, jnp.asarray(z))
    with torch.no_grad():
        got = vae.decode(T(z))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAE_TOL)


@pytest.mark.parametrize("strided", [False, True])
def test_vae_group_norm_per_group_in_bf16(strided):
    """In bf16 the VAE's GroupNorm runs one group at a time with two fp32
    reductions (no fp32 copy of a whole activation): within one bf16
    rounding of the whole tensor's fp32 GroupNorm (the reductions' order
    differs), on a contiguous input and on a strided view (the per-frame
    convolutions hand it transposed tensors)."""
    from videocof_torch.models import cogvideox_vae as cv
    x = (3.0 * torch.randn(2, 32, 3, 8, 8, generator=torch.Generator()
                           .manual_seed(0)) + 1.0).to(torch.bfloat16)
    if strided:
        x = x.transpose(2, 3)
    gn = cv._GN(32, None)
    with torch.no_grad():
        gn.scale.uniform_(0.5, 1.5)
        gn.bias.uniform_(-0.5, 0.5)
        got = cv.group_norm(x, gn, 8, 1e-6)
        want = torch.nn.functional.group_norm(x.float(), 8, gn.scale,
                                              gn.bias, 1e-6)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * want.abs().clamp_min(2.0 ** -6)
    assert ((got.float() - want).abs() <= ulp).all()
