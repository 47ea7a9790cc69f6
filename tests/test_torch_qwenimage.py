"""The port's QwenImage transformer and its VAE (the Wan2.1 VAE under
diffusers' names) against the JAX package on the CPU, on the same weights
(carried by `videocof_torch.convert`) and numpy inputs, in float32:
`qwen_position_ids`, one block, the forward without a text mask (B1's
unmasked path on the card, as the pipeline runs it) and with one (the
joint key mask, B1's key-masked path), the diffusers-layout VAE converter
and the one-frame decode. Tolerances: the ids exact, the modules 1e-5
relative and absolute (the port's naive attention, the plain version of
kernel B1), the VAE converter bit for bit, its decode 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.models import qwenimage as jqwen
from videocof_tpu.models import qwenimage_vae as jqvae
from videocof_tpu.models import wan_vae as jwvae
from videocof_torch import convert
from videocof_torch.models import qwenimage as qwen_lib
from videocof_torch.models import qwenimage_vae
from videocof_torch.utils import checkpoint

from _family_models import J_QVAE, QVAE, on_device, qwen_vae, qwenimage

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy
CFG = jqwen.QWENIMAGE_TINY


@pytest.mark.parametrize("grid", [(1, 4, 4), (1, 5, 7), (2, 3, 6),
                                  (1, 64, 64)])
@pytest.mark.parametrize("scale_rope", [True, False])
def test_position_ids_exact(grid, scale_rope):
    wi, wt = jqwen.qwen_position_ids(grid, 11, scale_rope=scale_rope)
    gi, gt = qwen_lib.qwen_position_ids(grid, 11, scale_rope=scale_rope)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def test_block_matches_jax():
    p, m = qwenimage(cfg=CFG)
    rng = np.random.default_rng(2)
    D = CFG.inner_dim
    img = rng.standard_normal((2, 16, D)).astype(np.float32)
    txt = rng.standard_normal((2, 6, D)).astype(np.float32)
    temb = rng.standard_normal((2, D)).astype(np.float32)
    ii, ti = jqwen.qwen_position_ids((1, 4, 4), 6)
    from videocof_tpu.models.flux import rope_from_ids as jrope
    rope = jrope(CFG, jnp.concatenate([ti, ii]))
    bp = jax.tree.map(lambda a: jnp.asarray(a[0]), p["blocks"])
    wi, wt = jqwen.qwen_block_apply(bp, CFG, jnp.asarray(img),
                                    jnp.asarray(txt), jnp.asarray(temb), rope)
    gii, gti = qwen_lib.qwen_position_ids((1, 4, 4), 6)
    with torch.no_grad():
        gi, gt = qwen_lib.qwen_block_apply(
            m.blocks[0], m.cfg, T(img), T(txt), T(temb),
            qwen_lib.rope_from_ids(m.cfg, torch.cat([gti, gii])))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(masked):
    """Without a text mask (the pipeline's call) and with one whose first
    row pads its last two text tokens."""
    p, m = qwenimage(cfg=CFG)
    rng = np.random.default_rng(3)
    B, Lt = 2, 6
    x = rng.standard_normal((B, 16, CFG.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((B, Lt, CFG.joint_attention_dim)).astype(
        np.float32)
    t = np.array([0.9, 0.3], np.float32)
    mask = (np.array([[1, 1, 1, 1, 0, 0], [1] * 6], bool) if masked
            else None)
    ii, ti = jqwen.qwen_position_ids((1, 4, 4), Lt)
    gii, gti = qwen_lib.qwen_position_ids((1, 4, 4), Lt)
    want = jax.jit(jqwen.qwenimage_forward, static_argnums=1)(
        on_device(p), CFG, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(t),
        ii, ti, None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = m(T(x), T(ctx), T(t), gii, gti,
                encoder_hidden_states_mask=None if mask is None else T(mask))
    assert got.shape == (B, 16, 4 * CFG.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_configs_match_jax():
    for name in ("QWENIMAGE", "QWENIMAGE_TINY"):
        assert getattr(qwen_lib, name) == convert.config_from(
            qwen_lib.QwenImageConfig, getattr(jqwen, name)), name
    assert qwen_lib.QWEN_FP8_EXCLUDE == jqwen.QWEN_FP8_EXCLUDE
    assert qwenimage_vae.QWENIMAGE_VAE_CONFIG == convert.config_from(
        type(QVAE), jqvae.QWENIMAGE_VAE_CONFIG)


def _published_vae():
    """A diffusers-layout VAE state dict (the port's writer) and the JAX
    params of the same draw."""
    p, vae = qwen_vae()
    sd = checkpoint.export_family_state_dict(
        vae, qwenimage_vae.convert_qwenimage_vae_state_dict, QVAE)
    return p, vae, sd


def test_vae_converter_matches_jax():
    """JAX's converter and the port's read one diffusers-layout state dict
    into the same tensors, bit for bit."""
    p, vae, sd = _published_vae()
    jtree = jqvae.convert_qwenimage_vae_state_dict(
        {k: v.numpy() for k, v in sd.items()}, J_QVAE)
    want = convert.vae_from_jax(jtree)
    got = qwenimage_vae.convert_qwenimage_vae_state_dict(sd, QVAE)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_one_frame_decode_matches_jax():
    p, vae, sd = _published_vae()
    vae2 = qwenimage_vae.WanVAE(QVAE)
    vae2.load_state_dict(qwenimage_vae.convert_qwenimage_vae_state_dict(
        sd, QVAE))
    z = np.random.default_rng(4).standard_normal((2, 4, 1, 4, 6)).astype(
        np.float32)
    want = jax.jit(jwvae.decode, static_argnums=1)(on_device(p), J_QVAE,
                                                   jnp.asarray(z))
    with torch.no_grad():
        got = vae2.decode(T(z))
    assert got.shape == (2, 3, 1, 32, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
