"""The port's int8 attention (kernel B4's plain version) against the JAX
package's `int8_flash_attention`, whose Pallas kernel runs in interpret mode
on the CPU. Inputs are numpy from a seed, handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.ops import attention as jax_attention
from videocof_tpu.ops.int8_attention import int8_flash_attention as jax_int8
from videocof_torch.ops import attention
from videocof_torch.ops import int8_attention as i8

torch.set_num_threads(1)

# fp32: the same int8 values and scales on both sides, then the online vs
# one-pass softmax. The inputs lie on a 1/128 grid, so the K means (sums in
# another order on each side) are exact and equal: a mean off by its last
# bit could move an element across a rounding boundary of x / scale, one
# int8 level, about 1e-3 in the output.
FP32_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16: P rounds to bf16 against a different running max (B1's tolerance)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _qkv(seed, B, Lq, Lk, N, D):
    rng = np.random.default_rng(seed)
    return [(np.round(rng.standard_normal(s) * 128) / 128).astype(np.float32)
            for s in ((B, Lq, N, D), (B, Lk, N, D), (B, Lk, N, D))]


def _mask(seed, B, Lk, fully_masked_row):
    m = np.random.default_rng(seed).random((B, Lk)) > 0.3
    m[:, 0] = True
    if fully_masked_row:
        m[-1] = False
    return m


def _jax(q, k, v, mask, dtype):
    q, k, v = (jnp.asarray(a, dtype) for a in (q, k, v))
    m = None if mask is None else jnp.asarray(mask)
    out = jax_int8(q, k, v, kv_mask=m, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, mask, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask)
    return i8.int8_flash_attention(q, k, v, kv_mask=m).float().numpy()


@pytest.mark.parametrize("L", [128, 200, 700])
@pytest.mark.parametrize("D", [128, 256])
def test_plain_matches_pallas_fp32(L, D):
    """Ragged lengths over the wrapper's key block (700 pads to 1024)."""
    q, k, v = _qkv(L + D, 2, L, L, 2, D)
    np.testing.assert_allclose(_port(q, k, v, None, torch.float32),
                               _jax(q, k, v, None, jnp.float32), **FP32_TOL)


@pytest.mark.parametrize("Lq,Lk,full_row", [(200, 200, False),
                                            (96, 700, True),
                                            (128, 130, True)])
def test_plain_matches_pallas_masked(Lq, Lk, full_row):
    """A key mask; a fully masked batch row averages V over the wrapper's
    padded key length (1024 for Lk = 700, 256 for 130)."""
    q, k, v = _qkv(Lq * Lk, 2, Lq, Lk, 2, 128)
    mask = _mask(Lk, 2, Lk, full_row)
    got = _port(q, k, v, mask, torch.float32)
    np.testing.assert_allclose(got, _jax(q, k, v, mask, jnp.float32),
                               **FP32_TOL)
    if full_row:
        Lkp = Lk + i8.key_padding(Lk)
        want = np.broadcast_to(v[-1:].sum(axis=1, keepdims=True) / Lkp,
                               got[-1:].shape)
        np.testing.assert_allclose(got[-1:], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("Lk", [1, 129, 513])
def test_plain_matches_pallas_at_tile_edges(Lk, masked):
    """Key lengths on and beside the GPU kernel's 128-key tiles and the
    wrapper's 512-key block (one key, one past a tile, one past a block),
    129 queries (one past a 128-row q tile), with and without a key mask:
    the plain version the kernel is held against on the card."""
    q, k, v = _qkv(7 * Lk + masked, 2, 129, Lk, 2, 128)
    mask = _mask(Lk, 2, Lk, False) if masked else None
    np.testing.assert_allclose(_port(q, k, v, mask, torch.float32),
                               _jax(q, k, v, mask, jnp.float32), **FP32_TOL)


@pytest.mark.parametrize("L,D", [(200, 128), (130, 256)])
def test_plain_matches_pallas_bf16(L, D):
    q, k, v = _qkv(3 * L + D, 2, L, L, 2, D)
    np.testing.assert_allclose(_port(q, k, v, None, torch.bfloat16),
                               _jax(q, k, v, None, jnp.bfloat16), **BF16_TOL)


# key lengths on and beside the one-CTA slab limits of a first design of
# the pre-pass (768 keys at D = 128, 384 at D = 256; 780 in 227 KB), around
# its stages (128 and 64 rows) and 512, and a long ragged one
PREPASS_LENGTHS = [1, 64, 65, 128, 129, 384, 385, 511, 512, 768, 769, 780,
                   781, 3001]


@pytest.mark.parametrize("Lk", PREPASS_LENGTHS)
@pytest.mark.parametrize("D,dtype", [(128, np.float32), (256, np.float32),
                                     (128, np.float16)])
def test_quantization_matches_jax_quant_tile(Lk, D, dtype):
    """B4's pre-pass in its plain version (``int8_quantize_k`` on the CPU)
    against JAX: the K mean against the wrapper's ``jnp.mean(kt.astype(
    f32), axis=1)`` (rtol 1e-6: the sums are exact on the 1/128 grid, and
    the two may differ in how the sum meets 1 / Lk), row scales of the
    centred K against `_quant_tile`'s (rtol 1e-6), int8 values at most one
    level off in at most 1e-3 of them (a value on a rounding boundary)."""
    from videocof_tpu.ops.int8_attention import _quant_tile
    _, k, _ = _qkv(Lk + D, 2, 1, Lk, 3, D)
    k = k.astype(dtype)
    ki, sk, mean = i8.int8_quantize_k(torch.from_numpy(k))
    kt = jnp.asarray(k).transpose(0, 2, 1, 3)
    want_mean = jnp.mean(kt.astype(jnp.float32), axis=2, keepdims=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean)[:, :, 0],
                               rtol=1e-6, atol=0)
    want_i, want_s = _quant_tile(kt.astype(jnp.float32) - want_mean)
    np.testing.assert_allclose(sk.numpy(), np.asarray(want_s)[..., 0],
                               rtol=1e-6, atol=0)
    assert np.abs(ki.numpy().astype(np.int32)
                  - np.asarray(want_i).astype(np.int32)).max() <= 1
    assert (ki.numpy() == np.asarray(want_i)).mean() > 0.999


@pytest.mark.parametrize("Lk", [511, 769, 3001])
def test_prepass_mean_counts_masked_keys(Lk):
    """The pre-pass takes no key mask: masked keys count in the mean, as in
    JAX's wrapper. B4's plain version under a key mask against the Pallas
    kernel at lengths on both sides of the slab limit."""
    q, k, v = _qkv(2 * Lk, 2, 8, Lk, 2, 128)
    mask = _mask(Lk + 1, 2, Lk, False)
    _, _, mean = i8.int8_quantize_k(torch.from_numpy(k))
    np.testing.assert_array_equal(
        mean.numpy(), i8.k_mean(torch.from_numpy(k)).numpy())
    np.testing.assert_allclose(mean.numpy(), k.mean(axis=1, dtype=np.float64),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(_port(q, k, v, mask, torch.float32),
                               _jax(q, k, v, mask, jnp.float32), **FP32_TOL)


@pytest.mark.parametrize("Lk", PREPASS_LENGTHS + [29640, 110000])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("slabs", [1, 24])
def test_prepass_plan(Lk, D, slabs):
    """The chunks the kernel cuts a slab into (264 resident CTAs, two an
    SM on 132 SMs): none empty, no more than the resident CTAs; of a
    stage's rows at most (32 KB of 16-bit K) unless the resident CTAs'
    stages cannot hold the slab; where they can, whole slabs a round of the
    grid, and no more rounds than the fewest chunks would need."""
    resident = 264
    chunks, rows = i8.prepass_plan(Lk, D, slabs, resident)
    stage_rows = i8.PREPASS_STAGE_BYTES // (2 * D)
    fewest = -(-Lk // stage_rows)
    assert chunks * rows >= Lk > (chunks - 1) * rows
    assert chunks <= resident
    assert (rows <= stage_rows) == (fewest <= resident)
    if fewest <= resident:
        per_round = resident // chunks
        assert -(-slabs // per_round) == -(-slabs // min(
            slabs, resident // fewest))
    else:
        assert rows == -(-Lk // resident)


def test_key_centring_invariance():
    """A constant added to every key moves the K mean by it and nothing else
    (the centring is exact up to fp32 rounding of the centred keys)."""
    q, k, v = _qkv(10, 1, 128, 128, 1, 128)
    shift = np.full((1, 1, 1, 128), 3.0, np.float32)
    a = _port(q, k, v, None, torch.float32)
    b = _port(q, k + shift, v, None, torch.float32)
    np.testing.assert_allclose(a, b, atol=5e-2)
    np.testing.assert_allclose(b, _jax(q, k + shift, v, None, jnp.float32),
                               **FP32_TOL)


def test_close_to_unquantized():
    """The JAX test's bound: cosine similarity with exact attention above
    0.999."""
    q, k, v = _qkv(11, 1, 200, 200, 2, 128)
    got = _port(q, k, v, None, torch.float32).ravel()
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    backend="naive")).ravel()
    assert np.dot(got, want) / (np.linalg.norm(got) * np.linalg.norm(want)) \
        > 0.999


def test_dispatch_and_raises():
    q, k, v = _qkv(12, 2, 96, 70, 2, 128)
    mask = _mask(12, 2, 70, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tm = torch.from_numpy(mask)
    np.testing.assert_array_equal(
        attention(tq, tk, tv, mask=tm, backend="int8").numpy(),
        i8.int8_flash_attention(tq, tk, tv, kv_mask=tm).numpy())
    np.testing.assert_allclose(
        attention(tq, tk, tv, mask=tm, backend="int8").numpy(),
        np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 mask=jnp.asarray(mask), backend="int8")),
        **FP32_TOL)
    x = torch.zeros(1, 64, 2, 64)
    with pytest.raises(NotImplementedError):       # JAX drops to XLA here
        attention(x, x, x, backend="int8")
    leaf = tq.clone().requires_grad_()
    with pytest.raises(NotImplementedError):       # no gradient, as in JAX
        attention(leaf, tk, tv, backend="int8")
    with torch.no_grad():
        attention(leaf, tk, tv, backend="int8")


def test_dit_through_int8_close_to_naive():
    """A head_dim-128 DiT in bf16 through the int8 backend against the naive
    one: relative L2 error 1.9e-3 measured (1.8e-3 at the 1.3B width with
    2 blocks), bounded by 1e-2, the gate `chip_smoke.py` holds the kernel's
    DiT to."""
    from videocof_torch.configs import WAN_TINY
    from videocof_torch.models.wan_dit import (init_wan_dit,
                                               make_rope_for_geometry)
    cfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2, in_dim=16,
                           out_dim=16)
    g = torch.Generator().manual_seed(0)
    dit = init_wan_dit(cfg, g, torch.bfloat16)
    x = torch.randn(1, 16, 5, 16, 16, generator=g).to(torch.bfloat16)
    ctx = torch.randn(1, 512, cfg.text_dim, generator=g).to(torch.bfloat16)
    cos, sin = (torch.as_tensor(a) for a in make_rope_for_geometry(
        cfg, (5, 8, 8), f_src=2, f_ground=1))
    t = torch.tensor([937.0])
    with torch.no_grad():
        got = dit(x, t, ctx, cos, sin, attn_backend="int8").float()
        want = dit(x, t, ctx, cos, sin, attn_backend="naive").float()
    assert ((got - want).norm() / want.norm()).item() <= 1e-2
