"""The port's attention against the JAX package's: the plain version of the
CUDA flash kernel vs the Pallas kernel in interpret mode, and the backend
dispatch. Inputs are float32 numpy from a seed, handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.ops import attention as jax_attention
from videocof_tpu.ops.flash_attention import flash_attention as jax_flash
from videocof_torch.ops import attention
from videocof_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_reference)

torch.set_num_threads(1)

# fp32: the two differ only in summation order (online vs one-pass softmax)
FP32_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16: probabilities round to bf16 against a different running max
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _qkv(seed, B, Lq, Lk, N, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
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
    out = jax_flash(q, k, v, kv_mask=m, block_q=128, block_k=128,
                    interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, mask, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask)
    return flash_attention_reference(q, k, v, kv_mask=m).float().numpy()


# Lk fills the Pallas test block (128) wherever a row is fully masked: the
# port pads as the wrapper's default block does (see the ragged test below).
@pytest.mark.parametrize("Lq,Lk,masked,full_row", [
    (128, 128, False, False), (300, 300, False, False),
    (256, 130, False, False), (128, 128, True, True),
    (300, 300, True, False), (256, 130, True, False), (130, 256, True, True),
])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_matches_pallas_fp32(Lq, Lk, masked, full_row, D):
    q, k, v = _qkv(Lq + Lk + D, 2, Lq, Lk, 2, D)
    mask = _mask(D, 2, Lk, full_row) if masked else None
    np.testing.assert_allclose(_port(q, k, v, mask, torch.float32),
                               _jax(q, k, v, mask, jnp.float32), **FP32_TOL)


@pytest.mark.parametrize("Lq,Lk,masked", [(128, 128, False), (300, 300, True),
                                          (256, 130, False)])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_matches_pallas_bf16(Lq, Lk, masked, D):
    q, k, v = _qkv(7 + D, 2, Lq, Lk, 2, D)
    mask = _mask(D, 2, Lk, False) if masked else None
    np.testing.assert_allclose(_port(q, k, v, mask, torch.bfloat16),
                               _jax(q, k, v, mask, jnp.bfloat16), **BF16_TOL)


def test_fully_masked_row_is_mean_of_v():
    """A fully masked row is the sum of V over the Pallas wrapper's padded
    key length (its padded keys weigh as the masked ones): the mean of V
    when Lk fills its block, sum(V) / 256 for Lk = 130."""
    for Lk, Lkp in ((130, 256), (128, 128), (1100, 2048)):
        q, k, v = _qkv(3, 1, 40, Lk, 2, 64)
        mask = torch.zeros(1, Lk, dtype=torch.bool)
        out = flash_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                        kv_mask=mask)
        want = np.broadcast_to(v.sum(axis=1, keepdims=True) / Lkp, out.shape)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fully_masked_row_with_ragged_keys_vs_pallas():
    """A fully masked row over a ragged key length, at the Pallas wrapper's
    default blocks: the kernel gives its padded keys the same -1e30 as
    masked ones, and the port adds them to the row sum as it does."""
    q, k, v = _qkv(11, 2, 96, 130, 2, 64)
    mask = _mask(11, 2, 130, fully_masked_row=True)
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                kv_mask=jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(_port(q, k, v, mask, torch.float32), want,
                               **FP32_TOL)


def test_cpu_dispatch():
    """CPU tensors: the default backend is the naive twin of JAX's
    `_naive_attention`; "flash" computes the kernel's plain version."""
    q, k, v = _qkv(5, 2, 96, 70, 3, 64)
    mask = _mask(5, 2, 70, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tm = torch.from_numpy(mask)
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask=jnp.asarray(mask),
                                    backend="naive"))
    np.testing.assert_allclose(attention(tq, tk, tv, mask=tm).numpy(), want,
                               **FP32_TOL)
    np.testing.assert_allclose(
        attention(tq, tk, tv, mask=tm, backend="flash").numpy(),
        flash_attention(tq, tk, tv, kv_mask=tm).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(
        attention(tq, tk, tv, mask=tm, backend="flash").numpy(), want,
        **FP32_TOL)
    with pytest.raises(ValueError):
        attention(tq, tk, tv, backend="sdpa")



def test_backend_selection_matches_jax(monkeypatch):
    """`available_backends` and `default_backend`, JAX's counterparts:
    ``VIDEOCOF_ATTENTION_TYPE`` (any case) decides when it is set, the
    device otherwise; an explicit ``backend=`` wins over both; a name
    outside the list raises ValueError with the list, on both sides."""
    from videocof_torch.ops import available_backends, default_backend
    from videocof_tpu.ops import available_backends as jax_available
    from videocof_tpu.ops import default_backend as jax_default
    monkeypatch.delenv("VIDEOCOF_ATTENTION_TYPE", raising=False)
    assert available_backends() == ("flash", "int8", "naive")
    assert set(available_backends()) - {"flash"} < set(jax_available())
    assert default_backend(torch.device("cpu")) == "naive"
    assert default_backend(torch.zeros(1)) == "naive"
    assert default_backend("cuda") == "flash"
    assert default_backend(torch.device("cuda", 0)) == "flash"
    assert default_backend() == ("flash" if torch.cuda.is_available()
                                 else "naive")
    for name in ("int8", "naive", "INT8"):
        monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", name)
        assert default_backend("cpu") == default_backend("cuda") \
            == jax_default() == name.lower()
    q, k, v = map(torch.from_numpy, _qkv(6, 1, 40, 33, 2, 64))
    flash = flash_attention(q, k, v).numpy()
    monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "flash")
    assert default_backend("cpu") == "flash"
    np.testing.assert_array_equal(attention(q, k, v).numpy(), flash)
    naive = attention(q, k, v, backend="naive").numpy()     # explicit wins
    monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "naive")
    np.testing.assert_array_equal(attention(q, k, v).numpy(), naive)
    np.testing.assert_array_equal(
        attention(q, k, v, backend="flash").numpy(), flash)
    assert not np.array_equal(naive, flash)
    monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "sdpa")
    for default in (default_backend, jax_default):
        with pytest.raises(ValueError, match="naive"):
            default()
    with pytest.raises(ValueError, match="VIDEOCOF_ATTENTION_TYPE"):
        attention(q, k, v)
    with pytest.raises(ValueError, match="flash"):
        attention(q, k, v, backend="sdpa")


def test_departure_backend_names(monkeypatch):
    """JAX's ``"pallas"`` is taken as ``"flash"`` (its kernel's
    counterpart), in the variable and as ``backend=``; JAX's ``"xla"`` has
    no counterpart and raises, where JAX takes it."""
    from videocof_torch.ops import default_backend
    from videocof_tpu.ops import default_backend as jax_default
    q, k, v = map(torch.from_numpy, _qkv(7, 1, 24, 17, 2, 64))
    flash = flash_attention(q, k, v).numpy()
    monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "pallas")
    assert jax_default() == "pallas"
    assert default_backend("cpu") == default_backend("cuda") == "flash"
    np.testing.assert_array_equal(attention(q, k, v).numpy(), flash)
    monkeypatch.delenv("VIDEOCOF_ATTENTION_TYPE")
    np.testing.assert_array_equal(
        attention(q, k, v, backend="pallas").numpy(), flash)
    monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "xla")
    assert jax_default() == "xla"
    with pytest.raises(ValueError, match="xla"):
        default_backend("cpu")
    monkeypatch.delenv("VIDEOCOF_ATTENTION_TYPE")
    with pytest.raises(ValueError, match="xla"):
        attention(q, k, v, backend="xla")
