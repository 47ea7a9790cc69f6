"""The port's flash attention with the LSE (kernel B2's plain version) and
its gradients (the autograd Function with B3a/B3b's plain versions) against
the JAX package's Pallas kernels in interpret mode. Inputs and cotangents
are float32 numpy from a seed, handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.ops import flash_attention as jfa
from videocof_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# fp32: the two differ only in summation order (tests/test_flash_attention.py)
FP32_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_FP32_TOL = dict(rtol=2e-3, atol=2e-3)
# bf16: both round q * scale, q * log2 e and P to bf16 and the outputs to bf16;
# one flipped rounding of an output is 2^-8 of it
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _mask(seed, B, Lk, fully_masked_row):
    m = np.random.default_rng(seed).random((B, Lk)) > 0.3
    m[:, 0] = True
    if fully_masked_row:
        m[-1] = False
    return m


@pytest.mark.parametrize("Lq,Lk,masked,full_row", [
    (128, 128, False, False), (200, 200, False, False),
    (256, 130, False, False), (130, 300, True, False),
    (96, 130, True, True), (128, 256, True, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_matches_pallas(Lq, Lk, masked, full_row, dtype):
    """B2's plain version: out and LSE against `flash_attention_with_lse`;
    a fully masked row keeps a finite LSE near -1e30 * ln 2."""
    B, N, D = 2, 2, 64
    q, k, v = _arrays(Lq + Lk, (B, Lq, N, D), (B, Lk, N, D), (B, Lk, N, D))
    mask = _mask(Lk, B, Lk, full_row) if masked else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_o, want_l = jfa.flash_attention_with_lse(
        *(jnp.asarray(a, jd) for a in (q, k, v)),
        kv_mask=None if mask is None else jnp.asarray(mask), interpret=True)
    got_o, got_l = fa.flash_attention_with_lse(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        kv_mask=None if mask is None else torch.from_numpy(mask))
    assert got_l.shape == (B, Lq, N, 1) and got_l.dtype == torch.float32
    assert torch.isfinite(got_l).all()
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **tol)
    if full_row:
        assert float(got_l[-1].max()) < -6e29


def _spy_backward(monkeypatch):
    """Count the JAX side's calls of the Pallas backward."""
    calls = []
    real = jfa._flash_bwd_bnld

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jfa, "_flash_bwd_bnld", spy)
    return calls


def _grads(q, k, v, g, mask, dtype):
    """(out, dq, dk, dv) of both sides for the cotangent ``g``."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, kv_mask=jm, interpret=True),
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    want = [out, *vjp(jnp.asarray(g, jd))]
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    tout = fa.flash_attention(
        *leaves, kv_mask=None if mask is None else torch.from_numpy(mask))
    tout.backward(torch.from_numpy(g).to(td))
    got = [tout.detach()] + [x.grad for x in leaves]
    return ([np.asarray(w.astype(jnp.float32)) for w in want],
            [t.float().numpy() for t in got])


@pytest.mark.parametrize("Lq,Lk", [(128, 128), (200, 200), (200, 77)])
@pytest.mark.parametrize("D", [64, 128])
def test_grad_matches_pallas_fp32(monkeypatch, Lq, Lk, D):
    calls = _spy_backward(monkeypatch)
    q, k, v, g = _arrays(Lq + D, (2, Lq, 2, D), (2, Lk, 2, D), (2, Lk, 2, D),
                         (2, Lq, 2, D))
    want, got = _grads(q, k, v, g, None, "float32")
    assert calls, "the JAX side did not reach the Pallas backward"
    for name, w, t in zip(("out", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(t, w, err_msg=name, **GRAD_FP32_TOL)


@pytest.mark.parametrize("Lq,Lk,D", [(200, 200, 128), (200, 77, 64)])
def test_grad_matches_pallas_bf16(monkeypatch, Lq, Lk, D):
    """bf16: the same arithmetic on both sides, the gradients rounded to
    bf16 at the end; the bound is the forward's (one bf16 rounding of the
    largest gradients, about 0.5-1, is 2^-8 of them)."""
    calls = _spy_backward(monkeypatch)
    q, k, v, g = _arrays(Lq + D + 1, (2, Lq, 2, D), (2, Lk, 2, D),
                         (2, Lk, 2, D), (2, Lq, 2, D))
    want, got = _grads(q, k, v, g, None, "bfloat16")
    assert calls
    for name, w, t in zip(("out", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(t, w, err_msg=name, **BF16_TOL)


def test_masked_grad_matches_jax():
    """The masked path: B1's plain version forward, and a backward that
    recomputes through plain masked attention, as JAX's
    `_flash_core_masked_bwd` does (a fully masked row included)."""
    q, k, v, g = _arrays(5, (2, 96, 2, 64), (2, 130, 2, 64), (2, 130, 2, 64),
                         (2, 96, 2, 64))
    mask = _mask(5, 2, 130, fully_masked_row=True)
    want, got = _grads(q, k, v, g, mask, "float32")
    for name, w, t in zip(("out", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(t, w, err_msg=name, **GRAD_FP32_TOL)


def test_plain_backward_pieces():
    """The Function's CPU backward is delta and `flash_bwd`'s plain versions,
    and its output is the no-grad forward's; no kernel launch is counted on
    the CPU."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(
        9, (1, 70, 3, 64), (1, 50, 3, 64), (1, 50, 3, 64), (1, 70, 3, 64)))
    before = fa.launch_counts()
    scale = 64 ** -0.5
    qs = q * scale
    out, lse = fa.flash_fwd_lse(qs, k, v)
    delta = fa.flash_bwd_delta(out, g)
    dq, dk, dv = fa.flash_bwd(qs, k, v, g, lse, delta)
    dq = dq * scale
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tout = fa.flash_attention(*leaves)
    tout.backward(g)
    torch.testing.assert_close(tout.detach(), fa.flash_attention(q, k, v),
                               rtol=0, atol=0)
    torch.testing.assert_close(tout.detach(), out, rtol=0, atol=0)
    for want, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(leaf.grad, want, rtol=1e-6, atol=1e-6)
    assert fa.launch_counts() == before


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("Lq,Lk,D", [(200, 200, 128), (130, 77, 64)])
def test_rounded_plain_backward_against_pallas_bf16(Lq, Lk, D):
    """Kernel B3's arithmetic, P and dS rounded to bf16 before the dV, dK and
    dQ products (the plain backward with ``rounded=True``), against JAX's
    Pallas backward `_flash_bwd_bnld` in interpret mode, which keeps them in
    fp32: the size of B3's one deviation from the reference. Both sides get
    JAX's forward output and LSE. The fp32 plain backward meets JAX to the
    final bf16 rounding (relative L2 <= 2e-4; 1e-5 to 3.4e-5 measured); the
    rounded one moves away by the bf16 rounding of P and dS, 2^-9 of a
    value at most (2.59e-3 to 2.65e-3 measured here, about 2.6e-3 for the
    kernels on the card), bounded at 5e-3."""
    B, N, bq, bk = 2, 2, 128, 128
    q, k, v, g = _arrays(Lq + Lk + D, (B, Lq, N, D), (B, Lk, N, D),
                         (B, Lk, N, D), (B, Lq, N, D))
    q = q * D ** -0.5                       # the scale-folded q of the core
    bnld = lambda a: jnp.asarray(           # noqa: E731
        a.transpose(0, 2, 1, 3).reshape(B * N, a.shape[1], D), jnp.bfloat16)
    jq, jk, jv, jg = (bnld(a) for a in (q, k, v, g))
    o, lse = jfa._flash_bnld(jq, jk, jv, 1.0, bq, bk, interpret=True)
    want = [np.asarray(x.astype(jnp.float32)).reshape(B, N, -1, D)
            .transpose(0, 2, 1, 3) for x in jfa._flash_bwd_bnld(
                jq, jk, jv, jg, o, lse, 1.0, bq, bk, interpret=True)]
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    tout = torch.from_numpy(np.asarray(o.astype(jnp.float32)).reshape(
        B, N, Lq, D).transpose(0, 2, 1, 3).copy()).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse[:, :Lq, 0]).reshape(B, N, Lq))
    delta = fa.flash_bwd_delta(tout, tg)
    errs = {}
    for rounded in (False, True):
        got = (fa.flash_bwd_dq_reference(tq, tk, tv, tg, tlse, delta,
                                         rounded=rounded),
               *fa.flash_bwd_dkv_reference(tq, tk, tv, tg, tlse, delta,
                                           rounded=rounded))
        errs[rounded] = [_rel_l2(t.float().numpy(), w)
                         for t, w in zip(got, want)]
    for name, exact, rounded in zip(("dq", "dk", "dv"), errs[False],
                                    errs[True]):
        assert exact <= 2e-4, (name, exact)
        assert exact < rounded <= 5e-3, (name, exact, rounded)
