"""Flash attention: the CUDA kernels under `csrc/`, their launchers, their
plain PyTorch versions, and the autograd Function that makes
``flash_attention`` differentiable.

Counterpart of `videocof_tpu/ops/flash_attention.py`. Three kernels, each
replacing one Pallas kernel, one path of one, or two:

* B1 ``flash_attention_fwd.cu`` without the LSE: the inference forward
  (`_flash_kernel` via `_flash_bnld(need_lse=False)`), counted in
  ``flash_attention.launches``.
* B2 the same kernel with the LSE (`_flash_bnld(need_lse=True)`): the
  forward of every attention that needs a gradient, and
  ``flash_attention_with_lse``; counted in ``flash_fwd_lse.launches``.
* B3 ``flash_attention_bwd.cu``: one kernel for the whole backward (dQ,
  dK and dV from one recompute of the logits), replacing both
  `_bwd_dq_kernel` and `_bwd_dkv_kernel`; counted in
  ``flash_bwd.launches``. It rounds P and dS to the input type before the
  dV, dK and dQ products, where JAX keeps them in fp32: the plain backward
  repeats that with ``rounded=True``.

Each wrapper launches its kernel for a CUDA tensor and raises for what the
kernel does not take; for a CPU tensor it computes the plain version beside
it, which the tests hold against JAX and the kernel against on the card.

``flash_attention`` takes the autograd Function only when grad mode is on and
an input requires grad; otherwise it launches B1. As in JAX, the softmax
scale is folded into q outside the Function (``q * scale`` rounded to q's
dtype), so autograd carries that chain rule and the Function runs at scale 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MASKED_LOGIT = -1e30
SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
HEAD_DIMS = (64, 128)
DTYPES = (torch.bfloat16, torch.float16)
# the Pallas wrapper's default key block (`flash_attention`'s block_k)
JAX_BLOCK_K = 1024
# rows of q per chunk of the plain versions: keeps their fp32 logits near 1 GiB
_PLAIN_LOGIT_BYTES = 1 << 30


def _check_shapes(q, k, v, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, N, D]")
    B, _, N, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (N, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, k.shape[1]):
        raise ValueError(f"kv_mask must be [B, Lk] = {(B, k.shape[1])}, "
                         f"got {tuple(kv_mask.shape)}")


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX's ``jnp.asarray(value, dtype)``."""
    return torch.tensor(value, dtype=dtype).item()


def key_padding(Lk: int) -> int:
    """Keys the Pallas wrapper pads Lk with at its default block:
    ``rup(Lk, min(1024, rup(Lk, 128))) - Lk``. They get the masked logit, so
    they weigh only in a fully masked row."""
    rup = lambda x, m: -(-x // m) * m  # noqa: E731
    return rup(Lk, min(JAX_BLOCK_K, rup(Lk, 128))) - Lk


def _row_chunk(B, N, Lk):
    return max(1, _PLAIN_LOGIT_BYTES // (4 * B * N * max(Lk, 1)))


# -------------------------------------------------------------- plain versions

def _forward_reference(q, k, v, kv_mask, scale, need_lse):
    _check_shapes(q, k, v, kv_mask)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    q2 = (q * _rounded(scale, q.dtype)) * _rounded(LOG2E, q.dtype)
    kf, vf = k.float(), v.float()
    n_pad = key_padding(Lk)
    rows = _row_chunk(B, N, Lk)
    outs, lses = [], []
    for r0 in range(0, Lq, rows):
        s = torch.einsum("bqnd,bknd->bnqk", q2[:, r0:r0 + rows].float(), kf)
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask.bool()[:, None, None, :], MASKED_LOGIT)
        m = s.amax(dim=-1)                                      # [B, N, q]
        p = torch.exp2(s - m[..., None])
        denom = p.sum(dim=-1) + n_pad * torch.exp2(MASKED_LOGIT - m)
        o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), vf)
        outs.append((o / denom.transpose(1, 2)[..., None]).to(q.dtype))
        if need_lse:
            lses.append(m * LN2 + torch.log(denom))
    out = torch.cat(outs, dim=1)
    return out, (torch.cat(lses, dim=2) if need_lse else None)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              kv_mask: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B1: [B, L, N, D] softmax attention
    with fp32 logits in the exp2 domain. q is scaled as the TPU wrapper does
    it (``q * scale`` rounded to q's dtype, then ``* log2 e`` rounded to q's
    dtype); keys with ``kv_mask`` False get the logit -1e30, and so do the
    Pallas wrapper's padded keys (`key_padding`): a fully masked row is
    sum(V) / (Lk + padding), as on the TPU. Probabilities are rounded to v's
    dtype before the PV product. Processes q in row chunks so the fp32
    logits of a long sequence stay bounded."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _forward_reference(q, k, v, kv_mask, scale, need_lse=False)[0]


def flash_fwd_lse_reference(q, k, v, *, kv_mask=None, scale=1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B2: ``flash_attention_reference`` and the
    natural-domain LSE ``m * ln 2 + ln l`` [B, N, Lq] fp32, m the max of the
    log2-domain logits and l the row sum, exactly as the Pallas kernel's
    `lse_ref`. A fully masked row keeps an LSE near -1e30 * ln 2."""
    return _forward_reference(q, k, v, kv_mask, scale, need_lse=True)


def flash_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, N, Lq] (outside the kernels, as
    in `_flash_bwd_bnld`)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_chunk(q, k, v, do, lse, delta, scale, r0, r1, rounded):
    """P and dS of q rows [r0, r1) in fp32, as `_bwd_dq_kernel` and
    `_bwd_dkv_kernel` recompute them: S in the natural domain from the
    scale-folded q, P = exp(S - lse). ``rounded`` rounds both to q's dtype,
    as kernel B3 feeds them to the tensor cores."""
    s = torch.einsum("bqnd,bknd->bnqk", q[:, r0:r1].float(), k.float()) * scale
    p = torch.exp(s - lse[:, :, r0:r1, None])
    dp = torch.einsum("bqnd,bknd->bnqk", do[:, r0:r1].float(), v.float())
    ds = p * (dp - delta[:, :, r0:r1, None]) * scale
    if rounded:
        return p.to(q.dtype).float(), ds.to(q.dtype).float()
    return p, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, scale=1.0,
                           rounded=False):
    """Plain version of dQ (JAX's `_bwd_dq_kernel`): dQ = dS K in fp32, cast
    to q's dtype. ``rounded`` rounds dS to q's dtype first: the arithmetic of
    kernel B3, its one stated deviation from JAX; the default keeps JAX's
    fp32."""
    B, Lq, N, _ = q.shape
    rows = _row_chunk(B, N, k.shape[1])
    out = []
    for r0 in range(0, Lq, rows):
        _, ds = _bwd_chunk(q, k, v, do, lse, delta, scale, r0, r0 + rows,
                           rounded)
        out.append(torch.einsum("bnqk,bknd->bqnd", ds, k.float()).to(q.dtype))
    return torch.cat(out, dim=1)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, scale=1.0,
                            rounded=False):
    """Plain version of dK and dV (JAX's `_bwd_dkv_kernel`): dV = P^T dO and
    dK = dS^T Q in fp32, summed over q rows, cast to k's and v's dtypes.
    ``rounded`` rounds P and dS to q's dtype first, as kernel B3 does."""
    B, Lq, N, _ = q.shape
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    rows = _row_chunk(B, N, k.shape[1])
    for r0 in range(0, Lq, rows):
        p, ds = _bwd_chunk(q, k, v, do, lse, delta, scale, r0, r0 + rows,
                           rounded)
        dv += torch.einsum("bnqk,bqnd->bknd", p, do[:, r0:r0 + rows].float())
        dk += torch.einsum("bnqk,bqnd->bknd", ds, q[:, r0:r0 + rows].float())
    return dk.to(k.dtype), dv.to(v.dtype)


def masked_attention_reference(q, k, v, kv_mask):
    """`_masked_ref_bnld`: attention with a key mask over the scale-folded q
    (masked logits -1e30, no padded keys). The backward of the masked path
    differentiates this, as JAX's `_flash_core_masked_bwd` does."""
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    s = s.masked_fill(~kv_mask.bool()[:, None, None, :], MASKED_LOGIT)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", p, v.float()).to(q.dtype)


# --------------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def build() -> Dict[str, float]:
    """Build (or load) every kernel's library of the port, the int8 kernel
    B4's and the DiT's fused passes' too, in parallel; returns the build
    seconds per source (0.0 when it came from the build cache)."""
    from . import dit_fused, int8_attention   # int8_attention imports this
    sources = (SOURCE, BWD_SOURCE, int8_attention.SOURCE, dit_fused.SOURCE)
    _build.build_all(sources)
    _library()
    _bwd_library()
    int8_attention._library()
    dit_fused._library()
    return {s: _build.build_info[s]["seconds"] for s in sources}


def _layout_ok(t: torch.Tensor) -> bool:
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_kernel_inputs(q, *others):
    """Raise for what the kernels do not take: a non-CUDA tensor, a head dim
    other than 64 or 128, a dtype other than bf16/fp16 (the same for all),
    D not contiguous or rows not 16-byte aligned."""
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash attention kernels on {q.device}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise NotImplementedError(f"dtype {q.dtype}; the kernels take one of "
                                  f"{DTYPES}")
    for i, t in enumerate((q, *others)):
        if t.dtype != q.dtype:
            raise NotImplementedError(f"input {i} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"input {i} on {t.device}, q on {q.device}")
        if not _layout_ok(t):
            raise NotImplementedError(
                f"input {i} strides {t.stride()}: D must be contiguous and "
                "rows 16-byte aligned")


def _check_rowvec(name, t, q):
    B, Lq, N, _ = q.shape
    if (t.dtype != torch.float32 or t.device != q.device
            or tuple(t.shape) != (B, N, Lq) or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous fp32 [B, N, Lq] = "
                         f"{(B, N, Lq)} tensor on {q.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _bld(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _launch_fwd(q, k, v, kv_mask, scale, need_lse):
    """Kernel B1 (need_lse False) or B2 on CUDA tensors."""
    _check_kernel_inputs(q, k, v)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    if Lk == 0:
        raise ValueError("attention over zero keys")
    out = torch.empty((B, Lq, N, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, N, Lq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    if Lq == 0:
        return out, lse
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(device=q.device, dtype=torch.bool).contiguous()
    lib = _library()
    with torch.cuda.device(q.device):   # the launch goes to the current device
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, N, Lq, Lk, D, int(q.dtype == torch.float16), key_padding(Lk),
            *_bld(q), *_bld(k), *_bld(v), *_bld(out),
            _rounded(scale, q.dtype), _rounded(LOG2E, q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    return out, lse


def _forward_b1(q, k, v, kv_mask, scale):
    """Kernel B1 on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask=kv_mask, scale=scale)
    out, _ = _launch_fwd(q, k, v, kv_mask, scale, need_lse=False)
    flash_attention.launches += 1
    return out


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  kv_mask: Optional[torch.Tensor] = None, scale: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2: (out [B, Lq, N, D], lse [B, N, Lq] fp32, natural domain).
    ``scale`` defaults to 1: the callers fold it into q."""
    _check_shapes(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_fwd_lse_reference(q, k, v, kv_mask=kv_mask, scale=scale)
    out_lse = _launch_fwd(q, k, v, kv_mask, scale, need_lse=True)
    flash_fwd_lse.launches += 1
    return out_lse


def _rows16(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A [B, N, L] fp32 row vector whose rows start on 16 bytes (TMA's
    strides), and its row stride: ``t`` itself when L % 4 == 0 and its base
    is aligned, else a copy into rows padded to 4 values."""
    B, N, L = t.shape
    if L % 4 == 0 and t.data_ptr() % 16 == 0:
        return t, L
    row = -(-L // 4) * 4
    out = t.new_zeros((B, N, row))
    out[..., :L] = t
    return out, row


def flash_bwd(q, k, v, do, lse, delta, *, scale: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B3: (dQ [B, Lq, N, D], dK, dV [B, Lk, N, D]) in the inputs'
    dtype, from the scale-folded q, the forward's LSE and delta
    (`flash_bwd_delta`). The kernel adds dQ into a zeroed fp32 accumulator
    in no fixed order, cast here: dk and dv are reproducible bit for bit,
    dq to one ulp of its dtype but for values far below its largest. On a
    CPU tensor: the plain versions, in JAX's fp32 arithmetic."""
    _check_shapes(q, k, v, None)
    if q.device.type == "cpu":
        return (flash_bwd_dq_reference(q, k, v, do, lse, delta, scale=scale),
                *flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                         scale=scale))
    _check_kernel_inputs(q, k, v, do)
    _check_rowvec("lse", lse, q)
    _check_rowvec("delta", delta, q)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    dk = torch.empty((B, Lk, N, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Lk, N, D), dtype=v.dtype, device=q.device)
    if Lq == 0 or Lk == 0:
        return torch.zeros_like(q), dk.zero_(), dv.zero_()
    dq_acc = torch.zeros((B, Lq, N, D), dtype=torch.float32, device=q.device)
    (lse, stride), (delta, _) = _rows16(lse), _rows16(delta)
    strides = (ctypes.c_longlong * 12)(*_bld(q), *_bld(k), *_bld(v), *_bld(do))
    with torch.cuda.device(q.device):
        rc = _bwd_library().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            B, N, Lq, Lk, D, int(q.dtype == torch.float16), stride,
            strides, *_bld(dk), *_bld(dv), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{rc}")
    flash_bwd.launches += 1
    return dq_acc.to(q.dtype), dk, dv


# -------------------------------------------------------------------- autograd

class _FlashAttention(torch.autograd.Function):
    """`_flash_core` with its custom VJP, at scale 1: the forward is B2 and
    saves (q, k, v, out, lse); the backward is delta and B3."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_fwd_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.device.type == "cuda" and not _layout_ok(dout):
            dout = dout.contiguous()
        return flash_bwd(q, k, v, dout, lse, flash_bwd_delta(out, dout))


class _FlashAttentionMasked(torch.autograd.Function):
    """`_flash_core_masked`: the forward is B1 with the key mask (no LSE, as
    on the TPU); the backward recomputes through `masked_attention_reference`
    in plain PyTorch (O(L^2) memory), as JAX recomputes through XLA."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        ctx.save_for_backward(q, k, v, kv_mask)
        return _forward_b1(q, k, v, kv_mask, 1.0)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = masked_attention_reference(*leaves, kv_mask)
        dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, L, N, D] bidirectional attention (heads on axis -2),
    differentiable.

    ``kv_mask`` [B, Lk] bool: keys with False are excluded from the softmax.
    Without a gradient to carry this is kernel B1; with one (grad mode on
    and an input requiring grad) the forward is B2 and the backward B3,
    or, with a key mask, B1 and a plain recompute. The kernels take
    bf16 or fp16, head_dim 64 or 128, a unit stride on D and 16-byte aligned
    rows, and raise otherwise. A CPU tensor goes through the plain
    versions."""
    _check_shapes(q, k, v, kv_mask)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        q_s = q * _rounded(scale, q.dtype)
        if kv_mask is None:
            return _FlashAttention.apply(q_s, k, v)
        return _FlashAttentionMasked.apply(q_s, k, v, kv_mask.bool())
    return _forward_b1(q, k, v, kv_mask, scale)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             kv_mask: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like ``flash_attention`` but also returns the natural-domain
    log-sum-exp [B, Lq, N, 1] fp32 (kernel B2), the blockwise-combine
    primitive of ring attention. Not differentiable, as in JAX."""
    _check_shapes(q, k, v, kv_mask)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out, lse = flash_fwd_lse(q * _rounded(scale, q.dtype), k, v,
                             kv_mask=kv_mask)
    return out, lse.transpose(1, 2)[..., None]


flash_attention.launches = 0
flash_fwd_lse.launches = 0
flash_bwd.launches = 0

# kernel name -> its wrapper (which carries the launch count)
KERNEL_WRAPPERS = {
    "flash_attention_fwd": flash_attention,
    "flash_attention_fwd_lse": flash_fwd_lse,
    "flash_attention_bwd": flash_bwd,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
