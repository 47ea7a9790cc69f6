"""Int8 (SageAttention-style) flash attention: kernel B4 under
`csrc/int8_attention.cu`, its launchers and its plain PyTorch versions.

Counterpart of `videocof_tpu/ops/int8_attention.py` (`int8_flash_attention`,
the Pallas kernel `_int8_kernel`). Q and the mean-centred K are quantized to
int8 with one scale per row, QK^T is an int8 product accumulated in s32, the
softmax runs in fp32 off the rescaled logits, PV stays bf16/fp16. Centring K
drops ``q . k_mean``, a constant per query row, to which the softmax is
invariant. Two kernels, each with its launch count:

* ``int8_quantize_k``: K's per-(batch, head) fp32 mean (which JAX takes in
  XLA outside its kernel) and K centred on it and quantized once, int8 [B,
  N, Lk, D] and fp32 row scales [B, N, Lk] (a view of rows padded to 16
  bytes, `sk_row_stride`, for TMA), in one launch that reads K once. The
  TPU kernel requantizes each K tile for every q block; the values are the
  same.
* ``int8_attention_fwd``: the attention over q (quantized per q tile inside
  the kernel) and the quantized K, which the kernel reads through TMA tensor
  maps encoded per launch (sm_90a: int8 and bf16/fp16 wgmma, a producer
  warpgroup and two consumer warpgroups).

``int8_flash_attention`` runs the two and nothing else, the function of
JAX's `int8_flash_attention`.

Inference only, as in JAX (the kernel has no VJP): a call with inputs that
need a gradient raises. Each wrapper launches its kernel for a CUDA tensor
and raises for what the kernel does not take; for a CPU tensor it computes
the plain version beside it, which the tests hold against JAX and the kernel
against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import (LOG2E, MASKED_LOGIT, _bld, _check_shapes,
                              _layout_ok, _row_chunk)

SOURCE = "int8_attention.cu"
HEAD_DIMS = (128, 256)          # built instantiations (JAX takes D % 128 == 0)
DTYPES = (torch.bfloat16, torch.float16)
QUANT_EPS = 1e-6
# 1 / 127 in fp32: XLA compiles JAX's ``amax / 127.0`` (and any division by a
# constant) into a product with the rounded reciprocal, so the TPU kernel's
# scales are products, and so are the port's
RECIP_127 = float(np.float32(1.0 / 127.0))
# the Pallas wrapper's default key block (`int8_flash_attention`'s block_k)
JAX_BLOCK_K = 512
# the K bytes each of the pre-pass's stages keeps (`kPrepStageBytes` in the
# source)
PREPASS_STAGE_BYTES = 32 * 1024


def key_padding(Lk: int) -> int:
    """Keys the Pallas wrapper pads Lk with at its default block:
    ``rup(Lk, min(512, rup(Lk, 128))) - Lk``. They get the masked logit, so
    they weigh only in a fully masked row."""
    rup = lambda x, m: -(-x // m) * m  # noqa: E731
    return rup(Lk, min(JAX_BLOCK_K, rup(Lk, 128))) - Lk


def sk_row_stride(Lk: int) -> int:
    """Elements between the rows of the pre-pass's row scales: Lk rounded up
    to 4, so that each row starts on 16 bytes as TMA needs."""
    return -(-Lk // 4) * 4


def prepass_plan(Lk: int, D: int, slabs: int, resident: int
                 ) -> Tuple[int, int]:
    """(chunks, rows) the pre-pass cuts each of ``slabs`` slabs of Lk keys
    into, none empty and at most ``resident`` (the kernel's grid is a whole
    number of slabs). Chunks hold a stage's rows (PREPASS_STAGE_BYTES of
    16-bit K) where the resident CTAs' stages hold a slab: as many whole
    slabs as fit then take a round of the grid, each cut into the resident
    CTAs' share. Past that a slab is cut into ``resident`` chunks whose rows
    outgrow their stage, and the kernel reads the rest twice."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    stage_rows = PREPASS_STAGE_BYTES // (2 * D)
    fewest = cdiv(Lk, stage_rows)
    chunks = resident // min(slabs, max(1, resident // fewest))
    rows = cdiv(Lk, chunks)
    return cdiv(Lk, rows), rows


def logit_scale(scale: float) -> float:
    """``scale * log2 e`` in double, rounded to fp32 (JAX's weak-typed
    constant)."""
    return float(np.float32(scale * LOG2E))


def _check_head_dim(q):
    if q.shape[-1] % 128:
        raise NotImplementedError(f"head_dim {q.shape[-1]} not a multiple of "
                                  "128")


def _check_no_grad(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("int8 attention is inference only: it has "
                                  "no gradient (nor has the JAX kernel)")


# -------------------------------------------------------------- plain versions

def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [..., D] -> (int8 values as fp32, per-row scale [..., 1]):
    scale = max(amax, 1e-6) * fp32(1 / 127) and clip(round-half-even(x /
    scale), ±127), as `_quant_tile` compiles; x / scale is an IEEE division
    by a tensor."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=QUANT_EPS) * RECIP_127
    return torch.round(x / scale).clamp(-127, 127), scale


def k_mean(k: torch.Tensor) -> torch.Tensor:
    """The fp32 mean of K over its Lk keys, [B, N, D] (masked keys count,
    as in JAX): the fp32 sum times fp32(1 / Lk), as XLA compiles
    ``jnp.mean``."""
    recip = float(np.float32(1.0 / k.shape[1]))
    return (k.sum(dim=1, dtype=torch.float32) * recip).contiguous()


def quantize_k_reference(k: torch.Tensor, mean: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``int8_quantize_k``'s quantization: (int8 [B, N,
    Lk, D], fp32 row scales [B, N, Lk]) of ``k - mean``."""
    kf = k.float().transpose(1, 2) - mean[:, :, None, :]
    ki, sk = _quant_rows(kf)
    return ki.to(torch.int8), sk[..., 0]


def int8_attention_reference(q, ki, sk, v, *, kv_mask=None, scale=None):
    """Plain version of the attention kernel over a quantized K
    (``quantize_k_reference``): q quantized per row, logits
    ``float(qi . ki) * ((sq * scale * log2 e) * sk)``, keys with ``kv_mask``
    False at -1e30, the Pallas wrapper's padded keys (`key_padding`) in the
    row sum, P rounded to v's dtype before PV, in row chunks. The int8
    product runs as an fp32 matmul, exact: every partial sum is an integer
    below 127^2 * D < 2^24 (with TF32 off on a GPU)."""
    B, Lq, N, D = q.shape
    Lk = v.shape[1]
    scale = D ** -0.5 if scale is None else scale
    c = logit_scale(scale)
    qi, sq = _quant_rows(q.float())
    kif, vf = ki.float(), v.float()
    col_scale = sk[:, :, None, :]                               # [B, N, 1, Lk]
    n_pad = key_padding(Lk)
    rows = _row_chunk(B, N, Lk)
    outs = []
    for r0 in range(0, Lq, rows):
        s = torch.einsum("bqnd,bnkd->bnqk", qi[:, r0:r0 + rows], kif)
        s = s * ((sq[:, r0:r0 + rows].transpose(1, 2) * c) * col_scale)
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask.bool()[:, None, None, :], MASKED_LOGIT)
        m = s.amax(dim=-1)
        p = torch.exp2(s - m[..., None])
        denom = p.sum(dim=-1) + n_pad * torch.exp2(MASKED_LOGIT - m)
        o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), vf)
        outs.append((o / denom.transpose(1, 2)[..., None]).to(v.dtype))
    return torch.cat(outs, dim=1)


def int8_flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *,
                                   kv_mask: Optional[torch.Tensor] = None,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """Plain version of kernel B4 (both of its kernels): [B, L, N, D]
    attention with Q and the mean-centred K quantized to int8 per row, the
    same function as JAX's `int8_flash_attention`. A fully masked row is
    sum(V) / (Lk + padding) at the Pallas wrapper's block (`key_padding`)."""
    _check_shapes(q, k, v, kv_mask)
    ki, sk = quantize_k_reference(k, k_mean(k))
    return int8_attention_reference(q, ki, sk, v, kv_mask=kv_mask,
                                    scale=scale)


# --------------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.int8_quantize_k.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.int8_prepass_resident.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.int8_prepass_resident.restype = ctypes.c_int
    lib.int8_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_void_p])
    lib.int8_quantize_k.restype = ctypes.c_int
    lib.int8_attention_fwd.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, *others):
    """Raise for what the kernels do not take: a non-CUDA tensor, a head dim
    other than 128 or 256, a dtype other than bf16/fp16 (the same for all),
    D not contiguous or rows not 16-byte aligned."""
    if q.device.type != "cuda":
        raise NotImplementedError(f"int8 attention kernels on {q.device}")
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


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, D: int, dtype: torch.dtype) -> int:
    """CTAs of the pre-pass resident on the card at once: its grid, and the
    most chunks it may cut a slab into."""
    resident = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _library().int8_prepass_resident(
            D, int(dtype == torch.float16), ctypes.byref(resident))
    if rc != 0 or resident.value <= 0:
        raise RuntimeError(f"int8_prepass_resident failed: CUDA error {rc}")
    return resident.value


# per (device, stream): the pre-pass's slab counters, zero between launches
# (each launch sets back to 0 what it counted)
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _slab_counters(device: torch.device, slabs: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < slabs:
        buf = _counters[key] = torch.zeros(slabs, dtype=torch.int32,
                                           device=device)
    return buf


def int8_quantize_k(k: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4's pre-pass: K's fp32 mean over its keys and ``k - mean``
    quantized per row, (int8 [B, N, Lk, D], fp32 [B, N, Lk], fp32 mean [B,
    N, D]); on the CPU ``quantize_k_reference(k, k_mean(k))`` and that
    mean. On CUDA one launch reads K once, and the scales are a view of
    rows ``sk_row_stride(Lk)`` apart."""
    B, Lk, N, D = k.shape
    if k.device.type == "cpu":
        mean = k_mean(k)
        return (*quantize_k_reference(k, mean), mean)
    _check_kernel_inputs(k)
    if Lk == 0:
        raise ValueError("no keys to quantize")
    dev = k.device
    chunks, rows = prepass_plan(Lk, D, B * N,
                                _resident(dev.index, D, k.dtype))
    ki = torch.empty((B, N, Lk, D), dtype=torch.int8, device=dev)
    sk = torch.empty((B, N, sk_row_stride(Lk)), dtype=torch.float32,
                     device=dev)[..., :Lk]
    mean = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    partial = count = None
    if chunks > 1:
        partial = torch.empty(B * N * chunks * D, dtype=torch.float32,
                              device=dev)
        count = _slab_counters(dev, B * N)
    with torch.cuda.device(dev):   # the launch goes to the current device
        rc = _library().int8_quantize_k(
            k.data_ptr(), ki.data_ptr(), sk.data_ptr(), mean.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if count is None else count.data_ptr(),
            B, N, Lk, D, int(k.dtype == torch.float16), chunks, rows,
            sk.stride(1), *_bld(k), float(np.float32(1.0 / Lk)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_quantize_k launch failed: CUDA error {rc}")
    int8_quantize_k.launches += 1
    return ki, sk, mean


def int8_attention_fwd(q: torch.Tensor, ki: torch.Tensor, sk: torch.Tensor,
                       v: torch.Tensor, *,
                       kv_mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """B4's attention kernel over q and a K quantized by
    ``int8_quantize_k``: [B, Lq, N, D] in v's dtype."""
    B, Lq, N, D = q.shape
    Lk = v.shape[1]
    scale = D ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return int8_attention_reference(q, ki, sk, v, kv_mask=kv_mask,
                                        scale=scale)
    _check_kernel_inputs(q, v)
    row = sk.stride(1)
    if (ki.dtype != torch.int8 or tuple(ki.shape) != (B, N, Lk, D)
            or not ki.is_contiguous() or sk.dtype != torch.float32
            or tuple(sk.shape) != (B, N, Lk)
            or sk.stride() != (N * row, row, 1) or row < Lk or row % 4):
        raise ValueError("ki, sk must be int8_quantize_k's contiguous int8 "
                         f"{(B, N, Lk, D)} and fp32 {(B, N, Lk)} with rows a "
                         "multiple of 4 apart")
    if ki.data_ptr() % 16 or sk.data_ptr() % 16:
        raise NotImplementedError("ki and sk must start on 16 bytes (TMA)")
    out = torch.empty((B, Lq, N, D), dtype=v.dtype, device=q.device)
    if Lq == 0:
        return out
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(device=q.device, dtype=torch.bool).contiguous()
    with torch.cuda.device(q.device):
        rc = _library().int8_attention_fwd(
            q.data_ptr(), ki.data_ptr(), sk.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, N, Lq, Lk, D, int(q.dtype == torch.float16), key_padding(Lk),
            row, *_bld(q), *_bld(v), *_bld(out), logit_scale(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_attention_fwd launch failed: CUDA error {rc}")
    int8_attention_fwd.launches += 1
    return out


def int8_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kv_mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """[B, L, N, D] attention with int8 QK^T (kernel B4:
    ``int8_quantize_k``, then ``int8_attention_fwd``), head_dim a multiple of
    128; the output in v's dtype. ``kv_mask`` [B, Lk] bool: keys with False
    are excluded. Raises, and never switches path, for a head_dim that is
    not a multiple of 128, inputs that need a gradient, and on CUDA for what
    the kernels do not take (a dtype other than bf16/fp16, head_dim other
    than 128 or 256, D not contiguous). A CPU tensor goes through the plain
    version."""
    _check_shapes(q, k, v, kv_mask)
    _check_head_dim(q)
    _check_no_grad(q, k, v)
    if q.device.type == "cpu":
        return int8_flash_attention_reference(q, k, v, kv_mask=kv_mask,
                                              scale=scale)
    _check_kernel_inputs(q, k, v)
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    ki, sk, _ = int8_quantize_k(k)
    return int8_attention_fwd(q, ki, sk, v, kv_mask=kv_mask, scale=scale)


int8_quantize_k.launches = 0
int8_attention_fwd.launches = 0

# kernel name -> its wrapper (which carries the launch count)
KERNEL_WRAPPERS = {
    "int8_quantize_k": int8_quantize_k,
    "int8_attention_fwd": int8_attention_fwd,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
