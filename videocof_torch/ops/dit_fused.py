"""The Wan DiT block's elementwise chain in five passes (`csrc/dit_fused.cu`),
their launchers, their plain PyTorch versions and the block's dispatch.

Counterpart of no TPU kernel: the JAX package's block
(`videocof_tpu/models/wan_dit.py::wan_block_apply`, `_attn_qkv`) leaves the
chain to XLA's fusion. PyTorch runs each of its steps as a kernel over the
[L, D] stream; here each pass reads its inputs once and writes its outputs
once:

* ``ln_modulate``: bf16(LayerNorm(x) * (1 + scale) + shift), the block's
  entry.
* ``qk_norm_rope``: q and k RMSNorm over the full D times their weights,
  rounded to bf16, then each channel pair rotated in fp32 by the per-token
  tables and rounded again, q and k in one launch; without tables the
  RMSNorm alone (the cross-attention's q).
* ``gate_residual_ln``: x + y * gate, then norm3's LayerNorm in bf16 (or
  bf16(x) without the norm).
* ``residual_ln_modulate``: x + y, then the FFN's LayerNorm and modulation.
* ``gate_residual``: x + h * gate, the block's exit.

Each wrapper launches its kernel for a CUDA tensor and raises for what the
kernel does not take; for a CPU tensor it computes its plain version
(``<pass>_reference``: the composed helpers of `models/wan_dit.py` and
`models/rope.py`), which is also the block's plain path and what the
kernels are held against on the card. Outputs are new tensors: the stream
a block receives is not written (TeaCache keeps the first block's input).

`plain_reason` is the dispatch: `WanBlock.forward` and `Attention.forward`
take the passes only where it finds nothing the kernels cannot serve, and
`count_block` counts the block calls of each path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..models import rope as rope_lib
from . import _build

SOURCE = "dit_fused.cu"
# the kernels as the profiler names them (each a template on its vectors a
# thread); none holds a mark of `cofbench/trace.py`'s attention, GEMM or
# convolution classes, so the DiT's "other" time counts them
KERNEL_NAMES = ("dit_ln_modulate_kernel", "dit_qk_norm_rope_kernel",
                "dit_gate_residual_ln_kernel",
                "dit_residual_ln_modulate_kernel", "dit_gate_residual_kernel")
MAX_THREADS = 512    # kMaxThreads in the source
MAX_VEC = 8          # kMaxVec: 16-byte vectors a thread
BF16 = torch.bfloat16

# block calls by path, and kernel launches by pass, since the last
# `reset_counts` (the q/k pass with k left out, the cross-attention's q,
# under "qk_norm_rope_q")
block_calls = {"fused": 0, "plain": 0}
launches = dict.fromkeys(("ln_modulate", "qk_norm_rope", "qk_norm_rope_q",
                          "gate_residual_ln", "residual_ln_modulate",
                          "gate_residual"), 0)


def plain_reason(device: torch.device, stream_dtype: Optional[torch.dtype],
                 q_dtype: torch.dtype, tp, rope_dtype: Optional[torch.dtype],
                 grads: Iterable[torch.Tensor]) -> Optional[str]:
    """Why a block call (or an attention's q/k norm) takes the plain path,
    or None where the fused passes serve it: autograd recording (grad
    enabled and one of ``grads`` requiring it: the kernels have no
    backward), a tensor-parallel context (RMSNorm's all-reduce), a stream
    other than fp32 (``stream_dtype`` None: no stream), q (the branch
    input) other than bf16, a RoPE dtype other than fp32, or a device other
    than CUDA."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        return "autograd"
    if tp is not None:
        return "tensor parallel"
    if stream_dtype not in (None, torch.float32):
        return f"stream {stream_dtype}"
    if q_dtype != BF16:
        return f"q {q_dtype}"
    if rope_dtype not in (None, torch.float32):
        return f"rope {rope_dtype}"
    if device.type != "cuda":
        return f"device {device.type}"
    return None


def count_block(fused: bool) -> bool:
    block_calls["fused" if fused else "plain"] += 1
    return fused


def block_counts() -> Dict[str, int]:
    return dict(block_calls)


def launch_shape(D: int) -> Tuple[int, int]:
    """(16-byte vectors a thread, threads a CTA) for a row of D: the fewest
    idle vector slots, then the CTA nearest 256 threads."""
    if D <= 0 or D % 4:
        raise NotImplementedError(f"width {D} not a multiple of 4")
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    nvec = D // 4
    best = None
    for vec in range(1, MAX_VEC + 1):
        threads = 32 * cdiv(cdiv(nvec, vec), 32)
        if threads > MAX_THREADS:
            continue
        key = (threads * vec - nvec, abs(threads - 256))
        if best is None or key < best[0]:
            best = (key, vec, threads)
    if best is None:
        raise NotImplementedError(
            f"width {D} above {4 * MAX_VEC * MAX_THREADS}")
    return best[1], best[2]


# -------------------------------------------------------------- plain versions
# `WanBlock.forward`'s plain path, in any dtype; the kernels' outputs are
# these in bf16 (``dtype``, the branches' dtype)

def _layer_norm(x, eps, scale=None, bias=None):
    from ..models.wan_dit import _layer_norm as ln   # it imports this module
    return ln(x, eps, scale, bias)


def _rms_norm(x, weight, eps):
    from ..models.wan_dit import _rms_norm as rms
    return rms(x, weight, eps)


def _rope(x, cos, sin):
    """apply_rope of [B, L, D] as [B, L, D / hd, hd] heads, in fp32."""
    hd = 2 * cos.shape[-1]
    return rope_lib.apply_rope(x.unflatten(-1, (-1, hd)), cos, sin,
                               compute_dtype=torch.float32).flatten(-2)


def ln_modulate_reference(x, shift, scale, eps, dtype=BF16):
    return (_layer_norm(x, eps) * (1.0 + scale) + shift).to(dtype)


def qk_norm_rope_reference(q, k, w_q, w_k, eps, cos=None, sin=None):
    q = _rms_norm(q, w_q, eps)
    k = None if k is None else _rms_norm(k, w_k, eps)
    if cos is not None:
        q = _rope(q, cos, sin)
        k = None if k is None else _rope(k, cos, sin)
    return q, k


def gate_residual_ln_reference(x, y, gate, eps, scale=None, bias=None,
                               dtype=BF16):
    x = (x.float() + y.float() * gate).to(x.dtype)
    nx = x if scale is None else _layer_norm(x, eps, scale, bias)
    return x, nx.to(dtype)


def residual_ln_modulate_reference(x, y, shift, scale, eps, dtype=BF16):
    x = (x.float() + y.float()).to(x.dtype)
    return x, ln_modulate_reference(x, shift, scale, eps, dtype)


def gate_residual_reference(x, h, gate):
    return (x.float() + h.float() * gate).to(x.dtype)


# --------------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    sig = {
        "dit_ln_modulate": [p, ll, ll, p, p, ll, p] + [i] * 5 + [f, p],
        "dit_qk_norm_rope": ([p, ll, ll, p, ll, ll, p, p, i, p, p, ll, ll, p,
                              p] + [i] * 6 + [f, p]),
        "dit_gate_residual_ln": ([p, ll, ll, p, ll, ll, p, ll, p, p, i, p, p]
                                 + [i] * 5 + [f, p]),
        "dit_residual_ln_modulate": ([p, ll, ll, p, ll, ll, p, p, ll, p, p]
                                     + [i] * 5 + [f, p]),
        "dit_gate_residual": [p, ll, ll, p, ll, ll, p, ll, p] + [i] * 5 + [p],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _rows(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device
          ) -> Tuple[int, int]:
    """(batch, row) strides of a [B, L, D] operand; raises for a dtype,
    shape, device or layout the kernels do not take (D contiguous, rows on
    16 bytes for fp32 and 8 for bf16)."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the stream on {device}")
    if t.dtype != dtype:
        raise NotImplementedError(f"{name} is {t.dtype}; the kernel takes "
                                  f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, not "
                         f"{tuple(shape)}")
    align = 16 // t.element_size() if dtype == torch.float32 else 4
    if (t.stride(2) != 1 or t.stride(0) % align or t.stride(1) % align
            or t.data_ptr() % (align * t.element_size())):
        raise NotImplementedError(
            f"{name} strides {t.stride()}: D must be contiguous and rows "
            f"aligned to {align * t.element_size()} bytes")
    return t.stride(0), t.stride(1)


def _mod_rows(t: torch.Tensor, name: str, B: int, D: int, device) -> int:
    """The batch stride of a modulation row [B, 1, D] or [B, D] (fp32; one
    row for every sample: 0)."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the stream on {device}")
    if t.dtype != torch.float32:
        raise NotImplementedError(f"{name} is {t.dtype}; the kernel takes "
                                  "float32")
    if (t.dim() not in (2, 3) or t.shape[0] not in (1, B)
            or t.shape[-1] != D or t.numel() != t.shape[0] * D):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, not [{B}, 1, "
                         f"{D}]")
    if t.stride(-1) != 1 or t.stride(0) % 4 or t.data_ptr() % 16:
        raise NotImplementedError(f"{name} strides {t.stride()}: D must be "
                                  "contiguous and rows on 16 bytes")
    return 0 if t.shape[0] == 1 else t.stride(0)


def _param(t: Optional[torch.Tensor], name: str, D: int, device):
    if t is None:
        return None
    if t.device != device or t.shape != (D,) or not t.is_contiguous():
        raise ValueError(f"{name}: a contiguous [{D}] tensor on {device}, "
                         f"not {tuple(t.shape)} on {t.device}")
    if t.dtype not in (BF16, torch.float32) or t.data_ptr() % 16:
        raise NotImplementedError(f"{name}: bf16 or float32 on 16 bytes, not "
                                  f"{t.dtype}")
    return t


def _params_f32(*params) -> int:
    dtypes = {t.dtype for t in params if t is not None}
    if len(dtypes) > 1:
        raise NotImplementedError(f"norm parameters of mixed dtypes {dtypes}")
    return int(dtypes == {torch.float32})


def _stream(x: torch.Tensor) -> Tuple[int, int, int]:
    if x.dim() != 3:
        raise ValueError(f"the stream is [B, L, D], not {tuple(x.shape)}")
    return tuple(x.shape)


def _launch(name: str, *args) -> None:
    rc = getattr(_library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """bf16(LayerNorm(x) * (1 + scale) + shift) of the fp32 stream x [B, L,
    D]; shift and scale [B, 1, D] fp32."""
    if x.device.type == "cpu":
        return ln_modulate_reference(x, shift, scale, eps)
    B, L, D = _stream(x)
    dev = x.device
    xs = _rows(x, "x", torch.float32, (B, L, D), dev)
    e_sb = _mod_rows(shift, "shift", B, D, dev)
    if _mod_rows(scale, "scale", B, D, dev) != e_sb:
        raise NotImplementedError("shift and scale rows of different strides")
    out = torch.empty((B, L, D), dtype=BF16, device=dev)
    with torch.cuda.device(dev):
        _launch("dit_ln_modulate", x.data_ptr(), *xs, shift.data_ptr(),
                scale.data_ptr(), e_sb, out.data_ptr(), B, L, D,
                *launch_shape(D), eps, _stream_ptr(dev))
    launches["ln_modulate"] += 1
    return out


def qk_norm_rope(q: torch.Tensor, k: Optional[torch.Tensor],
                 w_q: torch.Tensor, w_k: Optional[torch.Tensor], eps: float,
                 cos: Optional[torch.Tensor] = None,
                 sin: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(q, k) [B, L, D] bf16 -> RMSNorm over D times w_q / w_k, in bf16,
    then, with tables cos/sin [L, hd/2] or [B, L, hd/2] (fp32), each
    consecutive channel pair of every head rotated in fp32 and rounded to
    bf16. k may be None (q alone)."""
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin go together")
    if q.device.type == "cpu":
        return qk_norm_rope_reference(q, k, w_q, w_k, eps, cos, sin)
    B, L, D = _stream(q)
    dev = q.device
    qs = _rows(q, "q", BF16, (B, L, D), dev)
    ks = (0, 0) if k is None else _rows(k, "k", BF16, (B, L, D), dev)
    _param(w_q, "w_q", D, dev)
    _param(None if k is None else w_k, "w_k", D, dev)
    w_f32 = _params_f32(w_q, None if k is None else w_k)
    hd, t_sb, t_sl = 2, 0, 0           # hd unread without tables
    if cos is not None:
        hd = 2 * cos.shape[-1]
        if (cos.shape != sin.shape or cos.stride() != sin.stride()
                or cos.dim() not in (2, 3) or cos.shape[-2] != L
                or (cos.dim() == 3 and cos.shape[0] != B)):
            raise ValueError(f"tables {tuple(cos.shape)}, {tuple(sin.shape)} "
                             f"for {L} tokens of batch {B}")
        if D % hd:
            raise ValueError(f"head_dim {hd} does not divide {D}")
        for name, t in (("cos", cos), ("sin", sin)):
            if (t.device != dev or t.dtype != torch.float32
                    or t.stride(-1) != 1):
                raise NotImplementedError(
                    f"{name}: float32 on {dev} with its last dim contiguous, "
                    f"not {t.dtype} on {t.device}, strides {t.stride()}")
        t_sb = cos.stride(0) if cos.dim() == 3 else 0
        t_sl = cos.stride(-2)
    q_out = torch.empty((B, L, D), dtype=BF16, device=dev)
    k_out = None if k is None else torch.empty_like(q_out)
    with torch.cuda.device(dev):
        _launch("dit_qk_norm_rope", q.data_ptr(), *qs,
                None if k is None else k.data_ptr(), *ks, w_q.data_ptr(),
                None if k is None else w_k.data_ptr(), w_f32,
                None if cos is None else cos.data_ptr(),
                None if sin is None else sin.data_ptr(), t_sb, t_sl,
                q_out.data_ptr(), None if k is None else k_out.data_ptr(),
                B, L, D, hd, *launch_shape(D), eps, _stream_ptr(dev))
    launches["qk_norm_rope" if k is not None else "qk_norm_rope_q"] += 1
    return q_out, k_out


def gate_residual_ln(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor,
                     eps: float, scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + y * gate, bf16(LayerNorm(x + y * gate) * scale + bias)): the
    stream fp32 [B, L, D], y bf16, gate [B, 1, D] fp32; without scale the
    second output is bf16(x + y * gate)."""
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias go together")
    if x.device.type == "cpu":
        return gate_residual_ln_reference(x, y, gate, eps, scale, bias)
    B, L, D = _stream(x)
    dev = x.device
    xs = _rows(x, "x", torch.float32, (B, L, D), dev)
    ys = _rows(y, "y", BF16, (B, L, D), dev)
    e_sb = _mod_rows(gate, "gate", B, D, dev)
    _param(scale, "scale", D, dev)
    _param(bias, "bias", D, dev)
    x_out = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    nx = torch.empty((B, L, D), dtype=BF16, device=dev)
    with torch.cuda.device(dev):
        _launch("dit_gate_residual_ln", x.data_ptr(), *xs, y.data_ptr(), *ys,
                gate.data_ptr(), e_sb,
                None if scale is None else scale.data_ptr(),
                None if bias is None else bias.data_ptr(),
                _params_f32(scale, bias), x_out.data_ptr(), nx.data_ptr(),
                B, L, D, *launch_shape(D), eps, _stream_ptr(dev))
    launches["gate_residual_ln"] += 1
    return x_out, nx


def residual_ln_modulate(x: torch.Tensor, y: torch.Tensor,
                         shift: torch.Tensor, scale: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + y, bf16(LayerNorm(x + y) * (1 + scale) + shift)): the stream
    fp32 [B, L, D], y bf16, shift and scale [B, 1, D] fp32."""
    if x.device.type == "cpu":
        return residual_ln_modulate_reference(x, y, shift, scale, eps)
    B, L, D = _stream(x)
    dev = x.device
    xs = _rows(x, "x", torch.float32, (B, L, D), dev)
    ys = _rows(y, "y", BF16, (B, L, D), dev)
    e_sb = _mod_rows(shift, "shift", B, D, dev)
    if _mod_rows(scale, "scale", B, D, dev) != e_sb:
        raise NotImplementedError("shift and scale rows of different strides")
    x_out = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    tx = torch.empty((B, L, D), dtype=BF16, device=dev)
    with torch.cuda.device(dev):
        _launch("dit_residual_ln_modulate", x.data_ptr(), *xs, y.data_ptr(),
                *ys, shift.data_ptr(), scale.data_ptr(), e_sb,
                x_out.data_ptr(), tx.data_ptr(), B, L, D, *launch_shape(D),
                eps, _stream_ptr(dev))
    launches["residual_ln_modulate"] += 1
    return x_out, tx


def gate_residual(x: torch.Tensor, h: torch.Tensor, gate: torch.Tensor
                  ) -> torch.Tensor:
    """x + h * gate: the stream fp32 [B, L, D], h bf16, gate [B, 1, D]
    fp32."""
    if x.device.type == "cpu":
        return gate_residual_reference(x, h, gate)
    B, L, D = _stream(x)
    dev = x.device
    xs = _rows(x, "x", torch.float32, (B, L, D), dev)
    hs = _rows(h, "h", BF16, (B, L, D), dev)
    e_sb = _mod_rows(gate, "gate", B, D, dev)
    x_out = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("dit_gate_residual", x.data_ptr(), *xs, h.data_ptr(), *hs,
                gate.data_ptr(), e_sb, x_out.data_ptr(), B, L, D,
                *launch_shape(D), _stream_ptr(dev))
    launches["gate_residual"] += 1
    return x_out


def launch_counts() -> Dict[str, int]:
    return dict(launches)


def reset_counts() -> None:
    """Zero the launch counts and the block calls of both paths."""
    launches.update(dict.fromkeys(launches, 0))
    block_calls.update(fused=0, plain=0)
