"""The DiT block's fused elementwise passes (`videocof_torch/ops/dit_fused.py`)
on the CPU: each wrapper's plain version, which is also the block's plain
path, is the composed helpers bit for bit, the dispatch takes the plain
path on the CPU, under autograd and under tensor parallelism and counts
it, the launch shape covers every width the port runs, and every kernel
name counts as the benchmark's "other" DiT time. The kernels themselves are held against these plain
versions on the card (`tests/test_torch_cuda.py`)."""

import functools

import pytest
import torch

from cofbench.trace import kernel_class
from videocof_torch.configs import (WAN21_T2V_14B, WAN21_T2V_1_3B,
                                    WAN22_TI2V_5B, WAN_TINY)
from videocof_torch.models import rope as rope_lib
from videocof_torch.models.wan_dit import _layer_norm, _rms_norm, init_wan_dit
from videocof_torch.ops import dit_fused as df

EPS = 1e-6
bf16 = torch.bfloat16


def _inputs(B, L, D, hd, seed, per_sample=False):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dtype)

    e = randn(B, 6, D, scale=0.1)
    lead = (B,) if per_sample else ()
    ang = randn(*lead, L, hd // 2, scale=3.0)
    return dict(x=randn(B, L, D, scale=2.0), y=randn(B, L, D, dtype=bf16),
                e_=[e[:, i][:, None, :] for i in range(6)],
                q=randn(B, L, D, dtype=bf16), k=randn(B, L, D, dtype=bf16),
                w=1.0 + randn(D, dtype=bf16, scale=0.1),
                b=randn(D, dtype=bf16, scale=0.1),
                cos=torch.cos(ang), sin=torch.sin(ang))


SHAPES = [(1, 7, 96, 24, False), (2, 5, 96, 24, True),
          (2, 3, 1536, 128, False)]


def _stream_steps(B, L, D, hd, per_sample, norm3, dtype, passes):
    """Run ``passes`` (ln_modulate, gate_residual_ln, residual_ln_modulate,
    gate_residual) and hold each against the composed helpers whose
    branch outputs are in ``dtype``, bit for bit."""
    ln_mod, gate_ln, res_ln, gate_res = passes
    t = _inputs(B, L, D, hd, seed=D + L, per_sample=per_sample)
    x, y, e_ = t["x"], t["y"], t["e_"]
    sc, bi = (t["w"], t["b"]) if norm3 else (None, None)

    tx = ln_mod(x, e_[0], e_[1], EPS)
    want = (_layer_norm(x, EPS) * (1.0 + e_[1]) + e_[0]).to(dtype)
    assert tx.dtype == dtype and torch.equal(tx, want)

    x1, nx = gate_ln(x, y, e_[2], EPS, sc, bi)
    want_x = (x.float() + y.float() * e_[2]).to(x.dtype)
    want_nx = (_layer_norm(want_x, EPS, sc, bi) if norm3 else want_x).to(dtype)
    assert torch.equal(x1, want_x) and torch.equal(nx, want_nx)

    x2, tx2 = res_ln(x1, y, e_[3], e_[4], EPS)
    want_x = (x1.float() + y.float()).to(x.dtype)
    want_tx = (_layer_norm(want_x, EPS) * (1.0 + e_[4]) + e_[3]).to(dtype)
    assert torch.equal(x2, want_x) and torch.equal(tx2, want_tx)

    x3 = gate_res(x2, y, e_[5])
    assert torch.equal(x3, (x2.float() + y.float() * e_[5]).to(x.dtype))


@pytest.mark.parametrize("B,L,D,hd,per_sample", SHAPES)
@pytest.mark.parametrize("norm3", [True, False])
def test_stream_passes_are_the_block_steps_bit_for_bit(B, L, D, hd,
                                                       per_sample, norm3):
    """ln_modulate, gate_residual_ln, residual_ln_modulate and gate_residual
    on the CPU (their plain versions, which are also `WanBlock.forward`'s
    plain path) are `_layer_norm`, the modulation and the residual adds
    composed, bit for bit."""
    _stream_steps(B, L, D, hd, per_sample, norm3, bf16,
                  (df.ln_modulate, df.gate_residual_ln,
                   df.residual_ln_modulate, df.gate_residual))


@pytest.mark.parametrize("B,L,D,hd,per_sample", SHAPES)
@pytest.mark.parametrize("norm3", [True, False])
def test_plain_path_with_fp32_branches_is_the_composed_steps(
        B, L, D, hd, per_sample, norm3):
    """The plain versions with fp32 branches, as `WanBlock.forward` calls
    them for an fp32 context, are the same composed helpers, bit for
    bit."""
    f32 = torch.float32
    _stream_steps(B, L, D, hd, per_sample, norm3, f32, (
        functools.partial(df.ln_modulate_reference, dtype=f32),
        functools.partial(df.gate_residual_ln_reference, dtype=f32),
        functools.partial(df.residual_ln_modulate_reference, dtype=f32),
        df.gate_residual_reference))


@pytest.mark.parametrize("B,L,D,hd,per_sample", SHAPES)
@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("with_k", [True, False])
def test_qk_pass_is_rms_norm_then_rope_bit_for_bit(B, L, D, hd, per_sample,
                                                   rotate, with_k):
    """qk_norm_rope on the CPU is `_rms_norm` of q and k, then (with tables)
    `apply_rope` on their heads in fp32, as `Attention.forward` composes
    them, bit for bit; k may be left out."""
    t = _inputs(B, L, D, hd, seed=3 * D + L, per_sample=per_sample)
    tables = (t["cos"], t["sin"]) if rotate else ()
    k = t["k"] if with_k else None
    w_k = -t["w"]
    q, k_out = df.qk_norm_rope(t["q"], k, t["w"], w_k, EPS, *tables)

    def plain(x, w):
        x = _rms_norm(x, w, EPS).view(B, L, D // hd, hd)
        if rotate:
            x = rope_lib.apply_rope(x, *tables, compute_dtype=torch.float32)
        return x.reshape(B, L, D)

    assert q.dtype == bf16 and torch.equal(q, plain(t["q"], t["w"]))
    if with_k:
        assert torch.equal(k_out, plain(t["k"], w_k))
    else:
        assert k_out is None


def _block(cfg, dtype):
    g = torch.Generator().manual_seed(0)
    return init_wan_dit(cfg.replace(num_layers=1), g, dtype).blocks[0]


def _block_args(cfg, dtype, L=6):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, L, cfg.dim, generator=g)
    e0 = 0.1 * torch.randn(1, 6, cfg.dim, generator=g)
    ctx = torch.randn(1, 4, cfg.dim, generator=g).to(dtype)
    ang = torch.randn(L, cfg.head_dim // 2, generator=g)
    return x, e0, ctx, (torch.cos(ang), torch.sin(ang))


@pytest.mark.parametrize("grad", [False, True])
def test_block_takes_the_plain_path_on_the_cpu_and_counts_it(grad):
    """On the CPU every block call is plain, with or without autograd
    recording, and the counter says so; the output is the same either
    way."""
    blk = _block(WAN_TINY, bf16)
    args = _block_args(WAN_TINY, bf16)
    df.reset_counts()
    with torch.set_grad_enabled(grad):
        out = blk(*args)
    assert out.requires_grad == grad
    assert df.block_counts() == {"fused": 0, "plain": 1}
    assert sum(df.launch_counts().values()) == 0
    with torch.no_grad():
        assert torch.equal(out.detach(), blk(*args))
    assert df.block_counts() == {"fused": 0, "plain": 2}


class _Param:
    requires_grad = True


@pytest.mark.parametrize("case,reason", [
    ({"grads": (_Param(),)}, "autograd"),
    ({"tp": object()}, "tensor parallel"),
    ({"stream": torch.bfloat16}, "stream torch.bfloat16"),
    ({"q": torch.float32}, "q torch.float32"),
    ({"rope": torch.float64}, "rope torch.float64"),
    ({}, "device cpu"),
])
def test_dispatch_reasons(case, reason):
    """`plain_reason` names what sends a call to the plain path: autograd
    recording comes first (the kernels have no backward), then a TP context
    (RMSNorm's all-reduce), the dtypes, and last the device."""
    with torch.enable_grad():
        got = df.plain_reason(torch.device("cpu"),
                              case.get("stream", torch.float32),
                              case.get("q", bf16), case.get("tp"),
                              case.get("rope", torch.float32),
                              case.get("grads", ()))
    assert got == reason


def test_dispatch_ignores_requires_grad_without_grad_mode():
    with torch.no_grad():
        assert df.plain_reason(torch.device("cpu"), torch.float32, bf16,
                               None, None, (_Param(),)) == "device cpu"
    assert df.plain_reason(torch.device("cuda"), None, bf16, None, None,
                           ()) is None


@pytest.mark.parametrize("D", sorted({c.dim for c in (
    WAN_TINY, WAN21_T2V_1_3B, WAN22_TI2V_5B, WAN21_T2V_14B)}
    | {256, 4, 16384}))
def test_launch_shape_covers_the_row(D):
    vec, threads = df.launch_shape(D)
    assert 1 <= vec <= df.MAX_VEC and threads % 32 == 0
    assert 32 <= threads <= df.MAX_THREADS
    assert vec * threads * 4 >= D
    # at most one warp's vectors left idle
    assert vec * threads * 4 - D < 4 * vec * 32


def test_launch_shape_of_the_published_widths():
    assert df.launch_shape(5120) == (5, 256)
    assert df.launch_shape(1536) == (2, 192)


@pytest.mark.parametrize("D", [0, 6, 16388])
def test_launch_shape_refuses_other_widths(D):
    with pytest.raises(NotImplementedError):
        df.launch_shape(D)


@pytest.mark.parametrize("name", df.KERNEL_NAMES)
def test_kernel_names_read_other(name):
    """The passes' kernels, as the profiler names them, count as the DiT's
    "other" time (`dit_other_ms`), not as attention, GEMM or convolution."""
    args = ("(anonymous namespace)::QKArgs" if "qk" in name
            else "(anonymous namespace)::StreamArgs")
    for shown in (name, f"void (anonymous namespace)::{name}<5>({args})"):
        assert kernel_class(shown) == "other"


def test_cpu_wrappers_launch_nothing():
    t = _inputs(1, 3, 96, 24, seed=0)
    df.reset_counts()
    df.ln_modulate(t["x"], t["e_"][0], t["e_"][1], EPS)
    df.qk_norm_rope(t["q"], t["k"], t["w"], t["w"], EPS, t["cos"], t["sin"])
    df.gate_residual_ln(t["x"], t["y"], t["e_"][2], EPS, t["w"], t["b"])
    df.residual_ln_modulate(t["x"], t["y"], t["e_"][3], t["e_"][4], EPS)
    df.gate_residual(t["x"], t["y"], t["e_"][5])
    assert df.launch_counts() == dict.fromkeys(
        ("ln_modulate", "qk_norm_rope", "qk_norm_rope_q", "gate_residual_ln",
         "residual_ln_modulate", "gate_residual"), 0)


def test_block_without_cross_attention_norm_runs_plain():
    cfg = WAN_TINY.replace(cross_attn_norm=False)
    blk = _block(cfg, bf16)
    assert not hasattr(blk, "norm3")
    df.reset_counts()
    with torch.no_grad():
        out = blk(*_block_args(cfg, bf16))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert df.block_counts() == {"fused": 0, "plain": 1}


def test_wrappers_check_pairs():
    t = _inputs(1, 3, 96, 24, seed=0)
    with pytest.raises(ValueError):
        df.qk_norm_rope(t["q"], None, t["w"], None, EPS, t["cos"], None)
    with pytest.raises(ValueError):
        df.gate_residual_ln(t["x"], t["y"], t["e_"][2], EPS, t["w"], None)
