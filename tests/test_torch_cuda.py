"""The port on a CUDA device: the hand-written flash-attention kernels (the
forward B1, the forward with LSE B2, the backward B3) and the int8
attention kernel B4 against their plain versions, their shape checks, the
pipeline's and the trainer's default device, and fp8 weights, runtime LoRA,
the Wan2.2 pipeline and the Wan2.2 VAE on the card.

These tests need an NVIDIA GPU and nvcc, and skip without them. The module
imports neither JAX nor the JAX package, so that on a GPU machine without
JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from videocof_torch.configs import T5_TINY, VAE_TINY, WAN_TINY
from videocof_torch.models.t5_encoder import init_t5_encoder
from videocof_torch.models.wan_dit import init_wan_dit
from videocof_torch.models.wan_vae import init_wan_vae
from videocof_torch.ops import attention
from videocof_torch.ops import flash_attention as fa
from videocof_torch.ops import int8_attention as i8
from videocof_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_reference)
from videocof_torch.pipeline import WanPipeline
from videocof_torch.training import CoFTrainer, TrainerConfig

# bf16: the kernel and the plain version round P to bf16 against different
# running maxima (the tolerance of tests/test_flash_attention.py)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


def _qkv(cuda, B, Lq, Lk, N, D, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk + D)
    return [torch.randn(B, L, N, D, generator=g, device=cuda).to(dtype)
            for L in (Lq, Lk, Lk)]


def _run(q, k, v, mask=None):
    before = flash_attention.launches
    got = flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(got).all()
    want = flash_attention_reference(q, k, v, kv_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


# the forward's 128-row q tiles and 128-key K/V tiles: lengths on and beside
# their edges, at both head dims and both types
TILE_EDGES = [(Lq, Lk, D, dtype) for Lq in (1, 127, 129)
              for Lk in (1, 127, 129, 512) for D in (64, 128)
              for dtype in (torch.bfloat16, torch.float16)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,D,dtype", [
    (300, 300, 128, torch.bfloat16), (256, 130, 64, torch.bfloat16),
    (1000, 700, 128, torch.float16), (64, 1, 64, torch.bfloat16),
] + TILE_EDGES)
def test_kernel_matches_plain(cuda, Lq, Lk, D, dtype):
    _run(*_qkv(cuda, 2, Lq, Lk, 3, D, dtype))


@pytest.mark.cuda
def test_kernel_key_mask_with_fully_masked_row(cuda):
    q, k, v = _qkv(cuda, 2, 256, 130, 3, 64)
    g = torch.Generator(device=cuda).manual_seed(1)
    mask = torch.rand(2, 130, generator=g, device=cuda) > 0.3
    mask[-1] = False
    _run(q, k, v, mask)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of one packed [B, L, 3, N, D] tensor: no copy."""
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(1, 333, 3, 2, 128, generator=g, device=cuda
                      ).to(torch.bfloat16)
    _run(*qkv.unbind(2))


@pytest.mark.cuda
def test_kernel_reads_broadcast_inputs(cuda):
    """k and v expanded over the batch or over the heads (stride 0): the TMA
    tensor maps take a zero stride."""
    q, k, v = _qkv(cuda, 2, 300, 200, 3, 128)
    _run(q, k[:1].expand(2, -1, -1, -1), v[:1].expand(2, -1, -1, -1))
    _run(q, k[:, :, :1].expand(-1, -1, 3, -1),
         v[:, :, :1].expand(-1, -1, 3, -1))


@pytest.mark.cuda
def test_unsupported_inputs_raise(cuda):
    for shape, dtype in (((1, 64, 2, 96), torch.bfloat16),
                         ((1, 64, 2, 128), torch.float32)):
        x = torch.zeros(shape, dtype=dtype, device=cuda)
        with pytest.raises(NotImplementedError):
            attention(x, x, x)
    x = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):   # D not contiguous
        attention(x, x, x.transpose(1, 3).contiguous().transpose(1, 3))


@pytest.mark.cuda
def test_unaligned_rows_raise_before_any_tensor_map(cuda, monkeypatch):
    """A row stride that is not a multiple of 16 bytes, or a base that is not
    16-byte aligned, raises in the wrapper: the kernel's library (which
    encodes the TMA tensor maps) is never reached."""
    def no_library():
        raise AssertionError("the kernel's library was reached")

    monkeypatch.setattr(fa, "_library", no_library)
    bf16 = torch.bfloat16
    wide = torch.zeros(1, 64, 2, 132, dtype=bf16, device=cuda)[..., :128]
    flat = torch.zeros(64 * 2 * 128 + 8, dtype=bf16, device=cuda)
    shifted = flat[1:1 + 64 * 2 * 128].view(1, 64, 2, 128)
    ok = torch.zeros(1, 64, 2, 128, dtype=bf16, device=cuda)
    for bad in (wide, shifted):
        for args in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            with pytest.raises(NotImplementedError):
                flash_attention(*args)
            with pytest.raises(NotImplementedError):
                fa.flash_fwd_lse(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16),
                                     (64, torch.float16)])
def test_forward_without_lse_equals_forward_with_lse_bitwise(cuda, D, dtype):
    """B1(q, scale) and B2(round(q * scale), scale 1) scale q in the same two
    roundings and share the kernel's arithmetic: equal bit for bit."""
    q, k, v = _qkv(cuda, 2, 777, 555, 3, D, dtype)
    scale = 0.3
    out1 = flash_attention(q, k, v, scale=scale)
    out2, _ = fa.flash_fwd_lse(q * fa._rounded(scale, dtype), k, v)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)


@pytest.mark.cuda
def test_forward_kernels_are_deterministic(cuda):
    """No atomics: two launches give the same bits, out and LSE."""
    q, k, v = _qkv(cuda, 1, 1000, 1000, 2, 128)
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))
    a, b = fa.flash_fwd_lse(q, k, v), fa.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_pipeline_defaults_to_the_kernel(cuda):
    """WanPipeline with no device runs on CUDA and every DiT attention goes
    through the kernel; the edit agrees with the naive backend."""
    dcfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2,
                            in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = torch.bfloat16
    pipe = WanPipeline(init_wan_dit(dcfg, g, bf16),
                       init_wan_vae(VAE_TINY, g, bf16),
                       init_t5_encoder(T5_TINY, g, bf16), dtype=bf16)
    assert pipe.device.type == "cuda"
    video = np.random.default_rng(0).integers(0, 256, (1, 3, 9, 32, 32),
                                              dtype=np.uint8)
    kw = dict(source_frames=9, reasoning_frames=4, num_inference_steps=2,
              output_latents=True)
    before = flash_attention.launches
    a = pipe(video, "remove the ball", **kw)
    assert flash_attention.launches - before == 2 * dcfg.num_layers * 2
    pipe.attn_backend = "naive"
    b = pipe(video, "remove the ball", **kw)
    assert a.videos.shape == (1, 3, 10, 32, 32)
    assert np.isfinite(a.latents).all()
    rel = np.linalg.norm(a.latents - b.latents) / np.linalg.norm(b.latents)
    assert rel <= 5e-2


# B2 against its plain version: relative L2 error
REL_TOL = 1e-2
# B3 against the plain backward in its own arithmetic (``rounded=True``: P
# and dS rounded to the input type, as the kernel feeds them to the tensor
# cores); what is left is summation order, and for dq the order of the key
# tiles' reduce-adds, before the final rounding
B3_ROUNDED_TOL = 1e-3
# B3 against the fp32 plain backward, JAX's arithmetic: at most 1.5x the size
# of the rounding itself on the same inputs, the rounded plain backward's
# relative L2 against the fp32 one (about 2.6e-3 in bf16 and 3.2e-4 in fp16
# at the self and cross shapes, as the earlier B3a/B3b measured; larger on a
# few q rows, where dq's sum over the keys cancels; PERF.md)
B3_FP32_FACTOR = 1.5


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _close(got, want, rel_tol=REL_TOL):
    """Finite, relative L2 error <= rel_tol (None: not checked), and max abs
    error <= 3e-2 * max(1, max |want|): a few bf16 ulps of the largest
    value (gradients reach several units at these lengths)."""
    assert torch.isfinite(got).all()
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = _rel(got, want)
    scale = max(1.0, want.float().abs().max().item())
    assert err <= 3e-2 * scale, (err, rel, scale)
    assert rel_tol is None or rel <= rel_tol, (err, rel, scale)


def _check_fwd_bwd(q, k, v, do, mask=None):
    """B2 and B3 against their plain versions on the same inputs (the
    backward kernels get the plain LSE and delta, so each is held alone)."""
    dtype = q.dtype
    qs = q * fa._rounded(q.shape[-1] ** -0.5, dtype)
    before = fa.launch_counts()
    out, lse = fa.flash_fwd_lse(qs, k, v, kv_mask=mask)
    ref_out, ref_lse = fa.flash_fwd_lse_reference(qs, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    _close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    if mask is not None:
        return
    delta = fa.flash_bwd_delta(ref_out, do)
    got = fa.flash_bwd(qs, k, v, do, ref_lse, delta)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype for g in got)
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
        "flash_attention_bwd": 1}
    # with one key P = 1 and dS = P (dP - delta) = 0 but for rounding: dq
    # and dk are rounding noise there, held by the absolute bound alone
    one_key = k.shape[1] == 1
    want = {rounded: (fa.flash_bwd_dq_reference(qs, k, v, do, ref_lse, delta,
                                                rounded=rounded),
                      *fa.flash_bwd_dkv_reference(qs, k, v, do, ref_lse,
                                                  delta, rounded=rounded))
            for rounded in (True, False)}
    for part, g, w, w32 in zip("qkv", got, want[True], want[False]):
        noise = one_key and part != "v"
        _close(g, w, None if noise else B3_ROUNDED_TOL)
        _close(g, w32, None if noise else B3_FP32_FACTOR * _rel(w, w32))


# B3's 64-row q tiles and 128-key tiles: the forward's edges and Lq 63/65
BWD_TILE_EDGES = TILE_EDGES + [
    (Lq, Lk, D, dtype) for Lq in (63, 65) for Lk in (1, 127, 129, 512)
    for D in (64, 128) for dtype in (torch.bfloat16, torch.float16)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,D,dtype", [
    (300, 300, 128, torch.bfloat16), (256, 130, 64, torch.bfloat16),
    (1000, 700, 128, torch.float16), (64, 1, 64, torch.bfloat16),
    (77, 513, 128, torch.bfloat16), (1000, 700, 64, torch.float16),
] + BWD_TILE_EDGES)
def test_lse_and_backward_kernels_match_plain(cuda, Lq, Lk, D, dtype):
    q, k, v = _qkv(cuda, 2, Lq, Lk, 3, D, dtype)
    g = torch.Generator(device=cuda).manual_seed(7)
    do = torch.randn(2, Lq, 3, D, generator=g, device=cuda).to(dtype)
    _check_fwd_bwd(q, k, v, do)


@pytest.mark.cuda
def test_lse_kernel_with_fully_masked_row(cuda):
    q, k, v = _qkv(cuda, 2, 256, 130, 3, 64)
    g = torch.Generator(device=cuda).manual_seed(1)
    mask = torch.rand(2, 130, generator=g, device=cuda) > 0.3
    mask[-1] = False
    _check_fwd_bwd(q, k, v, None, mask)
    _, lse = fa.flash_fwd_lse(q, k, v, kv_mask=mask)
    assert torch.isfinite(lse).all() and lse[-1].max().item() < -6e29


@pytest.mark.cuda
def test_backward_kernels_read_strided_inputs(cuda):
    """q, k, v as views of one packed [B, L, 3, N, D] tensor, dO a view too."""
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(1, 333, 3, 2, 128, generator=g, device=cuda
                      ).to(torch.bfloat16)
    do2 = torch.randn(1, 333, 2, 2, 128, generator=g, device=cuda
                      ).to(torch.bfloat16)
    _check_fwd_bwd(*qkv.unbind(2), do2[:, :, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16),
                                     (64, torch.float16)])
def test_backward_kernel_is_deterministic_but_for_dq(cuda, D, dtype):
    """dk and dv come from one CTA each: two launches give the same bits. The
    key tiles add dQ into its fp32 accumulator in no fixed order, so dq may
    differ between launches, by at most one ulp of its dtype where a value
    is not far below the largest (|dq| >= 2^-8 max |dq|); below that the
    fp32 sums' order, 2^-24 of the terms a few times over, shows through
    the cast (fp16's subnormals)."""
    q, k, v = _qkv(cuda, 2, 1000, 1000, 3, D, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    do = torch.randn(2, 1000, 3, D, generator=g, device=cuda).to(dtype)
    out, lse = fa.flash_fwd_lse(q, k, v)
    delta = fa.flash_bwd_delta(out, do)
    a = fa.flash_bwd(q, k, v, do, lse, delta)
    b = fa.flash_bwd(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    fi = torch.finfo(dtype)
    mag = torch.maximum(a[0].float().abs(), b[0].float().abs())
    floor = max(mag.max().item() * 2.0 ** -8, fi.tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=floor)))) * fi.eps
    assert ((a[0].float() - b[0].float()).abs() <= ulp).all()


@pytest.mark.cuda
def test_autograd_runs_the_kernels(cuda):
    """flash_attention with inputs that need a gradient: B2 forward, B3
    backward, and gradients that agree with autograd through the naive
    backend."""
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, 1, 400, 300, 2, 128))
    do = torch.randn(1, 400, 2, 128, device=cuda).to(torch.bfloat16)
    before = fa.launch_counts()
    out = attention(q, k, v)
    torch.autograd.backward(out, do)
    after = fa.launch_counts()
    assert [after[n] - before[n] for n in after] == [0, 1, 1]
    grads = [t.grad for t in (q, k, v)]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.backward(attention(*leaves, backend="naive"), do)
    _close(out, attention(*leaves, backend="naive"), rel_tol=2e-2)
    for got, leaf in zip(grads, leaves):
        _close(got, leaf.grad, rel_tol=2e-2)


@pytest.mark.cuda
def test_backward_kernels_raise_on_unsupported_inputs(cuda):
    x = torch.zeros(1, 64, 2, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):       # head_dim 96
        flash_attention(x.requires_grad_(), x, x)
    q = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(NotImplementedError):       # fp32
        fa.flash_bwd(q.float(), q.float(), q.float(), q.float(), lse, lse)
    with pytest.raises(NotImplementedError):       # dO of another dtype
        fa.flash_bwd(q, q, q, q.half(), lse, lse)
    with pytest.raises(ValueError):                # lse not fp32 [B, N, Lq]
        fa.flash_bwd(q, q, q, q, lse.transpose(1, 2), lse)


@pytest.mark.cuda
def test_trainer_defaults_to_the_kernels(cuda):
    """CoFTrainer with no device trains on CUDA through B2 and B3: with
    block remat, B2 runs in the forward and again in the recompute."""
    dcfg = WAN_TINY.replace(dim=128, ffn_dim=256, num_heads=2,
                            in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = torch.bfloat16
    dit = init_wan_dit(dcfg, g, bf16)
    tcfg = TrainerConfig(height=16, width=16, source_frames=5,
                         target_frames=5, reasoning_frames=4, lora_rank=4,
                         learning_rate=1e-3)
    trainer = CoFTrainer(dit, init_wan_vae(VAE_TINY, g, bf16),
                         init_t5_encoder(T5_TINY, g, bf16), None, tcfg)
    assert trainer.device.type == "cuda"
    rng = np.random.default_rng(0)

    def samples():
        while True:
            yield {k: rng.uniform(-1, 1, (3, T, 16, 16)).astype(np.float32)
                   for k, T in (("pixel_src", 5), ("pixel_ground", 4),
                                ("pixel_tgt", 5))} | {"text": "remove it"}

    fa.reset_launch_counts()
    trainer.train(samples(), total_steps=1)
    n = 2 * dcfg.num_layers
    assert fa.launch_counts() == {
        "flash_attention_fwd": 0, "flash_attention_fwd_lse": 2 * n,
        "flash_attention_bwd": n}
    assert np.isfinite(trainer.losses).all()


# B4 against its plain version: the same int8 values on both sides (an
# element on a rounding boundary may flip one level where the two K means
# differ in the last bit), then B1's bf16 tolerances
def _check_int8(q, k, v, mask=None):
    before = i8.launch_counts()
    got = i8.int8_flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    after = i8.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "int8_quantize_k": 1, "int8_attention_fwd": 1}
    assert got.dtype == v.dtype
    _close(got, i8.int8_flash_attention_reference(q, k, v, kv_mask=mask))


# B4's 128-row q tiles and its K/V tiles (128 keys at D = 128, 64 at
# D = 256): lengths on and beside their edges, at both head dims and types
INT8_TILE_EDGES = [(Lq, Lk, D, dtype) for Lq in (1, 127, 129)
                   for Lk in (1, 127, 129, 512) for D in (128, 256)
                   for dtype in (torch.bfloat16, torch.float16)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,D,dtype", [
    (300, 300, 128, torch.bfloat16), (256, 130, 128, torch.bfloat16),
    (1000, 700, 128, torch.float16), (64, 1, 128, torch.bfloat16),
    (77, 513, 256, torch.bfloat16), (333, 200, 256, torch.float16),
] + INT8_TILE_EDGES)
def test_int8_kernel_matches_plain(cuda, Lq, Lk, D, dtype):
    _check_int8(*_qkv(cuda, 2, Lq, Lk, 3, D, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
def test_int8_kernels_are_deterministic(cuda, D):
    """No atomics: two launches of each B4 kernel give the same bits."""
    q, k, v = _qkv(cuda, 2, 1000, 777, 2, D)
    mean = i8.k_mean(k)
    (ki, sk), (ki2, sk2) = i8.int8_quantize_k(k, mean), i8.int8_quantize_k(
        k, mean)
    a = i8.int8_attention_fwd(q, ki, sk, v)
    b = i8.int8_attention_fwd(q, ki, sk, v)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki2) and torch.equal(sk, sk2)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_int8_unaligned_rows_raise_before_any_tensor_map(cuda, monkeypatch):
    """A row stride that is not a multiple of 16 bytes, or a base that is not
    16-byte aligned, raises in the wrapper: the kernels' library (which
    encodes the TMA tensor maps) is never reached."""
    def no_library():
        raise AssertionError("the kernels' library was reached")

    monkeypatch.setattr(i8, "_library", no_library)
    bf16 = torch.bfloat16
    wide = torch.zeros(1, 64, 2, 132, dtype=bf16, device=cuda)[..., :128]
    flat = torch.zeros(64 * 2 * 128 + 8, dtype=bf16, device=cuda)
    shifted = flat[1:1 + 64 * 2 * 128].view(1, 64, 2, 128)
    ok = torch.zeros(1, 64, 2, 128, dtype=bf16, device=cuda)
    ki = torch.zeros(1, 2, 64, 128, dtype=torch.int8, device=cuda)
    sk = torch.ones(1, 2, 64, device=cuda)
    for bad in (wide, shifted):
        for args in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            with pytest.raises(NotImplementedError):
                i8.int8_flash_attention(*args)
        with pytest.raises(NotImplementedError):
            i8.int8_attention_fwd(bad, ki, sk, ok)
        with pytest.raises(NotImplementedError):
            i8.int8_attention_fwd(ok, ki, sk, bad)
    sk_flat = torch.ones(2 * 64 + 1, device=cuda)
    with pytest.raises(NotImplementedError):   # sk off 16 bytes
        i8.int8_attention_fwd(ok, ki, sk_flat[1:].view(1, 2, 64), ok)


@pytest.mark.cuda
def test_int8_kernel_key_mask_with_fully_masked_row(cuda):
    """A fully masked row averages V over the Pallas wrapper's padded key
    length (256 for Lk = 130)."""
    q, k, v = _qkv(cuda, 2, 256, 130, 3, 128)
    g = torch.Generator(device=cuda).manual_seed(1)
    mask = torch.rand(2, 130, generator=g, device=cuda) > 0.3
    mask[-1] = False
    _check_int8(q, k, v, mask)
    out = i8.int8_flash_attention(q, k, v, kv_mask=mask)
    want = (v[-1].float().sum(0) / 256).expand(256, 3, 128)
    torch.testing.assert_close(out[-1].float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_int8_kernels_read_strided_inputs(cuda):
    """q, k, v as views of one packed [B, L, 3, N, D] tensor: no copy."""
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(2, 333, 3, 2, 128, generator=g, device=cuda
                      ).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    _check_int8(q, k, v)
    ki, sk = i8.int8_quantize_k(k, i8.k_mean(k))
    want_i, want_s = i8.quantize_k_reference(k, i8.k_mean(k))
    torch.testing.assert_close(sk, want_s, rtol=1e-6, atol=0)
    assert (ki.int() - want_i.int()).abs().max().item() <= 1


@pytest.mark.cuda
def test_int8_unsupported_inputs_raise(cuda):
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):            # head_dim 64
        attention(x, x, x, backend="int8")
    x = torch.zeros(1, 64, 2, 384, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):            # no D = 384 build
        attention(x, x, x, backend="int8")
    x = torch.zeros(1, 64, 2, 128, device=cuda)
    with pytest.raises(NotImplementedError):            # fp32
        attention(x, x, x, backend="int8")
    x = x.to(torch.bfloat16)
    with pytest.raises(NotImplementedError):            # D not contiguous
        attention(x, x, x.transpose(1, 3).contiguous().transpose(1, 3),
                  backend="int8")
    with pytest.raises(NotImplementedError):            # no gradient
        attention(x.requires_grad_(), x, x, backend="int8")


@pytest.mark.cuda
def test_int8_cfg_edit_runs_the_kernel(cuda):
    """A 2-step CFG edit through the int8 backend on the card: every
    attention goes through B4 (both of its kernels, batch 2), no flash
    kernel runs, and the edit agrees with the naive backend."""
    dcfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2,
                            in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = torch.bfloat16
    pipe = WanPipeline(init_wan_dit(dcfg, g, bf16),
                       init_wan_vae(VAE_TINY, g, bf16),
                       init_t5_encoder(T5_TINY, g, bf16), dtype=bf16,
                       attn_backend="int8")
    video = np.random.default_rng(0).integers(0, 256, (1, 3, 9, 32, 32),
                                              dtype=np.uint8)
    kw = dict(source_frames=9, reasoning_frames=4, num_inference_steps=2,
              guidance_scale=5.0, negative_prompt="blurry",
              output_latents=True)
    fa.reset_launch_counts()
    i8.reset_launch_counts()
    a = pipe(video, "remove the ball", **kw)
    n = 2 * dcfg.num_layers * 2
    assert i8.launch_counts() == {"int8_quantize_k": n,
                                  "int8_attention_fwd": n}
    assert not any(fa.launch_counts().values())
    pipe.attn_backend = "naive"
    b = pipe(video, "remove the ball", **kw)
    assert a.videos.shape == (1, 3, 10, 32, 32)
    assert np.isfinite(a.latents).all()
    rel = np.linalg.norm(a.latents - b.latents) / np.linalg.norm(b.latents)
    assert rel <= 5e-2


# B1 at the head count of Wan2.1 T2V 14B (40 heads of 128), at small and
# ragged lengths: its grid and tensor maps over [B, L, N, D] strides
@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk", [(1, 1000, 1000), (1, 129, 512),
                                     (2, 255, 130), (1, 3001, 1),
                                     (2, 1, 700)])
def test_kernel_matches_plain_at_40_heads(cuda, B, Lq, Lk):
    _run(*_qkv(cuda, B, Lq, Lk, 40, 128))


@pytest.mark.cuda
def test_safetensors_reader_loads_onto_the_card(cuda, tmp_path):
    """The port's reader (no safetensors package) and writer carry bf16,
    fp32 and int tensors to and from the card bit for bit."""
    from videocof_torch.models.weights import read_safetensors
    from videocof_torch.utils.checkpoint import write_safetensors
    g = torch.Generator(device=cuda).manual_seed(3)
    want = {"w": torch.randn(300, 129, generator=g, device=cuda
                             ).to(torch.bfloat16),
            "b": torch.randn(129, generator=g, device=cuda),
            "i": torch.arange(7, device=cuda)}
    path = str(tmp_path / "t.safetensors")
    write_safetensors(path, want)
    for k, v in read_safetensors(path).items():
        got = v.to(cuda)
        assert got.dtype == want[k].dtype and torch.equal(got, want[k]), k


@pytest.mark.cuda
def test_factory_loads_a_checkpoint_directory_onto_the_card(cuda, tmp_path):
    """`load_pipeline` on a tiny published-layout directory with a LoRA
    file: it defaults to the card, holds the files' weights merged as on
    the CPU, and its edit runs through B1."""
    from _published_layouts import t5_published_name, vae_published_name
    from videocof_torch import factory
    from videocof_torch.models import lora
    from videocof_torch.models.t5_encoder import T5Encoder
    from videocof_torch.models.wan_dit import WanDiT
    from videocof_torch.models.wan_vae import WanVAE
    from videocof_torch.utils.checkpoint import (save_dit_checkpoint_dir,
                                                 write_safetensors)
    dcfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2,
                            in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator().manual_seed(4)
    fill = lambda sd: {k: 0.05 * torch.randn(v.shape, generator=g)  # noqa
                       for k, v in sd.items()}
    root = str(tmp_path / "ckpt")
    dit = WanDiT(dcfg, dtype=torch.bfloat16)
    dit.load_state_dict(fill(dit.state_dict()))
    save_dit_checkpoint_dir(root, dit, dcfg)
    torch.save({vae_published_name(k, VAE_TINY): v for k, v in
                fill(WanVAE(VAE_TINY).state_dict()).items()},
               f"{root}/{factory.VAE_SUBPATH}")
    torch.save({t5_published_name(k): v for k, v in
                fill(T5Encoder(T5_TINY).state_dict()).items()},
               f"{root}/{factory.T5_SUBPATH}")
    lora_sd = {f"blocks.{i}.{m}.lora_{p}.weight": 0.1 * torch.randn(
        (4, 256) if p == "A" else (256, 4), generator=g)
        for i in range(dcfg.num_layers) for m in ("self_attn.q", "cross_attn.o")
        for p in "AB"}
    lora_path = str(tmp_path / "lora.safetensors")
    write_safetensors(lora_path, lora_sd)
    pipe = factory.load_pipeline(root, vae_cfg=VAE_TINY, t5_cfg=T5_TINY,
                                 require_real_tokenizer=False,
                                 lora_paths=[(lora_path, 1.0)])
    assert pipe.device.type == "cuda"
    merged = set(lora.merge_lora(dit, lora_path))
    for k, v in dit.state_dict().items():
        got = pipe.dit.state_dict()[k]
        assert got.device.type == "cuda"
        if k.rsplit(".", 1)[0] in merged:
            # the fp32 product on the card and on the host: one bf16 ulp
            torch.testing.assert_close(got.cpu().float(), v.float(),
                                       rtol=2 ** -7, atol=0)
        else:
            assert torch.equal(got.cpu(), v), k
    video = np.random.default_rng(0).integers(0, 256, (1, 3, 9, 32, 32),
                                              dtype=np.uint8)
    before = flash_attention.launches
    out = pipe(video, "remove the ball", source_frames=9, reasoning_frames=4,
               num_inference_steps=2)
    assert flash_attention.launches - before == 2 * dcfg.num_layers * 2
    assert out.videos.shape == (1, 3, 10, 32, 32)


# B1 with a key mask of per-row ragged lengths at batch 2 (a ragged batch's
# self-attention: row 0's keys valid up to its own length, row 1's all), the
# lengths on and beside the kernel's 128-key tile
@pytest.mark.cuda
@pytest.mark.parametrize("Lk,len0", [(256, 127), (256, 128), (256, 129),
                                     (300, 129), (129, 1), (513, 384),
                                     (1000, 640)])
def test_kernel_matches_plain_with_ragged_key_lengths(cuda, Lk, len0):
    q, k, v = _qkv(cuda, 2, Lk, Lk, 3, 128)
    mask = torch.arange(Lk, device=cuda)[None] < torch.tensor(
        [len0, Lk], device=cuda)[:, None]
    _run(q, k, v, mask)
    # row 0 equals its own unmasked attention over its valid keys
    alone = flash_attention(q[:1], k[:1, :len0], v[:1, :len0])
    got = flash_attention(q, k, v, kv_mask=mask)[:1]
    torch.testing.assert_close(got.float(), alone.float(), **BF16_TOL)


@pytest.mark.cuda
def test_streaming_vae_matches_whole_in_bf16(cuda):
    """The streaming VAE against the whole-sequence VAE on the card in bf16
    (cuDNN may pick another convolution algorithm per chunk shape, so the
    two agree to bf16 rounding, not bit for bit): relative L2 <= 2e-2, and
    uint8 frames at most 2 levels apart on average."""
    from videocof_torch.models import wan_vae_streaming as stream
    g = torch.Generator(device=cuda).manual_seed(0)
    vae = init_wan_vae(VAE_TINY, g, torch.bfloat16)
    x = torch.rand(1, 3, 13, 32, 32, generator=g, device=cuda) * 2 - 1
    x = x.to(torch.bfloat16)
    rel = lambda a, b: ((a.float() - b.float()).norm()  # noqa: E731
                        / b.float().norm()).item()
    with torch.no_grad():
        mu, _ = vae.encode(x)
        for chunk in (1, 3, 4):
            assert rel(stream.encode_streaming(vae, x, chunk)[0], mu) <= 2e-2
        z = torch.randn(1, VAE_TINY.z_dim, 6, 4, 4, generator=g, device=cuda)
        whole = vae.decode(z.to(torch.bfloat16))
        for chunk in (2, 3):
            assert rel(stream.decode_streaming(
                vae, z.to(torch.bfloat16), chunk), whole) <= 2e-2
            u8 = stream.decode_streaming_u8(vae, z, chunk,
                                            compute_dtype=torch.bfloat16)
            want = torch.round(whole.float() * 127.5 + 127.5)
            assert u8.dtype == torch.uint8 and u8.shape == want.shape
            assert (u8.float() - want).abs().mean().item() <= 2.0


@pytest.mark.cuda
def test_apply_rope_with_per_sample_tables(cuda):
    """[B, L, D/2] tables on the card: each row as its own [L, D/2] table
    rotates it, bit for bit, and as the CPU's fp32 rotation."""
    from videocof_torch.models import rope
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 40, 3, 128, generator=g, device=cuda).to(torch.bfloat16)
    tables = [rope.build_rope_cos_sin((f, 2, 5), 128, f_src=f // 2,
                                      f_ground=1) for f in (4, 7)]
    cos, sin = (torch.stack([torch.from_numpy(t[j][:40]) for t in tables])
                .to(cuda) for j in (0, 1))
    got = rope.apply_rope(x, cos, sin)
    for b in range(2):
        assert torch.equal(got[b:b + 1],
                           rope.apply_rope(x[b:b + 1], cos[b], sin[b]))
    want = rope.apply_rope(x.cpu().float(), cos.cpu(), sin.cpu())
    torch.testing.assert_close(got.cpu().float(), want, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.cuda
def test_ragged_batch_runs_the_kernel_with_key_masks(cuda, monkeypatch):
    """batch_edit on the card: every self-attention launch of B1 carries
    the batch's [2, L] key mask; each item agrees with its own run."""
    from videocof_torch.pipeline import batch_edit
    dcfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2,
                            in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = torch.bfloat16
    pipe = WanPipeline(init_wan_dit(dcfg, g, bf16),
                       init_wan_vae(VAE_TINY, g, bf16),
                       init_t5_encoder(T5_TINY, g, bf16), dtype=bf16)
    rng = np.random.default_rng(0)
    videos = [rng.integers(0, 256, (3, f, 32, 32), dtype=np.uint8)
              for f in (9, 17)]
    embeds = [rng.standard_normal((dcfg.text_len, dcfg.text_dim))
              .astype(np.float32) for _ in videos]
    calls = []
    real = fa._forward_b1
    monkeypatch.setattr(fa, "_forward_b1", lambda q, k, v, m, *a: (
        calls.append((q.shape[0], k.shape[1], None if m is None
                      else m.sum(dim=1).tolist())), real(q, k, v, m, *a))[1])
    before = flash_attention.launches
    outs = batch_edit(pipe, videos, [9, 17], embeds, num_inference_steps=2,
                      output_latents=True)
    # 11 latent frames x 2 x 2 tokens; item 0's 7 x 2 x 2
    assert flash_attention.launches - before == len(calls) == (
        2 * dcfg.num_layers * 2)
    assert [c for c in calls if c[2] is not None] == [(2, 44, [28, 44])] * (
        dcfg.num_layers * 2)
    for i, v in enumerate(videos):
        one = pipe(v[None], "p", source_frames=v.shape[1],
                   prompt_embeds=embeds[i][None], num_inference_steps=2,
                   seed=i, output_latents=True)
        rel = (np.linalg.norm(outs[i].latents - one.latents)
               / np.linalg.norm(one.latents))
        assert rel <= 2e-2


@pytest.mark.cuda
def test_fp8_dequantization_on_the_card_equals_the_cpu(cuda):
    """Quantization on the card, and the dequantized bf16 weights, bit for
    bit those of the CPU."""
    from videocof_torch.utils import fp8
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(512, 384, generator=g, device=cuda).to(torch.bfloat16)
    q, scale = fp8.quantize_weight(w)
    qc, sc = fp8.quantize_weight(w.cpu())
    assert torch.equal(q.view(torch.uint8).cpu(), qc.view(torch.uint8))
    assert torch.equal(scale.cpu(), sc)
    lin = torch.nn.Linear(384, 512, bias=False, device=cuda,
                          dtype=torch.bfloat16)
    lin.weight.data.copy_(w)
    fp8.quantize_dit_fp8(torch.nn.ModuleDict({"fc": lin}))
    assert fp8.is_fp8(lin)
    want = (qc.float() * sc).to(torch.bfloat16)
    assert torch.equal(fp8.dequantize(lin).cpu(), want)


@pytest.mark.cuda
def test_fp8_dit_with_runtime_lora_through_the_kernel(cuda):
    """A 2-block DiT with fp8 weights and runtime LoRA adapters through B1
    against the naive backend on the same weights."""
    from videocof_torch.models import lora
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.utils import fp8
    dcfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2)
    g = torch.Generator(device=cuda).manual_seed(4)
    dit = fp8.quantize_dit_fp8(init_wan_dit(dcfg, g, torch.bfloat16))
    ad = lora.init_lora_adapters(dcfg, g, rank=8)
    for block in ad.blocks:
        for mod in block.values():
            for lin in mod.values():
                lin.up.data.normal_(0.0, 0.2, generator=g)
    dit.runtime_lora = (ad, 1.0)
    grid = (3, 4, 4)
    x = torch.randn(1, dcfg.in_dim, 3, 8, 8, generator=g, device=cuda)
    ctx = torch.randn(1, 16, dcfg.text_dim, generator=g, device=cuda)
    cos, sin = (torch.as_tensor(a, device=cuda)
                for a in make_rope_for_geometry(dcfg, grid))
    t = torch.tensor([700.0], device=cuda)
    before = flash_attention.launches
    with torch.no_grad():
        got = dit(x.to(torch.bfloat16), t, ctx.to(torch.bfloat16), cos, sin,
                  attn_backend="flash")
        want = dit(x.to(torch.bfloat16), t, ctx.to(torch.bfloat16), cos, sin,
                   attn_backend="naive")
        plain = dit(x.to(torch.bfloat16), t, ctx.to(torch.bfloat16), cos,
                    sin, attn_backend="naive", lora=(ad, 0.0))
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 2 * dcfg.num_layers
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    assert torch.isfinite(got).all() and rel(got, want) <= 2e-2
    assert rel(plain, want) > 0.1      # the adapters did act


def _tiny_wan22(cuda, vae_cfg=None):
    from videocof_torch.configs import WAN22_VAE_TINY
    from videocof_torch.models.wan_vae22 import init_wan22_vae
    from videocof_torch.pipeline import Wan22Pipeline
    vae_cfg = vae_cfg or VAE_TINY
    dcfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2,
                            in_dim=vae_cfg.z_dim, out_dim=vae_cfg.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(5)
    bf16 = torch.bfloat16
    init_vae = (init_wan22_vae if vae_cfg is WAN22_VAE_TINY
                else init_wan_vae)
    return dcfg, Wan22Pipeline(
        init_wan_dit(dcfg, g, bf16), init_vae(vae_cfg, g, bf16),
        init_t5_encoder(T5_TINY, g, bf16), dtype=bf16,
        dit_2=init_wan_dit(dcfg, g, bf16))


@pytest.mark.cuda
def test_wan22_edit_and_t2v_on_the_card(cuda):
    """The dual-expert edit (fp8 experts, 4 steps at shift 5: two steps on
    each expert) and text-to-video on the card: B1 in every attention."""
    from videocof_torch.utils import fp8
    dcfg, pipe = _tiny_wan22(cuda)
    for d in (pipe.dit, pipe.dit_2):
        fp8.quantize_dit_fp8(d)
    calls = {"dit": 0, "dit_2": 0}
    hooks = [getattr(pipe, n).blocks[0].register_forward_pre_hook(
        lambda *_, n=n: calls.__setitem__(n, calls[n] + 1)) for n in calls]
    video = np.random.default_rng(0).integers(0, 256, (1, 3, 9, 32, 32),
                                              dtype=np.uint8)
    before = flash_attention.launches
    out = pipe(video, "p", source_frames=9, num_inference_steps=4,
               guidance_scale=1.0)
    assert calls == {"dit": 2, "dit_2": 2}
    assert flash_attention.launches - before == 2 * dcfg.num_layers * 4
    assert out.videos.shape == (1, 3, 10, 32, 32)
    assert np.isfinite(out.videos).all()
    before = flash_attention.launches
    t2v = pipe.text_to_video("p", height=32, width=32, num_frames=9,
                             num_inference_steps=4, guidance_scale=3.0,
                             guidance_scale_2=2.0)
    for h in hooks:
        h.remove()
    assert flash_attention.launches - before == 2 * dcfg.num_layers * 4
    assert t2v.videos.shape == (1, 3, 9, 32, 32)
    assert 0.0 <= t2v.videos.min() and t2v.videos.max() <= 1.0


@pytest.mark.cuda
def test_wan22_streaming_vae_matches_whole_in_bf16(cuda):
    """The Wan2.2 VAE on the card in bf16: the streamed encode and decode
    within bf16 rounding of the whole-sequence ones."""
    from videocof_torch.configs import WAN22_VAE_TINY
    from videocof_torch.models import wan_vae22_streaming as stream
    from videocof_torch.models.wan_vae22 import init_wan22_vae
    g = torch.Generator(device=cuda).manual_seed(6)
    vae = init_wan22_vae(WAN22_VAE_TINY, g, torch.bfloat16)
    x = (torch.rand(1, 3, 13, 64, 64, generator=g, device=cuda) * 2 - 1
         ).to(torch.bfloat16)
    rel = lambda a, b: ((a.float() - b.float()).norm()  # noqa: E731
                        / b.float().norm()).item()
    with torch.no_grad():
        mu, _ = vae.encode(x)
        for chunk in (1, 2, 4):
            assert rel(stream.encode_streaming(vae, x, chunk)[0], mu) <= 2e-2
        z = torch.randn(1, WAN22_VAE_TINY.z_dim, 5, 4, 4, generator=g,
                        device=cuda)
        whole = vae.decode(z.to(torch.bfloat16))
        for chunk in (1, 2):
            assert rel(stream.decode_streaming(
                vae, z.to(torch.bfloat16), chunk), whole) <= 2e-2
            u8 = stream.decode_streaming_u8(vae, z, chunk,
                                            compute_dtype=torch.bfloat16)
            want = torch.round(whole.float() * 127.5 + 127.5)
            assert u8.dtype == torch.uint8 and u8.shape == want.shape
            assert (u8.float() - want).abs().mean().item() <= 2.0
