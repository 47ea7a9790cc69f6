"""The port on a CUDA device: the hand-written flash-attention kernels (the
forward B1, the forward with LSE B2, the backward B3) and the int8
attention kernel B4 against their plain versions, their shape checks, the
pipeline's and the trainer's default device, fp8 weights, runtime LoRA,
the Wan2.2 pipeline and the Wan2.2 VAE on the card, umT5 offload and
the serving controller's weight swap, Ulysses and ring attention on
ranks' shards, and the DiT block's fused elementwise passes against their
plain steps.

These tests need an NVIDIA GPU and nvcc, and skip without them. The module
imports neither JAX nor the JAX package, so that on a GPU machine without
JAX it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from videocof_torch.configs import T5_TINY, VAE_TINY, WAN_TINY
from videocof_torch.models.t5_encoder import init_t5_encoder
from videocof_torch.models.wan_dit import init_wan_dit
from videocof_torch.models.wan_vae import init_wan_vae
from videocof_torch.ops import attention
from videocof_torch.ops import dit_fused as df
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


# the other Wan variants' shapes at the 14B's 40 heads: i2v's image
# cross-attention (257 keys, one valid key in the third 128-key tile) under
# batched CFG at 14,040 tokens, and S2V's audio injection (4 keys, far
# below one tile, at batch 2 x 9 latent frames of 1,560 tokens)
@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk", [(2, 14040, 257), (18, 1560, 4)])
def test_kernel_matches_plain_at_the_variants_shapes(cuda, B, Lq, Lk):
    q, k, v = _qkv(cuda, B, Lq, Lk, 40, 128)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    _close(got, flash_attention_reference(q, k, v))


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
    """No floating-point atomics: two launches of each B4 kernel give the
    same bits (the pre-pass on chunked slabs here, 777 keys; its one-CTA
    slabs in `test_int8_prepass_matches_plain`)."""
    q, k, v = _qkv(cuda, 2, 1000, 777, 2, D)
    (ki, sk, mean), (ki2, sk2, mean2) = i8.int8_quantize_k(
        k), i8.int8_quantize_k(k)
    a = i8.int8_attention_fwd(q, ki, sk, v)
    b = i8.int8_attention_fwd(q, ki, sk, v)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki2) and torch.equal(sk, sk2)
    assert torch.equal(mean, mean2)
    assert torch.equal(a, b)


# the pre-pass's key lengths: on and beside its stages (128 rows at D =
# 128, 64 at D = 256), around 384, 512 and 780, a long ragged one, the
# standard edit's 29,640, and one whose slab outgrows the resident CTAs'
# stages (a chunk a CTA, the rows past its stage read twice)
PREPASS_LENGTHS = [1, 64, 65, 128, 129, 384, 385, 511, 512, 768, 769, 780,
                   781, 3001, 29640, 110000]


@pytest.mark.cuda
@pytest.mark.parametrize("Lk", PREPASS_LENGTHS)
@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16),
                                     (256, torch.float16)])
def test_int8_prepass_matches_plain(cuda, Lk, D, dtype):
    """The pre-pass's mean against `k_mean` (the sums differ only in their
    order: within 256 fp32 ulps of the column's mean |k|), its int8 values
    at most one level off `quantize_k_reference` on `k_mean` in at most
    1e-4 of them, its row scales within 1e-6, and the same bits twice."""
    B, N = (1, 1) if Lk > 30000 else (2, 3)
    k = _qkv(cuda, B, 1, Lk, N, D, dtype)[1]
    before = i8.launch_counts()["int8_quantize_k"]
    ki, sk, mean = i8.int8_quantize_k(k)
    ki2, sk2, mean2 = i8.int8_quantize_k(k)
    torch.cuda.synchronize()
    assert i8.launch_counts()["int8_quantize_k"] == before + 2
    assert torch.equal(ki, ki2) and torch.equal(sk, sk2)
    assert torch.equal(mean, mean2)
    want_mean = i8.k_mean(k)
    scale = k.float().abs().mean(dim=1)
    assert ((mean - want_mean).abs() <= 256 * 2.0 ** -24 * scale).all()
    want_i, want_s = i8.quantize_k_reference(k, want_mean)
    torch.testing.assert_close(sk, want_s, rtol=1e-6, atol=0)
    levels = (ki.int() - want_i.int()).abs()
    assert levels.max().item() <= 1
    assert (levels > 0).float().mean().item() <= 1e-4


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
    ki, sk, mean = i8.int8_quantize_k(k)
    torch.testing.assert_close(mean, i8.k_mean(k), rtol=1e-5, atol=1e-6)
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


@pytest.mark.cuda
def test_offloaded_umt5_stays_on_the_host(cuda):
    """`offload_t5`: umT5's weights stay pinned in host memory through a
    prompt encoding on the card, whose embeddings equal the resident
    encoder's, and the device copies die with the call."""
    dcfg = WAN_TINY.replace(in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(5)
    dit, vae = init_wan_dit(dcfg, g), init_wan_vae(VAE_TINY, g)
    t5 = init_t5_encoder(T5_TINY, g)
    resident = WanPipeline(dit, vae, t5, dtype=torch.float32)
    prompts = ["remove the ball", "a red kite over a quiet lake"]
    want = resident.encode_prompt(prompts, max_length=64)
    off = WanPipeline(dit, vae, copy.deepcopy(t5), dtype=torch.float32,
                      offload_t5=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = off.encode_prompt(prompts, max_length=64)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and torch.equal(got, want)
    assert all(p.device.type == "cpu" and p.is_pinned()
               for p in off.t5.parameters())
    assert torch.cuda.memory_allocated() - before == (
        got.numel() * got.element_size())


@pytest.mark.cuda
def test_weight_swap_keeps_device_memory_flat(cuda, tmp_path):
    """The controller's weight swap copies a checkpoint into the resident
    DiT in place: the weights equal the file's, and the allocated device
    memory is the same before and after."""
    from videocof_torch.serving import VideoCoFController
    from videocof_torch.utils.checkpoint import save_dit_checkpoint_dir
    dcfg = WAN_TINY.replace(in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(6)
    pipe = WanPipeline(init_wan_dit(dcfg, g, torch.bfloat16),
                       init_wan_vae(VAE_TINY, g, torch.bfloat16),
                       init_t5_encoder(T5_TINY, g, torch.bfloat16))
    other = init_wan_dit(dcfg, g, torch.bfloat16)
    save_dit_checkpoint_dir(str(tmp_path / "dit"), other, dcfg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    VideoCoFController(pipe).update_diffusion_transformer(
        str(tmp_path / "dit"))
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    for k, v in other.state_dict().items():
        assert torch.equal(pipe.dit.state_dict()[k], v), k


def _tiny_trainer(cuda, ckpt=None, save_every=0, seed=0):
    dcfg = WAN_TINY.replace(dim=128, ffn_dim=256, num_heads=2,
                            in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf16 = torch.bfloat16
    tcfg = TrainerConfig(height=16, width=16, source_frames=5,
                         target_frames=5, reasoning_frames=4, lora_rank=4,
                         learning_rate=1e-3, checkpoint_dir=ckpt,
                         save_every=save_every)
    return CoFTrainer(init_wan_dit(dcfg, g, bf16),
                      init_wan_vae(VAE_TINY, g, bf16),
                      init_t5_encoder(T5_TINY, g, bf16), None, tcfg)


def _triplet(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (3, T, 16, 16)).astype(np.float32)
            for k, T in (("pixel_src", 5), ("pixel_ground", 4),
                         ("pixel_tgt", 5))} | {"text": "remove it"}


@pytest.mark.cuda
def test_restored_trainer_resumes_on_the_card(cuda, tmp_path):
    """A LoRA state saved at step 2 on the card and restored into a fresh
    trainer equals the state in memory bit for bit (adapters, both AdamW
    moments, step); one more step on the same sample with the same seeded
    generator gives the same loss bit for bit and the same state within
    1e-3 relative L2 (B3 adds dq's key tiles in no fixed order)."""
    from videocof_torch.utils.checkpoint import restore_train_state
    trainer = _tiny_trainer(cuda, str(tmp_path), save_every=2)
    trainer.train(iter([_triplet(0), _triplet(1)]), total_steps=2)
    fresh = _tiny_trainer(cuda)
    restore_train_state(str(tmp_path), fresh.state)

    def tensors(state):
        out = dict(state.adapters.state_dict())
        for i, st in state.optimizer.adamw.state_dict()["state"].items():
            out.update({f"{i}.{k}": v for k, v in st.items()})
        return out

    want = tensors(trainer.state)
    got = tensors(fresh.state)
    assert set(got) == set(want) and fresh.state.step == 2
    assert all(torch.equal(v, want[k]) for k, v in got.items())
    fa.reset_launch_counts()
    for t in (trainer, fresh):
        t.generator.manual_seed(7)
        t.train(iter([_triplet(2)]), total_steps=1)
    assert fa.launch_counts()["flash_attention_bwd"] == 2 * 2 * 2
    assert fresh.losses[-1] == trainer.losses[-1]
    want = tensors(trainer.state)
    for k, v in tensors(fresh.state).items():
        if k.endswith("step"):
            assert torch.equal(v, want[k]), k
        else:
            assert ((v - want[k]).float().norm()
                    <= 1e-3 * want[k].float().norm()), k


@pytest.mark.cuda
@pytest.mark.parametrize("policy,fwd_per_attention", [
    (False, 1), (True, 2), ("everything_saveable", 1),
    ("dots_with_no_batch_dims_saveable", 2),
    ("save_names:attn_out,xattn_out", 2)])
def test_remat_policy_launches(cuda, policy, fwd_per_attention):
    """One LoRA step per policy: B2 once per attention, and again in the
    backward's recompute under a checkpointing policy; B3 once; the loss
    equals full remat's bit for bit."""
    from videocof_torch.training import make_lora_train_step
    trainer = _tiny_trainer(cuda)
    dit = trainer.dit
    dit.cfg = dit.cfg.replace(
        remat_tag_names=str(policy).startswith("save_names"))
    batch = trainer.prepare_batch([_triplet(3)])
    batch["timesteps"] = torch.tensor([600], device=cuda)
    noise = torch.randn(batch["x0"].shape, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    losses = {}
    for pol in (True, policy):
        init_fn, step_fn = make_lora_train_step(dit, rank=4, remat=pol)
        fa.reset_launch_counts()
        _, losses[pol] = step_fn(
            init_fn(torch.Generator(device=cuda).manual_seed(2)), batch,
            noise=noise)
    n = 2 * dit.cfg.num_layers
    assert fa.launch_counts() == {
        "flash_attention_fwd": 0,
        "flash_attention_fwd_lse": fwd_per_attention * n,
        "flash_attention_bwd": n}
    assert torch.equal(losses[policy], losses[True])


def _sp_card_rank(rank, world, init_file, backend, mode, out):
    """One rank of `test_parallel_attention_on_shards_matches_whole`: its
    shard of Ulysses or ring attention against B1 over the whole sequence,
    with the launches of the parallel call."""
    import os
    import torch.distributed as dist
    from videocof_torch.parallel import (SPContext, make_mesh,
                                         make_ring_attention,
                                         make_ulysses_attention, rank_device)
    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device()
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    mesh = make_mesh(seq=world)
    sp = SPContext(mesh)
    g = torch.Generator(device=dev).manual_seed(0)
    B, L, N, D = 2, 2048, 4, 128
    q, k, v = (torch.randn(B, L, N, D, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    mask[0, L // 2:] = False      # at 2 ranks: rank 1's K/V shard all masked
    mask[1, 1000:] = False
    whole = fa.flash_attention(q, k, v, kv_mask=mask)
    maker = {"ulysses": make_ulysses_attention,
             "ring": make_ring_attention}[mode]
    attn = maker(mesh)
    fa.reset_launch_counts()
    with torch.no_grad():
        got = attn(*(sp.shard_tokens(t) for t in (q, k, v)), mask=mask)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    want = sp.shard_tokens(whole)
    torch.save({"counts": counts, "finite": bool(torch.isfinite(got).all()),
                "got": got.float().cpu(), "want": want.float().cpu()},
               f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_parallel_attention_on_shards_matches_whole(cuda, tmp_path, mode):
    """Ulysses at two ranks on the card (gloo; NCCL refuses two ranks on one
    device): B1 on each rank's [2, 2048, 2 of 4 heads, 128] with the key
    mask; ring: B2 on each rotated K/V shard, one wholly masked. Ring
    rotates with point-to-point, which gloo does not carry on CUDA tensors:
    at two ranks on two cards under NCCL where the machine has them, else
    at one rank (one shard) under NCCL. Each rank's output against B1 over
    the whole sequence (bf16 tolerance)."""
    import torch.multiprocessing as mp
    cards = torch.cuda.device_count()
    if mode == "ulysses":
        world, backend = 2, "gloo"
    else:
        world, backend = (2, "nccl") if cards >= 2 else (1, "nccl")
    fa.build()              # once, before the ranks load it
    mp.start_processes(_sp_card_rank, args=(world, str(tmp_path / "rdzv"),
                                            backend, mode, str(tmp_path)),
                       nprocs=world, join=True, start_method="spawn")
    for r in range(world):
        res = torch.load(tmp_path / f"rank{r}.pt")
        assert res["finite"]
        want = ({"flash_attention_fwd": 1} if mode == "ulysses"
                else {"flash_attention_fwd_lse": world})
        assert {k: res["counts"][k] for k in want} == want, res["counts"]
        torch.testing.assert_close(res["got"], res["want"], **BF16_TOL)


# B1 at the other families' shapes: CogVideoX-5B's joint self-attention
# (batched CFG, 226 + 13 x 30 x 45 tokens, 48 heads of 64: 138 whole
# 128-key tiles and 112 keys), Flux-dev's 512 + 64 x 64 tokens and
# QwenImage's 256 + 64 x 64 (24 heads of 128), unmasked and with
# QwenImage's joint key mask (a text mask folded in)
@pytest.mark.cuda
@pytest.mark.parametrize("B,L,N,D,masked", [(2, 17776, 48, 64, False),
                                            (1, 4608, 24, 128, False),
                                            (1, 4352, 24, 128, False),
                                            (2, 4352, 24, 128, True)])
def test_kernel_matches_plain_at_the_families_shapes(cuda, B, L, N, D,
                                                     masked):
    q, k, v = _qkv(cuda, B, L, L, N, D)
    mask = None
    if masked:     # row 0's text padded past its 200th of 256 tokens
        mask = torch.ones(B, L, dtype=torch.bool, device=cuda)
        mask[0, 200:256] = False
    before = flash_attention.launches
    got = flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(got, flash_attention_reference(q, k, v, kv_mask=mask))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["cogvideox", "flux", "qwenimage"])
def test_family_forward_through_the_kernel_matches_naive(cuda, family):
    """One tiny-depth forward of each family at head dim 64 (CogVideoX) or
    128 in bf16 on the card: through B1 (its launches counted) against the
    naive backend, relative L2 within 2e-2 (the DiT gate)."""
    from videocof_torch.models import cogvideox, flux, qwenimage
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = torch.bfloat16
    if family == "cogvideox":
        cfg = cogvideox.COGVIDEOX_5B.replace(num_layers=2,
                                             num_attention_heads=4)
        m = cogvideox.init_cogvideox(cfg, g, bf16)
        args = (torch.randn(2, 3, 16, 16, 24, generator=g, device=cuda),
                torch.randn(2, 20, 4096, generator=g, device=cuda),
                torch.full((2,), 500.0, device=cuda))
        launches = 2
    elif family == "flux":
        cfg = flux.FLUX_DEV.replace(num_layers=1, num_single_layers=1,
                                    num_attention_heads=2)
        m = flux.init_flux(cfg, g, bf16)
        img_ids = torch.stack([torch.zeros(64), torch.arange(64) // 8,
                               torch.arange(64) % 8], -1).to(cuda)
        args = (torch.randn(1, 64, 64, generator=g, device=cuda),
                torch.randn(1, 20, 4096, generator=g, device=cuda),
                torch.randn(1, 768, generator=g, device=cuda),
                torch.full((1,), 0.7, device=cuda), img_ids,
                torch.zeros(20, 3, device=cuda))
        launches = 2
    else:
        cfg = qwenimage.QWENIMAGE.replace(num_layers=2,
                                          num_attention_heads=2)
        m = qwenimage.init_qwenimage(cfg, g, bf16)
        ii, ti = (a.to(cuda) for a in qwenimage.qwen_position_ids(
            (1, 8, 8), 20))
        args = (torch.randn(1, 64, 64, generator=g, device=cuda),
                torch.randn(1, 20, 3584, generator=g, device=cuda),
                torch.full((1,), 0.7, device=cuda), ii, ti)
        launches = 2
    with torch.no_grad():
        before = flash_attention.launches
        got = m(*args)
        ran = flash_attention.launches - before
        want = m(*args, attn_backend="naive")
    assert ran == launches and torch.isfinite(got).all()
    rel = ((got - want).float().norm() / want.float().norm()).item()
    assert rel <= 2e-2, rel


def _tp_card_rank(rank, world, init_file, out):
    """One rank of `test_tp_forward_under_nccl_matches_whole`: the DiT's
    forward tensor-parallel over the world (its heads and FFN shard, B1 on
    its heads), one card a rank."""
    import os
    import torch.distributed as dist
    from videocof_torch.configs import WanDiTConfig
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.parallel import (apply_tp, make_mesh,
                                         make_tp_attention, rank_device)
    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    cfg = WanDiTConfig(dim=512, ffn_dim=1024, num_heads=4, num_layers=2,
                       text_dim=64, text_len=32, freq_dim=64)
    dit = init_wan_dit(cfg, torch.Generator(device=dev).manual_seed(0),
                       torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, cfg.in_dim, 5, 16, 16, generator=g, device=dev)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev)
    t = torch.tensor([500.0], device=dev)
    rope = [torch.as_tensor(a, device=dev)
            for a in make_rope_for_geometry(cfg, (5, 8, 8))]
    with torch.no_grad():
        whole = dit(x, t, ctx, *rope)
        mesh = make_mesh(model=world)
        apply_tp(dit, mesh)
        fa.reset_launch_counts()
        got = dit(x, t, ctx, *rope, attn_backend=make_tp_attention(mesh))
    torch.cuda.synchronize()
    torch.save({"counts": fa.launch_counts(),
                "q": tuple(dit.blocks[0].self_attn.q.weight.shape),
                "got": got.float().cpu(), "want": whole.float().cpu()},
               f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.mark.cuda
def test_tp_forward_under_nccl_matches_whole(cuda, tmp_path):
    """Tensor parallelism at one card a rank under NCCL (two cards at
    least; NCCL refuses two ranks on one device): each rank's DiT forward
    over its half of the heads and FFN (B1 at 2 of 4 heads of 128, the
    row-parallel sums all-reduced) against the whole forward."""
    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices (one a rank under NCCL)")
    world = 2
    fa.build()              # once, before the ranks load it
    mp.start_processes(_tp_card_rank, args=(world, str(tmp_path / "rdzv"),
                                            str(tmp_path)),
                       nprocs=world, join=True, start_method="spawn")
    for r in range(world):
        res = torch.load(tmp_path / f"rank{r}.pt")
        assert res["q"] == (256, 512)
        assert res["counts"]["flash_attention_fwd"] == 4
        _close(res["got"], res["want"], rel_tol=2e-2)


# ------------------------------------------- the DiT's fused elementwise passes
# The passes against the block's plain steps on the same card. Their
# residual adds round each product and sum as the plain path's tensors do,
# so the fp32 stream is the plain one bit for bit. Their row reductions
# (LayerNorm's mean and variance, RMSNorm's mean square) add in another order
# than PyTorch's kernels and take rsqrtf, which moves fp32 values by a few
# ulps and so flips a bf16 rounding in a small share of elements: each bf16
# output lies within one bf16 ulp of the larger of the two magnitudes (plus
# 1e-5 for values that cancel to about 0), and at most 0.1% of the elements
# differ at all. After RoPE the bound is three ulps of the pair's norm: a
# flipped input moves both values of its rotated pair, each rounded again.
DIT_SHARE = 1e-3
DIT_ATOL = 1e-5
DIT_WIDTHS = [(5120, 40), (1536, 12)]      # the 14B's and the 1.3B's
DIT_LENGTHS = [(1, 29_640), (2, 77)]       # the edit's tokens; a short batch


def _bf16_ulp(t):
    return torch.exp2(torch.floor(torch.log2(t.clamp_min(2.0 ** -126))) - 7)


def _bf16_near(got, want, mag=None, ulps=1):
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    g, w = got.float(), want.float()
    if mag is None:
        mag = torch.maximum(g.abs(), w.abs())
    diff = (g - w).abs()
    worst = (diff - ulps * _bf16_ulp(mag) - DIT_ATOL).max().item()
    assert worst <= 0, f"{worst} beyond {ulps} bf16 ulps"
    share = (diff > 0).float().mean().item()
    assert share <= DIT_SHARE, f"{share:.2e} of the elements differ"


def _pair_norm(t, B, L, D):
    p = t.float().view(B, L, D // 2, 2)
    return p.norm(dim=-1, keepdim=True).expand_as(p).reshape(B, L, D)


def _dit_inputs(dev, B, L, D, hd, seed, per_sample=False):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    e = randn(B, 6, D, scale=0.1)
    ang = randn(*((B,) if per_sample else ()), L, hd // 2, scale=3.0)
    bf16 = torch.bfloat16
    return dict(x=randn(B, L, D, scale=2.0), y=randn(B, L, D, dtype=bf16),
                e_=[e[:, i][:, None, :] for i in range(6)],
                q=randn(B, L, D, dtype=bf16), k=randn(B, L, D, dtype=bf16),
                w=1.0 + randn(D, dtype=bf16, scale=0.1),
                b=randn(D, dtype=bf16, scale=0.1),
                cos=torch.cos(ang), sin=torch.sin(ang))


def _plain(fn, *args):
    """A pass's plain version computed on the card (the wrapper takes it
    only for CPU tensors): the same helpers, on CUDA tensors."""
    return getattr(df, f"{fn}_reference")(*args)


def _stream_checks(t, eps=1e-6):
    x, y, e_, w, b = t["x"], t["y"], t["e_"], t["w"], t["b"]
    before = df.launch_counts()
    tx = df.ln_modulate(x, e_[0], e_[1], eps)
    _bf16_near(tx, _plain("ln_modulate", x, e_[0], e_[1], eps))
    x1, nx = df.gate_residual_ln(x, y, e_[2], eps, w, b)
    want_x, want_nx = _plain("gate_residual_ln", x, y, e_[2], eps, w, b)
    assert torch.equal(x1, want_x)
    _bf16_near(nx, want_nx)
    x1n, nxn = df.gate_residual_ln(x, y, e_[2], eps)       # no norm3
    assert torch.equal(x1n, want_x) and torch.equal(nxn, want_x.bfloat16())
    x2, tx2 = df.residual_ln_modulate(x1, y, e_[3], e_[4], eps)
    want_x, want_tx = _plain("residual_ln_modulate", x1, y, e_[3], e_[4],
                                 eps)
    assert torch.equal(x2, want_x)
    _bf16_near(tx2, want_tx)
    x3 = df.gate_residual(x2, y, e_[5])
    assert torch.equal(x3, _plain("gate_residual", x2, y, e_[5]))
    after = df.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "ln_modulate": 1, "qk_norm_rope": 0, "qk_norm_rope_q": 0,
        "gate_residual_ln": 2, "residual_ln_modulate": 1, "gate_residual": 1}


def _qk_checks(t, B, L, D, eps=1e-6):
    q, k, w = t["q"], t["k"], t["w"]
    got_q, got_k = df.qk_norm_rope(q, k, w, -w, eps, t["cos"], t["sin"])
    torch.cuda.synchronize()
    want_q, want_k = _plain("qk_norm_rope", q, k, w, -w, eps, t["cos"],
                                t["sin"])
    for got, want in ((got_q, want_q), (got_k, want_k)):
        _bf16_near(got, want, mag=_pair_norm(want, B, L, D), ulps=3)
    # RoPE off, q alone: the cross-attention's q
    got_q, none = df.qk_norm_rope(q, None, w, None, eps)
    assert none is None
    _bf16_near(got_q, _plain("qk_norm_rope", q, None, w, None, eps)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("D,N", DIT_WIDTHS)
@pytest.mark.parametrize("B,L", DIT_LENGTHS)
def test_dit_stream_passes_match_plain(cuda, D, N, B, L):
    """ln_modulate, gate_residual_ln (with and without norm3),
    residual_ln_modulate and gate_residual at the 14B's and the 1.3B's
    widths, over the edit's 29,640 tokens and a short batch of 2."""
    _stream_checks(_dit_inputs(cuda, B, L, D, D // N, seed=D + L))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("D,N", DIT_WIDTHS)
@pytest.mark.parametrize("B,L", DIT_LENGTHS)
def test_dit_qk_pass_matches_plain(cuda, D, N, B, L):
    """q and k RMSNorm with RoPE in one launch, and q alone without it;
    the short batch takes per-sample tables [B, L, hd/2]."""
    t = _dit_inputs(cuda, B, L, D, D // N, seed=2 * D + L,
                    per_sample=B > 1)
    _qk_checks(t, B, L, D)


@pytest.mark.cuda
def test_dit_passes_read_strided_inputs(cuda):
    """A stream that is a view of every other row block (a sequence
    shard's chunk), per-sample tables that are views, and one modulation
    row broadcast over the batch."""
    B, L, D, hd = 2, 96, 1536, 128
    t = _dit_inputs(cuda, B, 2 * L, D, hd, seed=5, per_sample=True)
    for key in ("x", "y", "q", "k", "cos", "sin"):
        t[key] = t[key][:, L:]
    t["e_"] = [e[:1] for e in t["e_"]]
    assert not t["x"].is_contiguous() and not t["cos"].is_contiguous()
    _stream_checks(t)
    _qk_checks(t, B, L, D)


@pytest.mark.cuda
def test_dit_passes_refuse_what_they_do_not_take(cuda):
    t = _dit_inputs(cuda, 1, 8, 256, 128, seed=6)
    x, y, e_, q, w = t["x"], t["y"], t["e_"], t["q"], t["w"]
    with pytest.raises(NotImplementedError):
        df.ln_modulate(x.bfloat16(), e_[0], e_[1], 1e-6)      # not fp32
    with pytest.raises(NotImplementedError):
        df.qk_norm_rope(q.half(), None, w, None, 1e-6)        # not bf16
    with pytest.raises(NotImplementedError):                  # D % 4
        df.gate_residual(x[..., :254].contiguous(), y[..., :254].contiguous(),
                         e_[5][..., :254].contiguous())
    shifted = x.reshape(-1)[1:1 + x.numel() - 256].view(1, 7, 256)
    with pytest.raises(NotImplementedError):                  # 4-byte aligned
        df.ln_modulate(shifted, e_[0], e_[1], 1e-6)
    with pytest.raises(ValueError):
        df.gate_residual(x, y[:, :4], e_[5])
    with pytest.raises(NotImplementedError):
        df.qk_norm_rope(q, None, w, None, 1e-6, t["cos"].double(),
                        t["sin"].double())
    with pytest.raises(ValueError):
        df.qk_norm_rope(q, None, w, None, 1e-6, t["cos"][:4], t["sin"][:4])


@pytest.mark.cuda
@pytest.mark.parametrize("D,N,B,L", [(1536, 12, 1, 29_640),
                                     (5120, 40, 2, 1_560)])
def test_wan_block_fused_matches_plain(cuda, D, N, B, L):
    """One WanBlock with bf16 weights on the same inputs: under no_grad its
    call takes the five passes, under autograd (its parameters require
    grad) the plain steps. The two updates of the stream agree within one
    bf16 rounding (2^-8 relative L2): only the passes' reductions differ,
    and they flip a bf16 rounding of a small share of the branch inputs."""
    from videocof_torch.configs import WAN21_T2V_1_3B
    cfg = WAN21_T2V_1_3B.replace(dim=D, num_heads=N, num_layers=1,
                                 ffn_dim=4 * D)
    g = torch.Generator(device=cuda).manual_seed(7)
    blk = init_wan_dit(cfg, g, torch.bfloat16).blocks[0]
    x = 2.0 * torch.randn(B, L, D, generator=g, device=cuda)
    e0 = 0.1 * torch.randn(B, 6, D, generator=g, device=cuda)
    ctx = torch.randn(B, 512, D, generator=g, device=cuda).bfloat16()
    ang = 3.0 * torch.randn(B, L, D // N // 2, generator=g, device=cuda)
    rope = (torch.cos(ang), torch.sin(ang))
    df.reset_counts()
    with torch.no_grad():
        fused = blk(x, e0, ctx, rope)
    with torch.enable_grad():
        plain = blk(x, e0, ctx, rope).detach()
    torch.cuda.synchronize()
    assert df.block_counts() == {"fused": 1, "plain": 1}
    assert df.launch_counts() == {
        "ln_modulate": 1, "qk_norm_rope": 1, "qk_norm_rope_q": 1,
        "gate_residual_ln": 1, "residual_ln_modulate": 1, "gate_residual": 1}
    du, dp = fused - x, plain - x
    rel = ((du - dp).norm() / dp.norm()).item()
    assert rel <= 2.0 ** -8, rel


@pytest.mark.cuda
def test_tiny_edit_fuses_every_block_call(cuda):
    """Every block call of an edit on the card takes the fused passes, and
    each pass launches once a call (the q/k pass twice: self-attention's q
    and k, counted as "qk_norm_rope", then the cross-attention's q alone,
    "qk_norm_rope_q")."""
    dcfg = WAN_TINY.replace(dim=256, ffn_dim=512, num_heads=2,
                            in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = torch.bfloat16
    pipe = WanPipeline(init_wan_dit(dcfg, g, bf16),
                       init_wan_vae(VAE_TINY, g, bf16),
                       init_t5_encoder(T5_TINY, g, bf16), dtype=bf16)
    video = np.random.default_rng(0).integers(0, 256, (1, 3, 9, 32, 32),
                                              dtype=np.uint8)
    df.reset_counts()
    out = pipe(video, "remove the ball", source_frames=9, reasoning_frames=4,
               num_inference_steps=2, output_latents=True)
    calls = dcfg.num_layers * 2
    assert df.block_counts() == {"fused": calls, "plain": 0}
    assert df.launch_counts() == {
        "ln_modulate": calls, "qk_norm_rope": calls, "qk_norm_rope_q": calls,
        "gate_residual_ln": calls, "residual_ln_modulate": calls,
        "gate_residual": calls}
    assert np.isfinite(out.latents).all()
