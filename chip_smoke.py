#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`videocof_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run (non-zero exit) on any fault:
  1. device: the card's name and power limit; TF32 off; build the CUDA
     kernels from `videocof_torch/csrc/` with nvcc (sm_90a), one process per
     source, all at once; ptxas registers, spills and warnings of every
     kernel; the count of wgmma (HGMMA) and TMA load (UTMALDG) instructions
     in each instantiation of the forward `flash_fwd_kernel` and of the
     backward `flash_bwd_kernel`, and of int8 wgmma (IGMMA), HGMMA and
     UTMALDG in each of B4's `int8_attn_kernel` (cuobjdump -sass), which
     fails the run if any is 0.
  2. kernels vs plain, on the card, at the main paths' shapes and at the
     edge cases (ragged length, key mask with a fully masked batch row,
     D = 64 (flash) or 256 (int8), fp16, and for B1, B2 and B4 the lengths
     on and beside their 128-row q tiles and K/V tiles, Lq in {1, 127, 129}
     by Lk in {1, 127, 129, 512}): the forward B1 and the forward with
     LSE B2 on the output
     (max abs error <= 3e-2 and relative L2 error <= 1e-2: at the main
     path's lengths the outputs are small, so the absolute bound alone would
     pass a wrong kernel) and on the LSE (relative error <= 1e-4: both sides
     sum the same fp32 probabilities); the backward kernel B3 (dq, dk, dv)
     against the plain backward in its own arithmetic (P and dS rounded to
     the input type for the tensor cores, ``rounded=True``: relative L2 <=
     1e-3) and against the fp32 plain backward, JAX's arithmetic (at most
     1.5x the rounding's own size on the same inputs, about 2.6e-3 in bf16
     and 3.2e-4 in fp16), also at 32 lengths on and beside its 64-row q
     tiles and 128-key tiles (Lq 1/63/65/129 x Lk 1/127/129/512); the int8
     kernel B4 in its two kernels, K's quantization pre-pass (at most one
     int8 level off its plain version, in at most 1e-4 of the values) and
     the attention on the same quantized K (B1's gates), and the whole of
     B4 against its plain version (B1's gates) and against unquantized
     attention (cosine similarity > 0.999, JAX's test). Then a 2-block
     full-width DiT on a small latent through the kernels against the naive
     attention backend: the forward, and the gradient of its LoRA adapters
     (relative L2 error <= 2e-2 each), and the forward through B4 (<= 1e-2;
     1.8e-3 measured on the CPU with B4's plain version); B4 under autograd
     raises.
  3. kernel timing at the two main-path shapes (12 heads; batch 2 for B4,
     as batched CFG runs it): each kernel, its plain version, the least time
     the card could take (bound), and one PyTorch call that computes the
     same function (SDPA's forward, with and without a gradient to carry,
     and SDPA's whole backward for B3: yardsticks the port never calls; for
     B4 SDPA's
     unquantized bf16 forward, not the same function); CUDA events, median
     of the runs after a warm-up; the achieved TFLOP/s of each flash
     kernel and B4's achieved TOP/s (int8 and bf16 operations together),
     and B4 beside B1 at B4's batch-2 shapes (whether int8 QK^T pays).
  4. the edit: `WanPipeline` at full width (Wan2.1 1.3B DiT, Wan2.1 VAE,
     umT5-XXL, random bf16 weights from a seed) edits a 33-frame 480x832
     uint8 video with 4 reasoning frames in 4 Flow-UniPC steps; checks the
     output and that B1 ran exactly 2 x layers x steps times and no other
     kernel ran; then one DiT step of the edit's geometry under
     torch.profiler (device time by kernel, idle share).
  5. the standard edit: the same models and video through
     `WanPipeline(attn_backend="int8")` in 50 Flow-UniPC steps at shift 3,
     guidance 5 against the default negative prompt, TeaCache with Wan2.1
     T2V 1.3B's coefficients on a plan pinned at a 40% skip rate (18 of 50
     steps; random weights would skip most steps, and the plan they give
     is printed); checks the output and that B4 ran exactly 2 x layers x
     computed steps times and no other kernel ran; then one batched-CFG
     DiT step (batch 2) under torch.profiler.
  6. training: `CoFTrainer` on the same models with rank-16 LoRA adapters and
     the default `TrainerConfig` (480x832, 33 source + 4 reasoning + 33
     target frames, block remat) takes 3 steps on synthetic triplets, the
     first a warm-up; checks finite losses, adapters that moved in step 1,
     base weights bitwise unchanged, and the launches the design implies
     (per step: B2 in every attention's forward and again in its remat
     recompute, B3 once per attention, no B1); then one step under
     torch.profiler.
  7. a `kernels` JSON line and, last, the device JSON line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the port's kernel functions, as their names appear in ptxas and the profiler
OUR_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel", "int8_attn_kernel",
               "quant_k_kernel")
TOL = 3e-2                     # bf16 tolerance of a kernel vs its plain version
REL_TOL = 1e-2                 # ... and of ||kernel - plain|| / ||plain||
B3_ROUNDED_TOL = 1e-3          # B3 vs the plain backward in its arithmetic
# B3 vs the fp32 plain backward (JAX's arithmetic): at most 1.5x the size of
# the rounding of P and dS on the same inputs, the rounded plain backward's
# relative L2 against the fp32 one (about 2.6e-3 bf16, 3.2e-4 fp16 at the
# self and cross shapes, as the earlier B3a/B3b measured)
B3_FP32_FACTOR = 1.5
LSE_TOL = 1e-4                 # max |lse kernel - plain| / max(1, |lse plain|)
DIT_REL_TOL = 2e-2             # DiT through the kernels vs the naive backend
DIT_INT8_REL_TOL = 1e-2        # ... through B4 (1.8e-3 measured on the CPU)
QUANT_FLIP_TOL = 1e-4          # share of int8 values one level off the plain
COS_TOL = 0.999                # B4 vs unquantized attention (JAX's test)
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (data sheet)
PEAK_INT8_OPS = 1979e12        # H100 SXM dense int8 (data sheet)
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
# SASS of the Hopper designs: bf16 wgmma and TMA loads, and B4's int8 wgmma
SASS_OPCODES = ("HGMMA", "UTMALDG")
SASS_OPCODES_INT8 = ("IGMMA", "HGMMA", "UTMALDG")
SEED = 0
TRAIN_STEPS = 3
STD_STEPS = 50                 # the standard edit (the reference's inference.py)
TEACACHE_PIN = 0.4             # pinned TeaCache skip rate (bench.py's)


def log(*args):
    print(*args, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, runs, warmup=2):
    """Median milliseconds of ``fn()`` over ``runs`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(flops, nbytes, int8_ops=0):
    """(ms, "operations" | "bytes"): the larger of the operations' time (bf16
    FLOP over the bf16 peak plus int8 OP over the int8 peak) and bytes over
    the memory rate."""
    ops_ms = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def kernel_work(B, Lq, Lk, N, D, eb=2):
    """(FLOP, bytes) of the flash kernels: FLOP of their products, and bytes
    of their inputs read once and outputs written once (q, k, v, o, dO, dq,
    dk, dv in bf16; lse and delta [B, N, Lq] fp32)."""
    mm = B * N * Lq * Lk * D
    q_b, kv_b, vec_b = eb * B * Lq * N * D, eb * B * Lk * N * D, 4 * B * N * Lq
    return {
        "flash_attention_fwd": (4 * mm, 2 * q_b + 2 * kv_b),
        "flash_attention_fwd_lse": (4 * mm, 2 * q_b + 2 * kv_b + vec_b),
        # S, dP, dV, dK, dQ; reads q, k, v, dO, lse, delta, writes dq, dk,
        # dv (the fp32 dQ accumulator's zeroing, reduce-adds and cast are
        # not counted: they are the kernel's way, not the function's work)
        "flash_attention_bwd": (10 * mm, 3 * q_b + 4 * kv_b + 2 * vec_b),
    }


def int8_bounds(B, Lq, Lk, N, D, eb=2):
    """Bounds of B4 and its two kernels: the int8 product qi ki^T at the
    int8 peak and the bf16 product PV at the bf16 peak; bytes of the inputs
    read once and outputs written once (q, k, v, o in bf16; the pre-pass
    writes int8 K and fp32 row scales that the attention kernel reads, and
    reads the fp32 K mean)."""
    mm = B * N * Lq * Lk * D
    q_b, kv_b = eb * B * Lq * N * D, eb * B * Lk * N * D
    ki_b, sk_b, mean_b = B * Lk * N * D, 4 * B * N * Lk, 4 * B * N * D
    return {
        "int8_flash_attention": bound(2 * mm, 2 * q_b + 2 * kv_b, 2 * mm),
        "int8_quantize_k": bound(0, kv_b + mean_b + ki_b + sk_b),
        "int8_attention_fwd": bound(2 * mm, 2 * q_b + kv_b + ki_b + sk_b,
                                    2 * mm),
    }


def pinned_teacache_plan(steps, rate, warmup=5):
    """A TeaCache plan at a fixed skip rate, spread evenly after the warm-up
    steps (bench.py's BENCH_TEACACHE_PIN plan): True = skipped."""
    plan, acc = [], 0.0
    for i in range(steps):
        acc += rate if i >= warmup else 0.0
        plan.append(acc >= 1.0)
        acc -= int(acc)
    return plan


def kernel_label(name):
    """A short label for a mangled kernel name: kernel<type, D[, lse]>."""
    kernel = next((k for k in OUR_KERNELS if k in name), name)
    dim = re.search(r"Li(\d+)E", name)
    return (f"{kernel}<{'bf16' if 'bfloat16' in name else 'fp16'}, "
            f"D={dim.group(1) if dim else '?'}"
            + (", lse" if "Lb1E" in name else "") + ">")


def ptxas_report(log_text):
    """[(kernel, registers, spill stores, spill loads)] from nvcc -Xptxas -v."""
    rows, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((kernel_label(name), int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def sass_counts(lib_path, kernel, opcodes):
    """({label: {opcode: count}} of ``opcodes`` over the functions named like
    ``kernel`` in ``cuobjdump -sass`` of a built library, {every *GMMA*
    opcode seen there: count})."""
    from videocof_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {lib_path}: {res.stderr.strip()}")
    counts, gmma, func = {}, {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = kernel_label(m.group(1)) if kernel in m.group(1) else None
            if func:
                counts[func] = dict.fromkeys(opcodes, 0)
        elif func:
            for op in opcodes:
                counts[func][op] += len(re.findall(rf"\b{op}\b", line))
            for op in re.findall(r"\b\w*GMMA[\w.]*", line):
                gmma[op] = gmma.get(op, 0) + 1
    return counts, gmma


def profile_kernels(fn):
    """Run ``fn()`` once under torch.profiler: (wall ms, device busy ms,
    [(device ms, launches, kernel name)] sorted by device time). Kernels are
    the trace's "kernel" events; busy is the union of their intervals and
    those of the device's copies and memsets."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans, by_name = [], {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
        if ev.get("cat") == "kernel":
            ms, n = by_name.get(ev["name"], (0.0, 0))
            by_name[ev["name"]] = (ms + ev["dur"] / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    return wall_ms, busy_us / 1e3, rows


def report_profile(label, wall_ms, busy_ms, kernels):
    """Print a profile: idle share, our kernels, cuBLAS, the rest, the top."""
    if busy_ms <= 0.0:
        log(f"[profile] {label}: wall {wall_ms:.1f} ms; device time by "
            "kernel not measured (torch.profiler saw no device events)")
        return
    ours = {}
    for ms, n, name in kernels:
        for key in OUR_KERNELS:
            if key in name:
                lse = "Lb1E" in name or re.search(r"fwd_kernel<[^>]*true>",
                                                  name)
                tag = key + ("<lse>" if lse else "")
                a, c = ours.get(tag, (0.0, 0))
                ours[tag] = (a + ms, c + n)
    conv_ms = sum(ms for ms, _, name in kernels if "implicit_gemm" in name)
    gemm_ms = sum(ms for ms, _, name in kernels
                  if "implicit_gemm" not in name and any(
                      s in name.lower() for s in ("gemm", "nvjet", "cutlass")))
    kernel_ms = sum(ms for ms, _, _ in kernels)
    ours_ms = sum(ms for ms, _ in ours.values())
    log(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle {1 - busy_ms / wall_ms:.1%}); kernel time "
        f"{kernel_ms:.1f} ms: attention kernels {ours_ms:.1f} ms ("
        + ", ".join(f"{k} {ms:.1f} ms x{n}" for k, (ms, n) in ours.items())
        + f"), cuBLAS GEMMs {gemm_ms:.1f} ms, cuDNN convolutions "
        f"{conv_ms:.1f} ms, everything else "
        f"{kernel_ms - ours_ms - gemm_ms - conv_ms:.1f} ms")
    for ms, count, name in kernels[:15]:
        log(f"[profile]   {ms:9.3f} ms  {count:5d} x  {name[:110]}")


def dit_step_flops(cfg, L, Lt):
    """FLOP of one DiT forward at L tokens and Lt text tokens: the matmuls
    and attention of the blocks, patch embed and head (the text MLP, norms
    and elementwise work are left out)."""
    d, f = cfg.dim, cfg.ffn_dim
    per_block = (2 * L * d * d * 4            # self q, k, v, o
                 + 2 * L * d * d * 2          # cross q, o
                 + 2 * Lt * d * d * 2         # cross k, v
                 + 2 * L * d * f * 2          # FFN
                 + 4 * L * L * d              # self attention
                 + 4 * L * Lt * d)            # cross attention
    pt, ph, pw = cfg.patch_size
    io = 2 * L * d * pt * ph * pw * (cfg.in_dim + cfg.out_dim)  # embed, head
    return cfg.num_layers * per_block + io


def compare(name, got, want, quiet=False, rel_tol=REL_TOL):
    """Gate ``got`` against ``want``: finite, max abs error <= TOL *
    max(1, max |want|) (a few bf16 ulps of the largest value: gradients can
    exceed 1) and relative L2 error <= rel_tol (None: not gated); returns
    (max abs err, relative L2 err). ``quiet`` logs only a failure."""
    import torch
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / want.float().norm()).item()
    top = want.float().abs().max().item()
    tol = TOL * max(1.0, top)
    ok = (bool(torch.isfinite(got).all()) and err <= tol
          and (rel_tol is None or rel <= rel_tol))
    if not (quiet and ok):
        log(f"[kernel vs plain] {name}: max abs err {err:.3e} (tol "
            f"{tol:.3g}), relative L2 err {rel:.3e} (tol {rel_tol}), max "
            f"|plain| {top:.3e}: {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel disagrees with its plain version: {name}")
    return err, rel


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from videocof_torch.configs import (GenerationConfig, T5Config,
                                        WAN21_T2V_1_3B, WanVAEConfig)
    from videocof_torch.models.lora import ADAPTER_TARGETS, init_lora_adapters
    from videocof_torch.models.t5_encoder import init_t5_encoder
    from videocof_torch.models.teacache import (get_teacache_coefficients,
                                                plan_teacache_skips)
    from videocof_torch.models.wan_dit import (init_wan_dit,
                                               make_rope_for_geometry)
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.ops import _build
    from videocof_torch.ops import flash_attention as fa
    from videocof_torch.ops import int8_attention as i8
    from videocof_torch.pipeline import WanPipeline, latent_frame_count
    from videocof_torch.schedulers import get_scheduler
    from videocof_torch.training import (CoFTrainer, TrainerConfig,
                                         flow_matching_loss)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    names = list(fa.KERNEL_WRAPPERS)    # B1, B2, B3
    names8 = list(i8.KERNEL_WRAPPERS)   # B4: its pre-pass and its attention

    def launch_counts():
        return {**fa.launch_counts(), **i8.launch_counts()}

    def reset_launch_counts():
        fa.reset_launch_counts()
        i8.reset_launch_counts()

    # ------------------------------------------------------------ 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = fa.build()
    log(f"[build] nvcc in parallel: " + ", ".join(
        f"{src} {s:.2f} s" for src, s in build_s.items())
        + f" (wall {time.perf_counter() - t0:.2f} s)")
    for src in build_s:
        build_log = _build.build_info[src]["log"]
        for kernel, regs, st, ld in ptxas_report(build_log):
            log(f"[build] {kernel}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
        for line in build_log.splitlines():
            # warnings, and ptxas's notes of serialized wgmmas (C7515)
            if "warning" in line.lower() or "Performance Loss" in line:
                log(f"[build] {src}: {line.strip()}")
    # one instantiation per type, head dim (and LSE flag for the forward)
    for source, kernel, opcodes, want in (
            (fa.SOURCE, "flash_fwd_kernel", SASS_OPCODES,
             len(fa.DTYPES) * len(fa.HEAD_DIMS) * 2),
            (fa.BWD_SOURCE, "flash_bwd_kernel", SASS_OPCODES,
             len(fa.DTYPES) * len(fa.HEAD_DIMS)),
            (i8.SOURCE, "int8_attn_kernel", SASS_OPCODES_INT8,
             len(i8.DTYPES) * len(i8.HEAD_DIMS))):
        sass, gmma = sass_counts(_build.library_path(source), kernel, opcodes)
        for label, counts in sass.items():
            log(f"[sass] {label}: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
        log(f"[sass] {kernel}: wgmma opcodes seen: {gmma}")
        if len(sass) != want or any(0 in c.values() for c in sass.values()):
            fail(f"{kernel}'s SASS lacks one of {opcodes}: {sass}")

    # ----------------------------------------------------- 2. kernels vs plain
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def qkv(B, Lq, Lk, N, D, dtype=bf16):
        return [randn(B, L, N, D, dtype=dtype) for L in (Lq, Lk, Lk)]

    geo = GenerationConfig()
    vcfg, dcfg = WanVAEConfig(), WAN21_T2V_1_3B
    tc, sc = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    latent_frames = 2 * cond + ground
    _, ph, pw = dcfg.patch_size
    L = latent_frames * (geo.height // sc // ph) * (geo.width // sc // pw)
    N, D, Lt = dcfg.num_heads, dcfg.head_dim, 512
    log(f"[geometry] {latent_frames} latent frames, {L} DiT tokens, "
        f"{N} heads of {D}")

    cases = [
        ("self-attention, 2 of 12 heads", (1, L, L, 2, D), None, bf16),
        ("cross-attention", (1, L, Lt, N, D), None, bf16),
        ("ragged L=3000", (1, 3000, 3000, 4, D), None, bf16),
        ("key mask, fully masked batch row", (2, 1000, 777, 3, D), "mask",
         bf16),
        ("head_dim 64", (1, 3000, 3000, 4, 64), None, bf16),
        ("fp16", (1, 1000, 700, 2, D), None, torch.float16),
    ]
    errs = {n: [0.0, 0.0] for n in names + names8 + ["int8_flash_attention"]}

    def note(kernel, err_rel):
        errs[kernel] = [max(a, b) for a, b in zip(errs[kernel], err_rel)]

    def check_forward(label, q, k, v, mask, quiet=False):
        """B1 and B2 against their plain versions (out, LSE), and B1(q,
        scale) equal bit for bit to B2(round(q * scale), scale 1): the
        kernel scales q in the same two roundings. Returns (the scale-folded
        q, B2's plain out and LSE)."""
        Dh, dtype = q.shape[-1], q.dtype
        out1 = fa.flash_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, kv_mask=mask)
        note("flash_attention_fwd",
             compare(f"B1 {label}", out1, ref, quiet=quiet))
        # B2, on the scale-folded q as the training forward runs it
        qs = q * fa._rounded(Dh ** -0.5, dtype)
        out, lse = fa.flash_fwd_lse(qs, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_fwd_lse_reference(qs, k, v, kv_mask=mask)
        note("flash_attention_fwd_lse",
             compare(f"B2 out {label}", out, ref, quiet=quiet))
        lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)
                   ).max().item()
        lse_ok = bool(torch.isfinite(lse).all()) and lse_err <= LSE_TOL
        same = torch.equal(out1, out)
        if not (quiet and lse_ok and same):
            log(f"[kernel vs plain] B2 lse {label}: max relative err "
                f"{lse_err:.3e} (tol {LSE_TOL}), lse in "
                f"[{ref_lse.min().item():.4g}, {ref_lse.max().item():.4g}]: "
                f"{'ok' if lse_ok else 'FAIL'}; B1 == B2 on the scale-folded "
                f"q bit for bit: {'ok' if same else 'FAIL'}")
        if not lse_ok:
            fail(f"B2's LSE disagrees with its plain version: {label}")
        if not same:
            fail(f"B1 and B2 differ on the scale-folded q: {label}")
        return qs, ref, ref_lse

    c1 = {}     # B3's relative L2 against the fp32 plain backward, by case

    def check_backward(label, qs, k, v, ref, ref_lse, quiet=False):
        """B3 against the plain backward in its own arithmetic (P and dS
        rounded, ``rounded=True``) and in JAX's fp32 arithmetic, from the
        plain LSE and delta so that the kernel is held alone."""
        B, Lq, Nh, Dh = qs.shape
        do = randn(B, Lq, Nh, Dh, dtype=qs.dtype)
        delta = fa.flash_bwd_delta(ref, do)
        got = fa.flash_bwd(qs, k, v, do, ref_lse, delta)
        torch.cuda.synchronize()
        # with one key P = 1 and dS = P (dP - delta) = 0 but for rounding:
        # dq and dk are rounding noise there, held by the absolute bound
        noise = ("dq", "dk") if k.shape[1] == 1 else ()
        want = {rounded: (fa.flash_bwd_dq_reference(
                    qs, k, v, do, ref_lse, delta, rounded=rounded),
                    *fa.flash_bwd_dkv_reference(qs, k, v, do, ref_lse, delta,
                                                rounded=rounded))
                for rounded in (True, False)}
        sizes = {}
        for part, g, w, w32 in zip(("dq", "dk", "dv"), got, want[True],
                                   want[False]):
            err, rel = compare(
                f"B3 {part} vs rounded plain {label}", g, w, quiet=quiet,
                rel_tol=None if part in noise else B3_ROUNDED_TOL)
            # the noise's relative error (over a norm near 0) is not kept
            note("flash_attention_bwd", (err, 0.0 if part in noise else rel))
            # C1's size on these inputs: the rounded plain vs the fp32 one
            size = ((w.float() - w32.float()).norm() / w32.float().norm()
                    ).item()
            _, rel = compare(
                f"B3 {part} vs fp32 plain (the rounding alone: {size:.3e}) "
                f"{label}", g, w32, quiet=quiet,
                rel_tol=None if part in noise else B3_FP32_FACTOR * size)
            sizes[part] = {"kernel": rel, "rounded_plain": size}
        if not quiet:
            c1[label] = sizes
        del want

    for name, shape, masked, dtype in cases:
        B, Lq, Lk, Nh, Dh = shape
        label = f"{name} {shape} {str(dtype)[6:]}"
        q, k, v = qkv(*shape, dtype=dtype)
        mask = None
        if masked:
            mask = torch.rand(B, Lk, generator=gen, device=dev) > 0.3
            mask[-1] = False
        qs, ref, ref_lse = check_forward(label, q, k, v, mask)
        if masked:
            # B3 takes no mask (the masked path's backward is plain, as in
            # JAX): hold it at this case's shape without the mask
            ref, ref_lse = fa.flash_fwd_lse_reference(qs, k, v)
            label += " (B3 unmasked)"
        check_backward(label, qs, k, v, ref, ref_lse)
        del q, k, v, qs, ref, ref_lse
    # B1 and B2 at lengths on and beside their 128-row q tiles and 128-key
    # K/V tiles (TMA's zero fill, the -inf of the ragged keys, rows never
    # stored), at both head dims and both types; one line unless one fails
    edges = [(Lq, Lk, Dh, dtype) for Lq in (1, 127, 129)
             for Lk in (1, 127, 129, 512)
             for Dh, dtype in ((D, bf16), (64, torch.float16))]
    for Lq, Lk, Dh, dtype in edges:
        check_forward(f"tile edge Lq={Lq} Lk={Lk} D={Dh} {str(dtype)[6:]}",
                      *qkv(2, Lq, Lk, 3, Dh, dtype=dtype), None, quiet=True)
    log(f"[kernel vs plain] B1, B2 at {len(edges)} tile-edge lengths (Lq "
        f"1/127/129 x Lk 1/127/129/512, D {D} bf16 and D 64 fp16): ok; "
        f"B1 == B2 bit for bit in each")
    # B3 at lengths on and beside its 64-row q tiles and 128-key tiles (TMA's
    # zero rows, the masked keys of the ragged key tile, dQ rows past Lq
    # dropped by the reduce-add, lse and delta rows padded to 16 bytes)
    edges_bwd = [(Lq, Lk, Dh, dtype) for Lq in (1, 63, 65, 129)
                 for Lk in (1, 127, 129, 512)
                 for Dh, dtype in ((D, bf16), (64, torch.float16))]
    for Lq, Lk, Dh, dtype in edges_bwd:
        q, k, v = qkv(2, Lq, Lk, 3, Dh, dtype=dtype)
        qs = q * fa._rounded(Dh ** -0.5, dtype)
        check_backward(f"tile edge Lq={Lq} Lk={Lk} D={Dh} {str(dtype)[6:]}",
                       qs, k, v, *fa.flash_fwd_lse_reference(qs, k, v),
                       quiet=True)
    log(f"[kernel vs plain] B3 at {len(edges_bwd)} tile-edge lengths (Lq "
        f"1/63/65/129 x Lk 1/127/129/512, D {D} bf16 and D 64 fp16): ok "
        f"against both plain versions")
    log("[C1] B3's relative L2 against the fp32 plain backward (JAX's "
        "arithmetic): " + json.dumps(c1))
    torch.cuda.empty_cache()

    # B4: the pre-pass against its plain version on the same K mean, the
    # attention kernel against its plain version on the same quantized K,
    # and the two together against B4's plain version and against
    # unquantized attention; batch 2 at the path's shapes (batched CFG)
    cases8 = [
        ("self-attention, CFG batch, 2 of 12 heads", (2, L, L, 2, D), None,
         bf16),
        ("cross-attention, CFG batch", (2, L, Lt, N, D), None, bf16),
        ("ragged L=3000", (1, 3000, 3000, 4, D), None, bf16),
        ("key mask, fully masked batch row", (2, 1000, 777, 3, D), "mask",
         bf16),
        ("head_dim 256", (1, 3000, 3000, 2, 256), None, bf16),
        ("fp16", (1, 1000, 700, 2, D), None, torch.float16),
    ]
    def check_int8(label, q, k, v, mask, quiet=False):
        """B4's pre-pass, its attention kernel and the whole of it against
        their plain versions, and the whole against unquantized attention
        (cosine); ``quiet`` logs only a failure."""
        B = q.shape[0]
        mean = i8.k_mean(k)
        ki, sk = i8.int8_quantize_k(k, mean)
        torch.cuda.synchronize()
        ki_ref, sk_ref = i8.quantize_k_reference(k, mean)
        levels = (ki.int() - ki_ref.int()).abs()
        flips = (levels > 0).float().mean().item()
        sk_err = ((sk - sk_ref).abs() / sk_ref).max().item()
        deq = ki.float() * sk[..., None]
        deq_ref = ki_ref.float() * sk_ref[..., None]
        deq_err = (deq - deq_ref).abs().max().item()
        deq_rel = ((deq - deq_ref).norm() / deq_ref.norm()).item()
        ok = (levels.max().item() <= 1 and flips <= QUANT_FLIP_TOL
              and sk_err <= 1e-6)
        if not (quiet and ok):
            log(f"[kernel vs plain] B4 pre-pass {label}: int8 values off by "
                f"<= {levels.max().item()} level in a share {flips:.3e} (tol "
                f"1 level, {QUANT_FLIP_TOL}), row scales max relative err "
                f"{sk_err:.3e} (tol 1e-6), dequantized K max abs err "
                f"{deq_err:.3e}: {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"B4's quantization pre-pass disagrees: {label}")
        note("int8_quantize_k", (deq_err, deq_rel))
        del ki_ref, sk_ref, levels, deq, deq_ref
        out = i8.int8_attention_fwd(q, ki, sk, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref = i8.int8_attention_reference(q, ki, sk, v, kv_mask=mask)
        note("int8_attention_fwd",
             compare(f"B4 attention {label}", out, ref, quiet=quiet))
        del out, ref, ki, sk
        out = i8.int8_flash_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref = i8.int8_flash_attention_reference(q, k, v, kv_mask=mask)
        note("int8_flash_attention",
             compare(f"B4 whole {label}", out, ref, quiet=quiet))
        # a fully masked row averages V over each wrapper's own padded
        # length (B1's key block is 1024, B4's 512): left out here
        rows = slice(0, B - 1) if mask is not None else slice(None)
        exact = fa.flash_attention_reference(q, k, v, kv_mask=mask)[rows]
        got, exact = out[rows].float(), exact.float()
        diff = got - exact
        rel = (diff.norm() / exact.norm()).item()
        cos = (got * exact).sum().item() / (got.norm() * exact.norm()).item()
        if not (quiet and cos > COS_TOL):
            log(f"[int8 vs unquantized] B4 {label}: relative L2 err "
                f"{rel:.3e}, cosine similarity {cos:.6f} (tol > {COS_TOL}): "
                f"{'ok' if cos > COS_TOL else 'FAIL'}")
        if not cos > COS_TOL:
            fail(f"B4 strays from unquantized attention: {label}")

    for name, shape, masked, dtype in cases8:
        B, Lq, Lk, Nh, Dh = shape
        q, k, v = qkv(*shape, dtype=dtype)
        mask = None
        if masked:
            mask = torch.rand(B, Lk, generator=gen, device=dev) > 0.3
            mask[-1] = False
        check_int8(f"{name} {shape} {str(dtype)[6:]}", q, k, v, mask)
        del q, k, v, mask
    # B4 at lengths on and beside its 128-row q tiles and its K/V tiles (128
    # keys at D = 128, 64 at D = 256); one line unless one fails
    edges8 = [(Lq, Lk, Dh, dtype) for Lq in (1, 127, 129)
              for Lk in (1, 127, 129, 512)
              for Dh, dtype in ((D, bf16), (256, torch.float16))]
    for Lq, Lk, Dh, dtype in edges8:
        check_int8(f"tile edge Lq={Lq} Lk={Lk} D={Dh} {str(dtype)[6:]}",
                   *qkv(2, Lq, Lk, 3, Dh, dtype=dtype), None, quiet=True)
    log(f"[kernel vs plain] B4 at {len(edges8)} tile-edge lengths (Lq "
        f"1/127/129 x Lk 1/127/129/512, D {D} bf16 and D 256 fp16): ok")
    torch.cuda.empty_cache()

    # the kernels inside a full-width DiT (2 blocks) on a small latent: the
    # forward, and the gradient of LoRA adapters (non-zero up, so every
    # adapter gets one) against the naive backend
    small = dcfg.replace(num_layers=2)
    dit_small = init_wan_dit(small, gen, bf16, dev)
    x = torch.randn(1, small.in_dim, 5, 30, 52, generator=gen, device=dev)
    ctx = randn(1, Lt, small.text_dim)
    cos, sin = (torch.as_tensor(a, device=dev) for a in make_rope_for_geometry(
        small, (5, 15, 26), f_src=2, f_ground=1))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        v_flash = dit_small(x.to(bf16), t, ctx, cos, sin, attn_backend="flash")
        v_naive = dit_small(x.to(bf16), t, ctx, cos, sin, attn_backend="naive")
    rel = ((v_flash - v_naive).norm() / v_naive.norm()).item()
    log(f"[kernel vs plain] 2-block 1.3B-width DiT, 1950 tokens, flash vs "
        f"naive: relative L2 error {rel:.3e} (tol {DIT_REL_TOL})")
    if not (torch.isfinite(v_flash).all() and rel <= DIT_REL_TOL):
        fail("DiT through the kernels disagrees with the naive backend")
    before = launch_counts()
    with torch.no_grad():
        v_int8 = dit_small(x.to(bf16), t, ctx, cos, sin, attn_backend="int8")
    after = launch_counts()
    ran = {n: after[n] - before[n] for n in after}
    rel = ((v_int8 - v_naive).norm() / v_naive.norm()).item()
    log(f"[kernel vs plain] 2-block 1.3B-width DiT, 1950 tokens, int8 (B4) "
        f"vs naive: relative L2 error {rel:.3e} (tol {DIT_INT8_REL_TOL}); "
        f"launches {ran}")
    if not (torch.isfinite(v_int8).all() and rel <= DIT_INT8_REL_TOL):
        fail("DiT through B4 disagrees with the naive backend")
    if ran != dict(dict.fromkeys(names, 0), int8_quantize_k=4,
                   int8_attention_fwd=4):
        fail(f"DiT through B4 launched {ran}")
    try:
        leaf = torch.zeros(1, 64, 2, 128, dtype=bf16, device=dev,
                           requires_grad=True)
        i8.int8_flash_attention(leaf, leaf, leaf)
    except NotImplementedError as exc:
        log(f"[int8] under autograd: raises NotImplementedError ({exc})")
    else:
        fail("B4 under autograd did not raise")
    del v_int8
    dit_small.requires_grad_(False)
    adapters = init_lora_adapters(small, gen, rank=16)
    with torch.no_grad():
        for p in adapters.parameters():
            if p.abs().max() == 0:
                p.copy_(1e-2 * torch.randn(p.shape, generator=gen, device=dev))
    noise = torch.randn(x.shape, generator=gen, device=dev)
    frame_mask = torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0], device=dev)
    grads = {}
    for backend in ("flash", "naive"):
        adapters.zero_grad(set_to_none=True)
        before = fa.launch_counts()
        loss = flow_matching_loss(
            dit_small, x, ctx, cos, sin, torch.tensor([700], device=dev),
            noise, attn_backend=backend, remat=True, frame_mask=frame_mask,
            lora=(adapters, adapters.scale))
        loss.backward()
        after = fa.launch_counts()
        grads[backend] = torch.cat([p.grad.flatten()
                                    for p in adapters.parameters()])
        if backend == "flash" and [after[n] - before[n] for n in names] != [
                0, 8, 4]:
            fail(f"DiT gradient through the kernels launched "
                 f"{ {n: after[n] - before[n] for n in names} }")
    rel = ((grads["flash"] - grads["naive"]).norm()
           / grads["naive"].norm()).item()
    log(f"[kernel vs plain] 2-block 1.3B-width DiT, LoRA adapter gradient "
        f"(remat, frame mask), flash vs naive: relative L2 error {rel:.3e} "
        f"(tol {DIT_REL_TOL})")
    if not (torch.isfinite(grads["flash"]).all() and rel <= DIT_REL_TOL):
        fail("LoRA gradient through the kernels disagrees with the naive "
             "backend")
    del dit_small, v_flash, v_naive, adapters, grads, loss
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 3. timing
    F = torch.nn.functional
    timing = {}
    for shape_name, (B, Lq, Lk), plain_runs in (("self", (1, L, L), 3),
                                                ("cross", (1, L, Lt), 10)):
        q, k, v = qkv(B, Lq, Lk, N, D)
        qs = q * fa._rounded(D ** -0.5, bf16)
        do = randn(B, Lq, N, D)
        out, lse = fa.flash_fwd_lse(qs, k, v)
        delta = fa.flash_bwd_delta(out, do)
        runs = {
            "flash_attention_fwd": (lambda: fa.flash_attention(q, k, v),
                                    lambda: fa.flash_attention_reference(
                                        q, k, v)),
            "flash_attention_fwd_lse": (
                lambda: fa.flash_fwd_lse(qs, k, v),
                lambda: fa.flash_fwd_lse_reference(qs, k, v)),
            # the wrapper: the dQ accumulator's zeroing, the kernel, the cast
            "flash_attention_bwd": (
                lambda: fa.flash_bwd(qs, k, v, do, lse, delta),
                lambda: (fa.flash_bwd_dq_reference(qs, k, v, do, lse, delta,
                                                   rounded=True),
                         fa.flash_bwd_dkv_reference(qs, k, v, do, lse, delta,
                                                    rounded=True))),
        }
        # yardsticks: SDPA's forward without and with a gradient to carry
        # (then it keeps its LSE), and SDPA's backward alone
        qt, kt, vt, dot = (a.transpose(1, 2) for a in (q, k, v, do))
        lq, lk, lv = (a.detach().requires_grad_() for a in (qt, kt, vt))
        with torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(lq, lk, lv)

        def sdpa_fwd_grad():
            with torch.enable_grad():
                F.scaled_dot_product_attention(lq, lk, lv)

        library = {
            "flash_attention_fwd": lambda: F.scaled_dot_product_attention(
                qt, kt, vt),
            "flash_attention_fwd_lse": sdpa_fwd_grad,
            "flash_attention_bwd": lambda: torch.autograd.grad(
                sdpa_out, (lq, lk, lv), dot, retain_graph=True),
        }
        work = kernel_work(B, Lq, Lk, N, D)
        shape = f"B={B} Lq={Lq} Lk={Lk} N={N} D={D} bf16"
        timing[shape_name] = {}
        for kname in names:
            kernel_fn, plain_fn = runs[kname]
            ms = cuda_ms(kernel_fn, runs=10)
            plain_ms = cuda_ms(plain_fn, runs=plain_runs, warmup=1)
            library_ms = cuda_ms(library[kname], runs=10)
            bound_ms, bound_by = bound(*work[kname])
            tflops = work[kname][0] / ms / 1e9
            timing[shape_name][kname] = dict(
                shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, tflops=tflops)
            log(f"[timing] {kname} {shape_name} {shape}: kernel_ms {ms:.4f} "
                f"bound_ms {bound_ms:.4f} ({bound_by}) plain_ms "
                f"{plain_ms:.4f} library_ms {library_ms:.4f} (share of bound "
                f"{bound_ms / ms:.1%}; {tflops:.1f} TFLOP/s, library "
                f"{work[kname][0] / library_ms / 1e9:.1f})")
        del q, k, v, qs, do, out, lse, delta, qt, kt, vt, dot, lq, lk, lv
        del sdpa_out, runs, library
        torch.cuda.empty_cache()

    # B4 at the standard edit's shapes (batched CFG: batch 2): the whole of
    # it (K mean, pre-pass, attention) and each kernel; the yardstick is
    # SDPA's unquantized bf16 forward, which is not the same function (no
    # PyTorch call computes int8 attention); B1 at the same shapes says
    # whether the int8 QK^T pays
    timing8 = {}
    for shape_name, (B, Lq, Lk), plain_runs in (("self", (2, L, L), 3),
                                                ("cross", (2, L, Lt), 10)):
        q, k, v = qkv(B, Lq, Lk, N, D)
        mean = i8.k_mean(k)
        ki, sk = i8.int8_quantize_k(k, mean)
        runs = {
            "int8_flash_attention": (
                lambda: i8.int8_flash_attention(q, k, v),
                lambda: i8.int8_flash_attention_reference(q, k, v)),
            "int8_quantize_k": (lambda: i8.int8_quantize_k(k, mean),
                                lambda: i8.quantize_k_reference(k, mean)),
            "int8_attention_fwd": (
                lambda: i8.int8_attention_fwd(q, ki, sk, v),
                lambda: i8.int8_attention_reference(q, ki, sk, v)),
        }
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          runs=10)
        b1_ms = cuda_ms(lambda: fa.flash_attention(q, k, v), runs=10)
        ops = 4 * B * N * Lq * Lk * D    # int8 QK^T and bf16 PV together
        bounds = int8_bounds(B, Lq, Lk, N, D)
        shape = f"B={B} Lq={Lq} Lk={Lk} N={N} D={D} bf16"
        timing8[shape_name] = {}
        for kname, (kernel_fn, plain_fn) in runs.items():
            ms = cuda_ms(kernel_fn, runs=10)
            plain_ms = cuda_ms(plain_fn, runs=plain_runs, warmup=1)
            bound_ms, bound_by = bounds[kname]
            timing8[shape_name][kname] = dict(
                shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                sdpa_unquantized_ms=sdpa_ms, b1_ms=b1_ms)
            attention = kname != "int8_quantize_k"
            if attention:
                timing8[shape_name][kname]["tops"] = ops / ms / 1e9
            log(f"[timing] {kname} {shape_name} {shape}: kernel_ms {ms:.4f} "
                f"bound_ms {bound_ms:.4f} ({bound_by}) plain_ms "
                f"{plain_ms:.4f} (share of bound {bound_ms / ms:.1%}"
                + (f"; {ops / ms / 1e9:.1f} TOP/s, int8 and bf16 together; "
                   f"B1 (bf16) at this shape {b1_ms:.4f} ms, {b1_ms / ms:.3f}x"
                   f" this" if attention else "")
                + f"); SDPA bf16 forward, unquantized, not the same "
                f"function: {sdpa_ms:.4f} ms")
        del q, k, v, mean, ki, sk, runs, qt, kt, vt
        torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. the edit
    t0 = time.perf_counter()
    t5 = init_t5_encoder(T5Config(), gen, bf16, dev)
    vae = init_wan_vae(vcfg, gen, bf16, dev)
    dit = init_wan_dit(dcfg, gen, bf16, dev)
    pipe = WanPipeline(dit, vae, t5, dtype=bf16)
    torch.cuda.synchronize()
    log(f"[edit] random weights (seed {SEED}) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    video = np.random.default_rng(SEED).integers(
        0, 256, (1, 3, geo.source_frames, geo.height, geo.width),
        dtype=np.uint8)
    prompt = "replace the red car with a blue bicycle"
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, source_frames=geo.source_frames,
               reasoning_frames=geo.reasoning_frames,
               num_inference_steps=geo.num_inference_steps,
               guidance_scale=geo.guidance_scale, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope,
               cot=geo.cot, seed=geo.seed, timings=timings)
    wall = time.perf_counter() - t0
    edit_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    out_frames = 1 + (ground - 1) * tc + geo.source_frames
    want_shape = (1, 3, out_frames, geo.height, geo.width)
    want_launches = dict.fromkeys(names + names8, 0)
    want_launches["flash_attention_fwd"] = (2 * dcfg.num_layers
                                            * geo.num_inference_steps)
    vid = out.videos
    log(f"[edit] output {vid.shape} min {vid.min():.4f} max {vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("output frames not finite or outside [0, 1]")
    if edit_launches != want_launches:
        fail(f"the edit launched {edit_launches}, expected {want_launches}")
    step_flops = dit_step_flops(dcfg, L, Lt)
    steps = [timings[f"step{i}"] for i in range(geo.num_inference_steps)]
    log("[edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[edit] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb:.2f} GB; launches {edit_launches}; DiT "
        f"{step_flops:.3e} FLOP/step, {step_flops / statistics.median(steps) / 1e12:.1f} "
        f"TFLOP/s (median step)")
    log("[edit] " + json.dumps({
        "card": card, "seconds_per_edit": wall, "stages_s": timings,
        "peak_memory_gb": peak_gb, "dit_flop_per_step": step_flops,
        "launches": edit_launches}))
    del out, vid

    # one DiT step of the edit's geometry under torch.profiler: device time
    # by kernel, and the device's idle share of the step's wall time
    grid = (latent_frames, geo.height // sc // ph, geo.width // sc // pw)
    x = torch.randn(1, dcfg.in_dim, latent_frames, geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(bf16)
    ctx = randn(1, Lt, dcfg.text_dim)
    cos, sin = (torch.as_tensor(arr, device=dev) for arr in
                make_rope_for_geometry(dcfg, grid, f_src=cond,
                                       f_ground=ground))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        report_profile(f"one DiT step at {L} tokens",
                       *profile_kernels(lambda: dit(x, t, ctx, cos, sin)))
    del x, ctx, cos, sin, pipe
    torch.cuda.empty_cache()

    # ------------------------------------------------ 5. the standard edit
    std = GenerationConfig(num_inference_steps=STD_STEPS, guidance_scale=5.0,
                           enable_teacache=True)
    pipe = WanPipeline(dit, vae, t5, dtype=bf16, attn_backend="int8")
    sched = get_scheduler(std.sampler)
    sched.set_timesteps(std.num_inference_steps, shift=std.shift)
    coeffs = get_teacache_coefficients("wan2.1-t2v-1.3b")
    own_plan = plan_teacache_skips(dit, sched.timesteps, coeffs,
                                   std.teacache_threshold,
                                   std.teacache_skip_start_steps)
    plan = pinned_teacache_plan(std.num_inference_steps, TEACACHE_PIN)
    show = lambda p: "".join("s" if x else "c" for x in p)  # noqa: E731
    log(f"[standard edit] TeaCache plan these random weights give "
        f"(threshold {std.teacache_threshold}, {std.teacache_skip_start_steps}"
        f" warm-up steps): {sum(own_plan)} of {len(own_plan)} steps skipped, "
        f"{show(own_plan)}; pinned at {TEACACHE_PIN}: {sum(plan)} skipped, "
        f"{show(plan)}")
    std_timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, negative_prompt=std.negative_prompt,
               source_frames=std.source_frames,
               reasoning_frames=std.reasoning_frames,
               num_inference_steps=std.num_inference_steps,
               guidance_scale=std.guidance_scale, shift=std.shift,
               sampler=std.sampler, repeat_rope=std.repeat_rope, cot=std.cot,
               seed=std.seed, enable_teacache=std.enable_teacache,
               teacache_threshold=std.teacache_threshold,
               teacache_skip_start_steps=std.teacache_skip_start_steps,
               teacache_coefficients=coeffs, teacache_forced_plan=plan,
               cfg_skip_ratio=std.cfg_skip_ratio, timings=std_timings)
    std_wall = time.perf_counter() - t0
    std_launches = launch_counts()
    std_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    computed = plan.count(False)
    want_std = dict(dict.fromkeys(names, 0),
                    int8_quantize_k=2 * dcfg.num_layers * computed,
                    int8_attention_fwd=2 * dcfg.num_layers * computed)
    vid = out.videos
    log(f"[standard edit] output {vid.shape} min {vid.min():.4f} max "
        f"{vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"standard edit output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("standard edit frames not finite or outside [0, 1]")
    if std_launches != want_std:
        fail(f"the standard edit launched {std_launches}, expected "
             f"{want_std}")
    walls = [v for k, v in std_timings.items() if k.startswith("step")]
    skipped = [v for k, v in std_timings.items() if k.endswith("skipped")]
    computed_walls = [v for k, v in std_timings.items()
                      if k.startswith("step") and not k.endswith("skipped")]
    log("[standard edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in std_timings.items()))
    log(f"[standard edit] seconds per edit {std_wall:.3f}; peak device memory "
        f"{std_peak_gb:.2f} GB; launches {std_launches}; {computed} computed "
        f"steps, median {statistics.median(computed_walls):.3f} s (batch 2, "
        f"{2 * step_flops:.3e} FLOP, "
        f"{2 * step_flops / statistics.median(computed_walls) / 1e12:.1f} "
        f"TFLOP/s); {len(skipped)} skipped steps, median "
        f"{statistics.median(skipped):.3f} s; the 50 steps {sum(walls):.3f} s")
    log("[standard edit] " + json.dumps({
        "card": card, "seconds_per_edit": std_wall, "stages_s": std_timings,
        "peak_memory_gb": std_peak_gb, "launches": std_launches,
        "teacache_plan": show(plan), "teacache_plan_own": show(own_plan)}))
    del out, vid, pipe

    # one batched-CFG DiT step (batch 2) through B4 under torch.profiler
    x = torch.randn(2, dcfg.in_dim, latent_frames, geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(bf16)
    ctx = randn(2, Lt, dcfg.text_dim)
    cos, sin = (torch.as_tensor(arr, device=dev) for arr in
                make_rope_for_geometry(dcfg, grid, f_src=cond,
                                       f_ground=ground))
    t = torch.full((2,), 937.0, device=dev)
    with torch.no_grad():
        report_profile(f"one batched-CFG DiT step (batch 2) through B4 at {L} "
                       "tokens", *profile_kernels(
                           lambda: dit(x, t, ctx, cos, sin,
                                       attn_backend="int8")))
    del x, ctx, cos, sin
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 6. training
    tcfg = TrainerConfig(lora_rank=16)
    base = {name: p.detach().clone() for name, p in dit.named_parameters()}
    trainer = CoFTrainer(dit, vae, t5, None, tcfg)
    rng = np.random.default_rng(SEED)

    def triplet():
        return {key: rng.uniform(-1, 1, (3, frames, tcfg.height, tcfg.width)
                                 ).astype(np.float32)
                for key, frames in (("pixel_src", tcfg.source_frames),
                                    ("pixel_ground", tcfg.reasoning_frames),
                                    ("pixel_tgt", tcfg.target_frames))
                } | {"text": prompt}

    # drawn ahead, as a data loader would prefetch them: the steps time the
    # trainer, not numpy
    samples = iter([triplet() for _ in range(TRAIN_STEPS + 1)])
    train_stages = []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_walls = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        trainer.train(samples, total_steps=1, timings=train_stages)
        step_walls.append(time.perf_counter() - t0)
        if step == 0:
            moved = max(lin.up.detach().abs().max().item()
                        for block in trainer.state.adapters.blocks
                        for mod in ADAPTER_TARGETS for lin in block[mod].values())
            log(f"[train] after step 1: max |up| {moved:.3e}")
            if not moved > 0.0:
                fail("no adapter moved in the first training step")
    train_launches = launch_counts()
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    attentions = 2 * dcfg.num_layers            # self + cross per block
    want_train = {**dict.fromkeys(names8, 0), "flash_attention_fwd": 0,
                  "flash_attention_fwd_lse": 2 * attentions * TRAIN_STEPS,
                  "flash_attention_bwd": attentions * TRAIN_STEPS}
    losses = trainer.losses
    log(f"[train] losses {losses}")
    for i, (st, w) in enumerate(zip(train_stages, step_walls)):
        log(f"[train] step {i + 1}{' (warm-up)' if i == 0 else ''}: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
            + f"; wall {w:.3f} s")
    log(f"[train] seconds per step {statistics.median(step_walls[1:]):.3f} "
        f"(median after the warm-up); peak device memory {train_peak_gb:.2f} "
        f"GB; launches {train_launches} (expected {want_train})")
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        fail(f"training losses {losses}")
    changed = [name for name, p in dit.named_parameters()
               if not torch.equal(p.detach(), base[name])]
    if changed:
        fail(f"training changed base weights: {changed[:5]}")
    if train_launches != want_train:
        fail(f"training launched {train_launches}, expected {want_train}")
    log("[train] " + json.dumps({
        "card": card, "seconds_per_step": step_walls, "stages_s": train_stages,
        "losses": losses, "peak_memory_gb": train_peak_gb,
        "launches": train_launches}))
    del base
    report_profile("one LoRA training step", *profile_kernels(
        lambda: trainer.train(samples, total_steps=1)))

    # ------------------------------------------------------------ 7. report
    sources = {"flash_attention_fwd": "flash_attention_fwd.cu",
               "flash_attention_fwd_lse": "flash_attention_fwd.cu",
               "flash_attention_bwd": "flash_attention_bwd.cu"}
    replaces = {"flash_attention_fwd": ("41", "_flash_kernel, need_lse=False"),
                "flash_attention_fwd_lse": ("41", "_flash_kernel, need_lse=True"
                                            " (lse_ref :96-98)"),
                "flash_attention_bwd": ("201,233",
                                        "_bwd_dq_kernel and _bwd_dkv_kernel")}
    launches = {n: (edit_launches if n == "flash_attention_fwd"
                    else train_launches)[n] for n in names}
    rows = []
    for kname in names:
        main_shape = timing["self"][kname]
        line, tpu = replaces[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"videocof_torch/csrc/{sources[kname]}",
            "replaces": f"videocof_tpu/ops/flash_attention.py:{line}",
            "tpu_kernel": tpu,
            "launches": launches[kname],
            "launches_on": "edit" if kname == "flash_attention_fwd"
                           else f"{TRAIN_STEPS} training steps",
            "max_abs_err": errs[kname][0],
            "max_rel_l2_err": errs[kname][1],
            **({"rel_l2_err_vs_fp32_plain": c1}
               if kname == "flash_attention_bwd" else {}),
            "ms": main_shape["ms"], "tflops": main_shape["tflops"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": main_shape["shape"],
            "cross": timing["cross"][kname],
        })
    # B4: its two kernels, with the whole of it (K mean, pre-pass,
    # attention) beside the attention kernel's row
    tpu8 = {"int8_quantize_k": "_int8_kernel's K quantization (:68-71)",
            "int8_attention_fwd": "_int8_kernel"}
    for kname in names8:
        main_shape = timing8["self"][kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"videocof_torch/csrc/{i8.SOURCE}",
            "replaces": "videocof_tpu/ops/int8_attention.py:51",
            "tpu_kernel": tpu8[kname],
            "launches": std_launches[kname],
            "launches_on": "standard edit",
            "max_abs_err": errs[kname][0],
            "max_rel_l2_err": errs[kname][1],
            **{key: main_shape[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "sdpa_unquantized_ms", "b1_ms", "shape") + (
                    ("tops",) if "tops" in main_shape else ())},
            "cross": timing8["cross"][kname],
            **({"b4_whole": dict(
                timing8["self"]["int8_flash_attention"],
                max_abs_err=errs["int8_flash_attention"][0],
                max_rel_l2_err=errs["int8_flash_attention"][1],
                cross=timing8["cross"]["int8_flash_attention"])}
               if kname == "int8_attention_fwd" else {}),
        })
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
