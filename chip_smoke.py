#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`videocof_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run (non-zero exit) on any fault:
  1. device: the card's name and power limit; the modules, ffmpeg, libav
     headers and free disk the entry's I/O could use; TF32 off; build the CUDA
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
  7. the entry at 1.3B: the phase-4 DiT written to the published layout
     (two safetensors shards, their index and a config.json) by the port's
     own writer and read back by its own reader (no safetensors package),
     every tensor equal bit for bit, the config equal to Wan2.1 T2V 1.3B's,
     the read's GB/s; then `videocof_torch.cli.fast_infer.main()` in this
     process (--random_init --repeat_rope, 480x832, 33 + 4 frames) on a
     synthetic clip written with cv2, merging two rank-32 bf16 LoRA files
     written by the port's writer (a kohya "FusionX" file as the
     acceleration LoRA, a PEFT "VideoCoF" file as --videocof_path); its
     output and files are checked, B1 must run exactly 240 times, the CLI
     must hand the factory both files and exactly the weights they name
     must differ from an unmerged draw. The phase fails where cv2, which
     the port's video I/O reads with, is not importable.
  8. the 14B edit: `factory.load_pipeline("", random_init=True,
     dit_cfg=WAN21_T2V_14B, lora_paths=[the two LoRA files at 14B
     shapes])` at full width and depth (40 blocks of 5120, 40 heads of
     128); the merged weights differ from a second draw of the unmerged
     ones in exactly the modules the LoRA files name; the 4-step 480x832
     33 + 4-frame edit (output, exactly 320 B1 launches and no other
     kernel, stage walls, peak memory); one DiT step under torch.profiler.
  9. the 4x length-extrapolation edit at 1.3B (random weights drawn by
     `factory.load_pipeline("", random_init=True)`, full width and depth):
     a uint8 clip of 133 frames (4x the 33-frame clip, 34 latent frames)
     with 4 reasoning frames, 4 Flow-UniPC steps, repeat RoPE and RIFLEx
     (k 6, the default L_test), the VAE streamed: 34 + 1 + 34 latent
     frames, 107,640 DiT tokens; the output [1, 3, 134, 480, 832], exactly
     240 B1 launches (120 self at 107,640 keys, 120 cross) and no other
     kernel, stage walls, peak memory; one DiT step under torch.profiler.
     The whole-sequence VAE is not run at this length.
  10. the ragged batch: `batch_edit` over the 33-frame clip and the 4x
     clip's first 65 frames (29,640 and 54,600 tokens) as one batch of 2:
     exactly 240 B1 launches at batch 2, the 120 self-attention ones with
     the batch's key mask (valid keys 29,640 and 54,600), nothing else;
     each item's final latents against its own `pipe()` run with the same
     seed (relative L2 <= 2e-2, the DiT gate's: cuBLAS picks kernels by M,
     so bit equality is not expected).
  11. the paired edit (`cot=False`) of the 33-frame clip, 4 steps (18
     latent frames, 28,080 tokens): the output and 240 B1 launches.
  12. the streaming VAE against the whole-sequence VAE at 33 frames (the
     encode of the clip, the decode of item 0's 9-frame edit segment to
     uint8) in bf16: seconds, peak memory, mu's relative L2 and the uint8
     frames' difference. Against the whole-sequence VAE in fp32: the
     streamed VAE in fp32 within 1e-4 relative L2 (mu and decoded frames),
     and the streamed one in bf16 no further from it than 1.5x the whole
     one in bf16.
  13. the standard CLI: `videocof_torch.cli.infer.main()` in this process
     (--random_init --repeat_rope, its defaults: 50 steps, CFG 5 against
     the default negative prompt, TeaCache with Wan2.1 T2V 14B's
     coefficients) on a 40-frame clip written with cv2 (it fails without
     cv2); the TeaCache plan
     these random weights give, the files, and B1 launches equal to 2 x
     30 x the computed steps, each at batch 2.
  14. fp8 weights and runtime LoRA on the Wan2.1 14B: the unmerged draw of
     phase 8's factory call quantized on the card (`quantize_dit_fp8`;
     the DiT's bytes before and after; a block's fp8 weights and scale
     equal bit for bit to the CPU's quantization, its dequantized weights
     to (q.float() * scale).to(bf16)); one DiT forward in fp8 against bf16
     within JAX's bound (mean |err| < 0.05 mean |bf16| + 0.05); phase 8's
     two LoRA files attached as runtime adapters (`load_runtime_lora`,
     rank concatenation); the 4-step edit (output, 320 B1 launches and
     nothing else, stage walls, peak), its final latents against phase
     8's merged bf16 edit (relative L2, printed); the dequantization's and
     the adapters' fusion's milliseconds beside a step's.
  15. the Wan2.2 A14B dual-expert edit: umT5-XXL, the Wan2.1 VAE and two
     WAN22_T2V_A14B experts from two seeds, each quantized to fp8 as it is
     drawn (at most one bf16 expert resident); the 480x832 33 + 4-frame
     edit in 4 Flow-UniPC steps at shift 5, guidance 1: split_idx (0 <
     split < 4), each expert's forwards (hooks), exactly 160 self and 160
     cross B1 calls at 40 heads and nothing else, stage walls, a peak
     below the card's memory, and one fp8 expert step under
     torch.profiler.
  16. A14B text-to-video (`Wan22Pipeline.text_to_video`) at 480x832 with
     81 frames (32,760 tokens), 4 steps, guidance 4 and 3 on the
     high-noise steps, batched CFG: output, 320 B1 calls at batch 2,
     seconds, peak.
  17. the TI2V-5B with the Wan2.2 VAE (`factory.load_pipeline(
     random_init=True, dit_cfg=WAN22_TI2V_5B, vae_cfg=Wan22VAEConfig())`,
     bf16): the 33 + 4-frame edit at 704x1280 (16,720 tokens) in 4 steps:
     output, 120 + 120 B1 calls at 24 heads and nothing else, stage walls,
     peak, one DiT step under torch.profiler; the streaming Wan2.2 VAE
     against the whole-sequence one in bf16 on the source clip and the
     edit's last 9 latent frames (seconds, peaks, mu's relative L2, uint8
     levels), and on the first 9 frames against the whole-sequence VAE in
     fp32 with phase 12's gates.
  18. the entries on Wan2.2: a published-layout A14B directory (two
     experts at full width and 2 layers each, the Wan2.1 VAE, umT5-XXL)
     written by `save_wan_checkpoint_dir`, then `fast_infer.main([...,
     "--quantize", "fp8"])` (the 4-step edit of a cv2 clip) and
     `infer.main([..., "--t2v", "--quantize", "fp8", "--guidance_scale_2",
     "3.0"])` (its 50 steps, CFG 5, 65 frames) on it: a `Wan22Pipeline`
     with fp8 experts, the files, the launches, the seconds (the
     directory has no tokenizer: the factory gets
     ``require_real_tokenizer=False``).
  19. a `kernels` JSON line and, last, the device JSON line.

B1 is also held against its plain version (phase 2) and timed (phase 3) at
the 14B's 40 heads, at the self and cross shapes, and at the shapes of
phases 9 and 10: 4x self (107,640 tokens), 4x cross, and the ragged self
shape (batch 2 of 54,600 tokens, row 0's keys masked past 29,640), with
the bound of the work its rows need and of the padded work it does; and at
the Wan2.2 shapes of phases 16 and 17: the TI2V-5B's self (16,720 tokens,
24 heads) and cross, and text-to-video's self (batch 2 of 32,760 tokens,
40 heads) and cross. The VAE streams every clip longer than 2 frames (the
JAX package's threshold), in the edits of phases 4, 5, 7 and 8 too.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# files the entry phases write (checkpoints, LoRA files, clips, outputs);
# removed when each phase ends
SCRATCH = ROOT / "chiprun_out" / "chip_smoke"
# the 14B's two LoRA files, kept from the 14B edit to the fp8 phase
LORA_DIR = ROOT / "chiprun_out" / "chip_smoke_lora"

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
LORA_RANK = 32                 # the entry phases' synthetic LoRA files
LORA_ALPHA = 16.0              # ... the kohya file's alpha (scale 0.5)
CLIP_FRAMES = 40               # frames of the entry phase's synthetic clip
EXTRAP_FRAMES = 133            # the 4x edit: 1 + 4 x 33 frames, 34 latent
RAGGED_FRAMES = 65             # the ragged batch's long item (item 0: 33)
RIFLEX_K = 6                   # the 4x edit's RIFLEx frequency
RAGGED_REL_TOL = 2e-2          # a ragged item vs its own run (the DiT gate's)
TEXT_TOKENS = 512              # umT5 tokens of a prompt (max_sequence_length)
# against the whole-sequence VAE in fp32: the streamed VAE in fp32 (mu and
# decoded frames, relative L2; cuDNN picks algorithms per chunk shape), and
# the streamed one in bf16, at most this many times the whole one's distance
VAE_FP32_REL_TOL = 1e-4
VAE_STREAM_FACTOR = 1.5
# the Wan2.2 phases: Flow-UniPC steps and Wan2.2's sample shift (at 4 steps
# the timesteps are 999, 937, 833, 624: two high-noise steps of four)
A14B_STEPS = 4
A14B_SHIFT = 5.0
T2V_FRAMES = 81                # text-to-video frames (JAX's default)
T2V_GUIDANCE = 4.0             # ... its guidance, and the high-noise one's
T2V_GUIDANCE_2 = 3.0
TI2V_HW = (704, 1280)          # the TI2V-5B's published size
ENTRY22_LAYERS = 2             # layers per expert of the entries' checkpoint
# fp8 weights against bf16, one DiT forward (JAX's tests/test_fp8.py bound):
# mean |err| < FP8_ERR_REL * mean |bf16| + FP8_ERR_ABS
FP8_ERR_REL = 0.05
FP8_ERR_ABS = 0.05


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


def fingerprint(t):
    """Two int64 sums over a tensor's bits (plain and position-weighted):
    any change of its values changes them but by a vanishing chance."""
    import torch
    bits = t.detach().reshape(-1).view(
        {2: torch.int16, 4: torch.int32}[t.element_size()]).long()
    pos = torch.arange(bits.numel(), device=t.device) % 65521 + 1
    return bits.sum().item(), (bits * pos).sum().item()


def draw_unmerged(cfg, dev):
    """The DiT that `factory.load_pipeline(random_init=True, seed=SEED)`
    draws before it merges any LoRA file (the DiT first, in bf16, from a
    generator seeded with the seed)."""
    import torch
    from videocof_torch.models.wan_dit import init_wan_dit
    return init_wan_dit(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        torch.bfloat16, dev)


def changed_weights(dit, prints):
    """Names of ``dit``'s tensors whose fingerprints differ from
    ``prints``."""
    return {k for k, v in dit.state_dict().items()
            if fingerprint(v) != prints[k]}


def environment():
    """What the machine offers the entry's file and video I/O: the versions
    of the modules it could import (None: absent), ffmpeg on PATH, the libav
    headers, and the free disk beside the checkout."""
    import importlib
    import torch
    mods = {}
    for name in ("safetensors", "cv2", "PIL", "transformers",
                 "sentencepiece", "tokenizers", "imageio", "av", "decord"):
        try:
            mods[name] = getattr(importlib.import_module(name), "__version__",
                                 "?")
        except ImportError:
            mods[name] = None
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "modules": mods,
            "ffmpeg": shutil.which("ffmpeg"),
            "libav_headers": any(Path(d, "libavformat").is_dir() for d in (
                "/usr/include", "/usr/local/include",
                "/usr/include/x86_64-linux-gnu")),
            "disk_free_gb": shutil.disk_usage(ROOT).free / 1e9}


def write_lora_files(cfg, gen, out_dir):
    """Two rank-32 bf16 LoRA files over all ten linears of every block of
    ``cfg``, written by the port's writer: a kohya-format "FusionX" file
    (``lora_unet_*``, alpha 16) and a PEFT-format "VideoCoF" file (bare
    ``lora_A``/``lora_B``, no alpha). Returns their paths and the port's
    names of the modules they touch."""
    import torch
    from videocof_torch.models.weights import DIT_BLOCK_NAMES
    from videocof_torch.utils.checkpoint import write_safetensors
    d, f = cfg.dim, cfg.ffn_dim
    dims = {"ffn.0": (d, f), "ffn.2": (f, d)}
    kohya, peft = {}, {}
    for i in range(cfg.num_layers):
        for src in DIT_BLOCK_NAMES:
            din, dout = dims.get(src, (d, d))
            for sd, down, up in ((kohya, "lora_down", "lora_up"),
                                 (peft, "lora_A", "lora_B")):
                a = torch.randn(LORA_RANK, din, generator=gen,
                                device=gen.device) / din ** 0.5
                b = 0.02 * torch.randn(dout, LORA_RANK, generator=gen,
                                       device=gen.device)
                if sd is kohya:
                    base = "lora_unet_" + f"blocks.{i}.{src}".replace(".", "_")
                    sd[f"{base}.{down}.weight"] = a.to(torch.bfloat16)
                    sd[f"{base}.{up}.weight"] = b.to(torch.bfloat16)
                    sd[f"{base}.alpha"] = torch.tensor(LORA_ALPHA)
                else:
                    sd[f"blocks.{i}.{src}.{down}.weight"] = a.to(torch.bfloat16)
                    sd[f"blocks.{i}.{src}.{up}.weight"] = b.to(torch.bfloat16)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = (str(out_dir / "fusionx_lora.safetensors"),
             str(out_dir / "videocof_lora.safetensors"))
    for path, sd in zip(paths, (kohya, peft)):
        write_safetensors(path, sd)
    names = {f"blocks.{i}.{dst}" for i in range(cfg.num_layers)
             for dst in DIT_BLOCK_NAMES.values()}
    return paths, names


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


def round_trip_phase(dit):
    """Write ``dit`` to the published layout (two shards, their index, a
    config.json) with the port's writer, read it back to its device with
    the port's reader and converter, and fail unless every tensor and the
    config come back equal. Returns the read's GB/s."""
    import torch
    from videocof_torch.models import weights
    from videocof_torch.utils import checkpoint
    cfg = dit.cfg
    dev = next(dit.parameters()).device
    dtype = dit.patch_embed.weight.dtype
    ckpt = SCRATCH / "dit_checkpoint"
    t0 = time.perf_counter()
    nbytes = checkpoint.save_dit_checkpoint_dir(str(ckpt), dit, cfg,
                                                num_shards=2)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_cfg = weights.dit_config_from_checkpoint(str(ckpt))
    read = {k: v.to(dev) for k, v in weights.convert_dit_state_dict(
        weights.load_state_dict(str(ckpt)), read_cfg, dtype).items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want = dit.state_dict()
    shards = sorted(p.name for p in ckpt.glob("*.safetensors"))
    same = (set(read) == set(want) and all(
        read[k].dtype == v.dtype and torch.equal(read[k], v)
        for k, v in want.items()))
    log(f"[entry] the DiT to the published layout: {shards}, "
        f"{nbytes / 1e9:.3f} GB written in {write_s:.2f} s; read back to the "
        f"device (mapped files, from the page cache) in {read_s:.2f} s, "
        f"{nbytes / read_s / 1e9:.2f} GB/s; config == the DiT's: "
        f"{read_cfg == cfg}; {len(read)} tensors bit for bit: "
        f"{'ok' if same else 'FAIL'}")
    if read_cfg != cfg:
        fail(f"dit_config_from_checkpoint gave {read_cfg}")
    if not same:
        fail("the DiT read back from the published layout differs")
    shutil.rmtree(ckpt)
    return nbytes / read_s / 1e9


def entry_phase(card, dcfg, geo, gen, prompt, want_shape, want_launches,
                counters):
    """`fast_infer.main()` in this process with random weights (the
    factory's default, ``dcfg``) and two LoRA files merged, on a clip
    written with cv2. Fails unless the output, its files, the launches
    (``counters``: read, reset) and the merge are right: the CLI hands the
    factory both LoRA files, in order, and exactly the weights they name
    differ from an unmerged draw. Returns the phase's record."""
    import numpy as np
    import torch
    from videocof_torch.cli import fast_infer
    from videocof_torch.utils import video_io
    launch_counts, reset_launch_counts = counters
    (fusionx, videocof), names = write_lora_files(dcfg, gen, SCRATCH)
    base = draw_unmerged(dcfg, gen.device)
    prints = {k: fingerprint(v) for k, v in base.state_dict().items()}
    del base
    out_dir = SCRATCH / "out"
    clip = write_clip("entry", geo)
    argv = ["--video_path", str(clip), "--prompt", prompt, "--output_dir",
            str(out_dir), "--random_init", "--repeat_rope", "--height",
            str(geo.height), "--width", str(geo.width), "--source_frames",
            str(geo.source_frames), "--reasoning_frames",
            str(geo.reasoning_frames), "--num_inference_steps",
            str(geo.num_inference_steps), "--seed", str(SEED),
            "--enable_acceleration_lora", "--acceleration_lora_path", fusionx,
            "--videocof_path", videocof]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_loads() as built:
        arrays = fast_infer.main(argv).get(clip.name)
    entry_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if arrays is None:
        fail("fast_infer.main() edited no item")
    if len(built) != 1:
        fail(f"the entry built {len(built)} pipelines, expected 1")
    lora_paths, pipe = built.pop()
    changed = changed_weights(pipe.dit, prints)
    want_changed = {f"{n}.weight" for n in names}
    del pipe, prints
    log(f"[entry] LoRA files handed to the factory: {lora_paths}; weights "
        f"changed from the unmerged draw: {len(changed)}, the files name "
        f"{len(want_changed)}: {changed == want_changed}")
    if lora_paths != [fusionx, videocof]:
        fail(f"the entry merged {lora_paths}, expected {[fusionx, videocof]}")
    if changed != want_changed:
        fail(f"the entry's merge changed {sorted(changed ^ want_changed)[:5]}")
    vid = arrays["reason_edit"]
    log(f"[entry] output {vid.shape} min {vid.min():.4f} max {vid.max():.4f};"
        f" {entry_s:.3f} s (weights drawn, 2 LoRA files merged, decode, "
        f"edit, encode); peak {peak_gb} GB; launches {launches}")
    if vid.shape != want_shape or arrays["edit"].shape[2] != geo.source_frames:
        fail(f"entry output {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("entry output frames not finite or outside [0, 1]")
    if launches != want_launches:
        fail(f"the entry launched {launches}, expected {want_launches}")
    files = sorted(p.name for p in out_dir.glob("*"))
    want_files = [f"gen_{clip.stem}{s}" for s in (
        ".mp4", "_compare.mp4", "_info.txt", "_reason_edit.mp4")]
    info = video_io.video_info(str(out_dir / f"gen_{clip.stem}.mp4"))
    log(f"[entry] files {files}; gen_{clip.stem}.mp4: {info[0]} frames "
        f"of {info[1]}x{info[2]}")
    if files != want_files or info[:3] != (geo.source_frames, geo.height,
                                           geo.width):
        fail(f"entry files {files}, {info}")
    if fast_infer.main(argv):
        fail("the resumed entry edited an item again")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return {"card": card, "seconds": entry_s, "peak_memory_gb": peak_gb,
            "launches": launches, "files": files}


def edit_14b_phase(card, cfg14, geo, gen, video, prompt, want_shape,
                   want_launches, counters):
    """The 14B edit: `factory.load_pipeline("", random_init=True,
    dit_cfg=cfg14)` with two LoRA files at ``cfg14``'s shapes (written to
    LORA_DIR, kept for the fp8 phase); the merged weights against
    fingerprints of a second, unmerged draw (and the two merges recomputed
    on two modules); the 4-step edit of ``video`` (output, launches: 2 x
    layers x steps of B1 and nothing else, stage walls, peak memory); one
    DiT step under torch.profiler. Returns (the edit's launches, its final
    latents on the host, the two LoRA files' paths)."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.configs import WanVAEConfig
    from videocof_torch.models import weights
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.pipeline import latent_frame_count
    launch_counts, reset_launch_counts = counters
    dev, bf16 = gen.device, torch.bfloat16
    cuda = dev.type == "cuda"
    (fusionx, videocof), names = write_lora_files(cfg14, gen, LORA_DIR)
    # the unmerged weights, drawn as the factory draws them (the DiT first,
    # from a generator seeded with the seed), kept as fingerprints
    t0 = time.perf_counter()
    base = draw_unmerged(cfg14, dev)
    prints = {k: fingerprint(v) for k, v in base.state_dict().items()}
    spot = ("blocks.0.self_attn.q.weight",
            f"blocks.{cfg14.num_layers - 1}.ffn.fc2.weight")
    kept = {k: base.state_dict()[k].clone() for k in spot}
    del base
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=cfg14,
                                 seed=SEED, lora_paths=[(fusionx, 1.0),
                                                        (videocof, 1.0)])
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    sd = pipe.dit.state_dict()
    changed = changed_weights(pipe.dit, prints)
    want_changed = {f"{n}.weight" for n in names}
    # the two merges in order, recomputed on the kept modules
    files = [weights.load_state_dict(p) for p in (fusionx, videocof)]
    exact = True
    for k in spot:
        mod = k[:-len(".weight")]
        i = int(mod.split(".")[1])
        src = next(a for a, b in weights.DIT_BLOCK_NAMES.items()
                   if mod.endswith("." + b))
        w = kept[k]
        for lora_sd, key, (down, up), scale in (
                (files[0], f"lora_unet_blocks_{i}_{src.replace('.', '_')}",
                 ("lora_down", "lora_up"), LORA_ALPHA / LORA_RANK),
                (files[1], f"blocks.{i}.{src}", ("lora_A", "lora_B"), 1.0)):
            a = lora_sd[f"{key}.{down}.weight"].to(dev).float()
            b = lora_sd[f"{key}.{up}.weight"].to(dev).float()
            w = (w.float() + 1.0 * scale * (b @ a)).to(w.dtype)
        exact = exact and torch.equal(w, sd[k])
    log(f"[edit 14B] LoRA files (rank {LORA_RANK}, bf16, {len(names)} modules "
        f"each) merged while building the pipeline in {build_s:.1f} s "
        f"(unmerged draw and fingerprints {t1 - t0:.1f} s); weights changed: "
        f"{len(changed)}, the files name {len(want_changed)}: "
        f"{changed == want_changed}; the two merges recomputed on {spot}: "
        f"{'ok' if exact else 'FAIL'}")
    if changed != want_changed:
        fail(f"the merge changed {sorted(changed ^ want_changed)[:5]}")
    if not exact:
        fail("the merged weights differ from the recomputed merges")
    del sd, kept, files, prints

    timings = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, source_frames=geo.source_frames,
               reasoning_frames=geo.reasoning_frames,
               num_inference_steps=geo.num_inference_steps,
               guidance_scale=geo.guidance_scale, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope, cot=geo.cot,
               seed=geo.seed, timings=timings, output_latents=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    want = dict(want_launches, flash_attention_fwd=(
        2 * cfg14.num_layers * geo.num_inference_steps))
    vid = out.videos
    log(f"[edit 14B] output {vid.shape} min {vid.min():.4f} max "
        f"{vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"14B output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("14B output frames not finite or outside [0, 1]")
    if launches != want:
        fail(f"the 14B edit launched {launches}, expected {want}")
    vcfg = WanVAEConfig()
    tc, sc = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = cfg14.patch_size
    grid = (2 * cond + ground, geo.height // sc // ph, geo.width // sc // pw)
    L, Lt = grid[0] * grid[1] * grid[2], cfg14.text_len
    flops = dit_step_flops(cfg14, L, Lt)
    steps = [timings[f"step{i}"] for i in range(geo.num_inference_steps)]
    log("[edit 14B] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[edit 14B] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb} GB; launches {launches}; DiT {flops:.3e} FLOP/step, "
        f"{flops / statistics.median(steps) / 1e12:.1f} TFLOP/s (median "
        f"step)")
    latents = out.latents
    del out, vid
    # one DiT step of the edit's geometry under torch.profiler
    x = torch.randn(1, cfg14.in_dim, grid[0], geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(bf16)
    ctx = torch.randn(1, Lt, cfg14.text_dim, generator=gen, device=dev
                      ).to(bf16)
    cos, sin = (torch.as_tensor(arr, device=dev) for arr in
                make_rope_for_geometry(cfg14, grid, f_src=cond,
                                       f_ground=ground))
    t = torch.full((1,), 937.0, device=dev)
    prof = None
    if cuda:
        with torch.no_grad():
            prof = profile_kernels(lambda: pipe.dit(x, t, ctx, cos, sin))
        report_profile(f"one 14B DiT step at {L} tokens", *prof)
    log("[edit 14B] " + json.dumps({
        "card": card, "seconds_per_edit": wall, "stages_s": timings,
        "peak_memory_gb": peak_gb, "dit_flop_per_step": flops,
        "launches": launches, "build_s": build_s,
        "profiled_step": prof and {"wall_ms": prof[0], "busy_ms": prof[1]}}))
    return launches, latents, (fusionx, videocof)


def write_clip(tag, geo):
    """Write CLIP_FRAMES random uint8 frames (seed SEED) at the geometry's
    size as an mp4v clip with cv2, the codec the port's video I/O reads
    with; fails unless cv2 is importable and writes it. Returns its path."""
    import numpy as np
    try:
        import cv2
    except ImportError:
        fail(f"{tag}: cv2 is not importable; the port's video I/O needs it")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    clip = SCRATCH / "clip.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 16,
                             (geo.width, geo.height))
    frames = np.random.default_rng(SEED).integers(
        0, 256, (CLIP_FRAMES, geo.height, geo.width, 3), dtype=np.uint8)
    for fr in frames:
        writer.write(fr)
    writer.release()
    if not clip.exists():
        fail(f"{tag}: cv2 {cv2.__version__} wrote no mp4v clip")
    log(f"[{tag}] cv2 {cv2.__version__}: a {CLIP_FRAMES}-frame "
        f"{geo.height}x{geo.width} mp4v clip")
    return clip


@contextlib.contextmanager
def recorded_loads(**override):
    """Record (the LoRA paths it was handed, the pipeline) of every
    `factory.load_pipeline` call while the block runs; ``override``
    replaces arguments of each call."""
    from videocof_torch import factory
    real, built = factory.load_pipeline, []

    def load_recorded(*a, **kw):
        pipe = real(*a, **{**kw, **override})
        built.append(([p for p, _ in kw.get("lora_paths") or ()], pipe))
        return pipe
    factory.load_pipeline = load_recorded
    try:
        yield built
    finally:
        factory.load_pipeline = real


@contextlib.contextmanager
def b1_calls():
    """Record (batch, Lq, Lk, the key mask or None) of every call of B1's
    wrapper body (`flash_attention._forward_b1`, which launches the kernel on
    a CUDA tensor) while the block runs; the masks are read afterwards, so
    the run is not synchronized per call."""
    from videocof_torch.ops import flash_attention as fa
    real, seen = fa._forward_b1, []

    def spy(q, k, v, kv_mask, scale):
        seen.append((q.shape[0], q.shape[1], k.shape[1], kv_mask))
        return real(q, k, v, kv_mask, scale)
    fa._forward_b1 = spy
    try:
        yield seen
    finally:
        fa._forward_b1 = real


def b1_shapes(seen):
    """{(batch, Lq, Lk, valid keys of each row or None): calls} of a
    `b1_calls` record."""
    shapes = {}
    for B, Lq, Lk, mask in seen:
        key = (B, Lq, Lk, None if mask is None
               else tuple(mask.sum(dim=1).tolist()))
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def check_video(tag, vid, want_shape):
    """Fail unless ``vid`` has ``want_shape`` and finite values in [0, 1]."""
    import numpy as np
    log(f"[{tag}] output {vid.shape} min {vid.min():.4f} max {vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"{tag} output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail(f"{tag} output frames not finite or outside [0, 1]")


def check_launches(tag, launches, want):
    if launches != want:
        fail(f"the {tag} launched {launches}, expected {want}")


def extrapolation_phase(card, pipe, geo, gen, prompt, counters,
                        want_launches):
    """The 4x length-extrapolation edit: a uint8 clip of EXTRAP_FRAMES
    frames (4x the 33-frame clip: 34 latent frames) with 4 reasoning frames,
    4 Flow-UniPC steps, repeat RoPE and RIFLEx (k 6, the default L_test), the
    VAE streamed; the output, the launches (2 x layers x steps of B1 and
    nothing else), stage walls and peak memory; then one DiT step of its
    geometry under torch.profiler. Returns (the clip, the phase's
    record)."""
    import numpy as np
    import torch
    from videocof_torch.models.rope import riflex_angle_table
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.pipeline import latent_frame_count
    launch_counts, reset_launch_counts = counters
    dcfg, dev = pipe.dit.cfg, pipe.device
    cuda = dev.type == "cuda"
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    video = np.random.default_rng(SEED).integers(
        0, 256, (1, 3, EXTRAP_FRAMES, geo.height, geo.width), dtype=np.uint8)
    cond = latent_frame_count(EXTRAP_FRAMES, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = dcfg.patch_size
    grid = (2 * cond + ground, geo.height // sc // ph, geo.width // sc // pw)
    L = grid[0] * grid[1] * grid[2]
    log(f"[4x edit] {EXTRAP_FRAMES} source frames: {grid[0]} latent frames "
        f"({cond} + {ground} + {cond}), {L} DiT tokens; RIFLEx k "
        f"{RIFLEX_K}, L_test 66 (the default)")
    timings = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        out = pipe(video, prompt, source_frames=EXTRAP_FRAMES,
                   reasoning_frames=geo.reasoning_frames,
                   num_inference_steps=geo.num_inference_steps,
                   shift=geo.shift, sampler=geo.sampler, repeat_rope=True,
                   seed=geo.seed, riflex_k=RIFLEX_K, timings=timings)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    shapes = b1_shapes(seen)
    per_layer = dcfg.num_layers * geo.num_inference_steps
    check_video("4x edit", out.videos, (1, 3, 1 + (ground - 1) * tc
                                         + EXTRAP_FRAMES, geo.height,
                                         geo.width))
    check_launches("4x edit", launches, want_launches)
    want_shapes = {(1, L, L, None): per_layer,
                   (1, L, TEXT_TOKENS, None): per_layer}
    if shapes != want_shapes:
        fail(f"the 4x edit's B1 calls {shapes} != {want_shapes}")
    flops = dit_step_flops(dcfg, L, TEXT_TOKENS)
    steps = [timings[f"step{i}"] for i in range(geo.num_inference_steps)]
    log("[4x edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[4x edit] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb} GB; launches {launches}; DiT {flops:.3e} FLOP/step, "
        f"{flops / statistics.median(steps) / 1e12:.1f} TFLOP/s (median "
        f"step)")
    del out
    x = torch.randn(1, dcfg.in_dim, grid[0], geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(pipe.dtype)
    ctx = torch.randn(1, TEXT_TOKENS, dcfg.text_dim, generator=gen,
                      device=dev).to(pipe.dtype)
    table = riflex_angle_table(dcfg.head_dim, RIFLEX_K, 66,
                               max_pos=dcfg.rope_max_pos,
                               theta=dcfg.rope_theta)
    cos, sin = (torch.as_tensor(a, device=dev) for a in make_rope_for_geometry(
        dcfg, grid, f_src=cond, f_ground=ground, temporal_table=table))
    t = torch.full((1,), 937.0, device=dev)
    prof = None
    if cuda:
        with torch.no_grad():
            prof = profile_kernels(lambda: pipe.dit(x, t, ctx, cos, sin))
        report_profile(f"one DiT step of the 4x edit at {L} tokens", *prof)
    record = {"card": card, "tokens": L, "seconds_per_edit": wall,
              "stages_s": timings, "peak_memory_gb": peak_gb,
              "dit_flop_per_step": flops, "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"4x self": shapes.get((1, L, L, None), 0),
                              "4x cross": shapes.get(
                                  (1, L, TEXT_TOKENS, None), 0)},
              "profiled_step": prof and {"wall_ms": prof[0],
                                         "busy_ms": prof[1]}}
    log("[4x edit] " + json.dumps(record))
    return video, record


def ragged_phase(card, pipe, geo, prompt, items, counters, want_launches):
    """The ragged batch: `batch_edit` over two items of different lengths
    (``items``: uint8 clips [1, 3, T_i, H, W]) as one batch of 2, seeds 0
    and 1; the launches (2 x layers x steps of B1 at batch 2, the
    self-attention ones with the batch's key mask, and nothing else),
    seconds and peak memory; each item's final latents against its own
    `pipe()` run with the same seed, so the same noise (relative L2 <=
    RAGGED_REL_TOL). Returns (the phase's record, item 0's own final
    latents)."""
    import numpy as np
    import torch
    from videocof_torch.pipeline import batch_edit, latent_frame_count
    launch_counts, reset_launch_counts = counters
    dcfg, dev = pipe.dit.cfg, pipe.device
    cuda = dev.type == "cuda"
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = dcfg.patch_size
    frames = [v.shape[2] for v in items]
    tokens = [(2 * latent_frame_count(f, tc) + ground) * (geo.height // sc
              // ph) * (geo.width // sc // pw) for f in frames]
    embeds = pipe.encode_prompt([prompt])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        outs = batch_edit(pipe, [v[0] for v in items], frames,
                          [embeds] * len(items),
                          reasoning_frames=geo.reasoning_frames,
                          num_inference_steps=geo.num_inference_steps,
                          shift=geo.shift, sampler=geo.sampler, seeds=[0, 1],
                          output_latents=True)
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    shapes = b1_shapes(seen)
    L = max(tokens)
    per_layer = dcfg.num_layers * geo.num_inference_steps
    want_shapes = {(2, L, L, tuple(tokens)): per_layer,
                   (2, L, TEXT_TOKENS, None): per_layer}
    log(f"[ragged] batch_edit of {frames} source frames ({tokens} tokens) as "
        f"one batch of 2: {wall:.3f} s, peak device memory {peak_gb} GB; "
        f"launches {launches}; B1 calls by (batch, Lq, Lk, valid keys per "
        f"row): {shapes}")
    for i, out in enumerate(outs):
        check_video(f"ragged item {i}", out.videos, (
            1, 3, 1 + (ground - 1) * tc + frames[i], geo.height, geo.width))
    check_launches("ragged batch", launches, want_launches)
    if shapes != want_shapes:
        fail(f"the ragged batch's B1 calls {shapes} != {want_shapes}")
    rels, item_s, refs = [], [], []
    for i, out in enumerate(outs):
        t0 = time.perf_counter()
        refs.append(pipe(items[i], prompt, source_frames=frames[i],
                         reasoning_frames=geo.reasoning_frames,
                         num_inference_steps=geo.num_inference_steps,
                         shift=geo.shift, sampler=geo.sampler, seed=i,
                         output_latents=True).latents)
        item_s.append(time.perf_counter() - t0)
        ref = refs[-1]
        rel = float(np.linalg.norm(out.latents - ref) / np.linalg.norm(ref))
        rels.append(rel)
        log(f"[ragged] item {i} ({frames[i]} frames): final latents against "
            f"its own run, relative L2 {rel:.3e} (tol {RAGGED_REL_TOL}): "
            f"{'ok' if rel <= RAGGED_REL_TOL else 'FAIL'}")
        if not rel <= RAGGED_REL_TOL:
            fail(f"ragged item {i} strays from its own run")
    record = {"card": card, "frames": frames, "tokens": tokens,
              "seconds": wall, "peak_memory_gb": peak_gb,
              "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"ragged self": shapes.get(
                  (2, L, L, tuple(tokens)), 0)},
              "rel_l2_vs_own_run": rels,
              "own_run_s": item_s}
    log("[ragged] " + json.dumps(record))
    return record, refs[0]


def paired_phase(card, pipe, geo, video, prompt, counters, want_launches):
    """The paired edit (``cot=False``): [source | target] latents, no
    reasoning frames, 4 steps; the output and the launches (2 x layers x
    steps of B1, nothing else). Returns the phase's record."""
    import torch
    launch_counts, reset_launch_counts = counters
    cuda = pipe.device.type == "cuda"
    timings = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, source_frames=geo.source_frames,
               num_inference_steps=geo.num_inference_steps, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope, cot=False,
               seed=geo.seed, timings=timings)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    check_video("paired edit", out.videos, (1, 3, geo.source_frames,
                                            geo.height, geo.width))
    if out.ground_videos is not None:
        fail("the paired edit returned reasoning frames")
    check_launches("paired edit", launches, want_launches)
    record = {"card": card, "seconds_per_edit": wall, "stages_s": timings,
              "peak_memory_gb": peak_gb, "launches": launches}
    log("[paired edit] " + json.dumps(record))
    return record


def vae_phase(card, pipe, video, latents, n_edit):
    """The streaming VAE against the whole-sequence VAE on the 4-step
    edit's clip (encode) and final latents (the decode of the edit segment,
    the last ``n_edit`` latent frames). In the pipeline's dtype: seconds
    (the second of two runs each), peak memory above what was allocated
    before, and the uint8 frames of each. The reference is the
    whole-sequence VAE in fp32 (TF32 is off). Fails unless the streamed VAE
    in fp32 equals it (relative L2 of mu and of the decoded frames <=
    VAE_FP32_REL_TOL), and unless the streamed one in the pipeline's dtype
    strays from it by at most VAE_STREAM_FACTOR times the whole-sequence
    one. Returns the phase's record."""
    import copy
    import torch
    from videocof_torch.models import wan_vae_streaming as stream
    cuda = pipe.device.type == "cuda"
    vae, dtype = pipe.vae, pipe.dtype
    x = pipe._prepare_video(video)
    x32 = torch.as_tensor(video, device=pipe.device).float() * (2 / 255) - 1
    z = torch.as_tensor(latents[:, :, -n_edit:], device=pipe.device)

    def run(fn, runs=2):
        """(result, seconds of the last run, its peak GB above the
        start)."""
        for _ in range(runs):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with torch.no_grad():
                res = fn()
            if cuda:
                torch.cuda.synchronize()
            s = time.perf_counter() - t0
        peak = ((torch.cuda.max_memory_allocated() - base) / 1e9 if cuda
                else None)
        return res, s, peak

    def to_u8(y):
        return torch.round(y.float() * 127.5 + 127.5).to(torch.uint8)

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    def levels(a, b):
        d = (a.int() - b.int()).abs()
        return {"mean": d.float().mean().item(), "max": d.max().item(),
                "share_differing": (d > 0).float().mean().item()}

    enc, dec = pipe.vae_encode_chunk, pipe.vae_decode_chunk
    rows = {
        "encode whole": run(lambda: vae.encode(x)[0]),
        "encode streaming": run(lambda: stream.encode_streaming(
            vae, x, chunk_latent=enc)[0]),
        "decode whole": run(lambda: to_u8(vae.decode(z.to(dtype)))),
        "decode streaming": run(lambda: stream.decode_streaming_u8(
            vae, z, chunk_latent=dec, compute_dtype=dtype)),
    }
    ref_vae = copy.deepcopy(vae).float()
    ref = {  # one run each
        "encode whole": run(lambda: ref_vae.encode(x32)[0], 1),
        "encode streaming": run(lambda: stream.encode_streaming(
            ref_vae, x32, chunk_latent=enc)[0], 1),
        "decode whole": run(lambda: ref_vae.decode(z.float()), 1),
        "decode streaming": run(lambda: stream.decode_streaming(
            ref_vae, z.float(), chunk_latent=dec), 1),
    }
    del ref_vae
    mu32, y32 = ref["encode whole"][0], ref["decode whole"][0]
    u8_32 = to_u8(y32)
    fp32 = {"mu_rel_l2": rel(ref["encode streaming"][0], mu32),
            "frames_rel_l2": rel(ref["decode streaming"][0], y32),
            "u8": levels(to_u8(ref["decode streaming"][0]), u8_32)}
    err = {way: {"mu_rel_l2_vs_fp32": rel(rows[f"encode {way}"][0], mu32),
                 "u8_vs_fp32": levels(rows[f"decode {way}"][0], u8_32)}
           for way in ("whole", "streaming")}
    record = {"card": card, "frames": video.shape[2],
              "latent_frames_decoded": z.shape[2], "dtype": str(dtype),
              "mu_rel_l2_streaming_vs_whole": rel(
                  rows["encode streaming"][0], rows["encode whole"][0]),
              "u8_streaming_vs_whole": levels(rows["decode streaming"][0],
                                              rows["decode whole"][0]),
              "fp32_streaming_vs_whole": fp32,
              "vs_fp32_whole": err,
              **{k: {"seconds": s, "peak_gb_above_start": p}
                 for k, (_, s, p) in rows.items()},
              **{f"{k} fp32": {"seconds": s, "peak_gb_above_start": p}
                 for k, (_, s, p) in ref.items()}}
    for k, (_, s, p) in list(rows.items()) + [(f"{k} fp32", v) for k, v in
                                              ref.items()]:
        log(f"[vae] {k}: {s:.3f} s, peak {p} GB above what was allocated")
    log(f"[vae] streaming against whole ({dtype}): mu relative L2 "
        f"{record['mu_rel_l2_streaming_vs_whole']:.3e}; uint8 frames "
        f"{record['u8_streaming_vs_whole']}")
    ok = True
    for key in ("mu_rel_l2", "frames_rel_l2"):
        good = fp32[key] <= VAE_FP32_REL_TOL
        ok = ok and good
        log(f"[vae] fp32 streaming against fp32 whole, {key} {fp32[key]:.3e}"
            f" (tol {VAE_FP32_REL_TOL}): {'ok' if good else 'FAIL'}")
    log(f"[vae] fp32 streaming against fp32 whole, uint8 frames {fp32['u8']}")
    for key, name in (("mu_rel_l2_vs_fp32", "mu relative L2"),
                      ("u8_vs_fp32", "uint8 mean |levels|")):
        w, st = err["whole"][key], err["streaming"][key]
        if isinstance(w, dict):
            w, st = w["mean"], st["mean"]
        good = st <= VAE_STREAM_FACTOR * w
        ok = ok and good
        log(f"[vae] {dtype} against the whole-sequence VAE in fp32, {name}: "
            f"whole {w:.3e}, streaming {st:.3e} (tol {VAE_STREAM_FACTOR} x "
            f"whole): {'ok' if good else 'FAIL'}")
    if not ok:
        fail("the streaming VAE strays from the whole-sequence VAE in fp32")
    log("[vae] " + json.dumps(record))
    return record


def infer_phase(card, geo, prompt, counters):
    """`videocof_torch.cli.infer.main()` in this process with its defaults
    (50 Flow-UniPC steps, guidance 5 against the default negative prompt,
    TeaCache with Wan2.1 T2V 14B's coefficients) on random 1.3B weights
    (the factory's default) and a clip written with cv2; the TeaCache plan
    these weights give, the output and its files, and the launches: 2 x
    layers x computed steps of B1, each at batch 2 (CFG), nothing else.
    Returns the phase's record."""
    import torch
    from videocof_torch.cli import infer
    from videocof_torch.models.teacache import plan_teacache_skips
    from videocof_torch.schedulers import get_scheduler
    launch_counts, reset_launch_counts = counters
    clip, out_dir = write_clip("infer", geo), SCRATCH / "infer_out"
    argv = ["--video_path", str(clip), "--prompt", prompt, "--output_dir",
            str(out_dir), "--random_init", "--repeat_rope", "--height",
            str(geo.height), "--width", str(geo.width), "--seed", str(SEED)]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_loads() as built, b1_calls() as seen:
        arrays = infer.main(argv).get(clip.name)
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if arrays is None or len(built) != 1:
        fail(f"infer.main() edited {arrays is not None} item(s) with "
             f"{len(built)} pipelines")
    pipe = built.pop()[1]
    args = infer.parse_args(argv)
    sched = get_scheduler(args.sampler)
    sched.set_timesteps(args.num_inference_steps, shift=args.shift)
    plan = plan_teacache_skips(pipe.dit, sched.timesteps,
                               infer.generation_kwargs(args)[
                                   "teacache_coefficients"],
                               args.teacache_threshold,
                               args.num_skip_start_steps)
    computed = plan.count(False)
    nl = pipe.dit.cfg.num_layers
    del pipe
    shapes = b1_shapes(seen)
    log(f"[infer] TeaCache plan of these random weights (threshold "
        f"{args.teacache_threshold}, {args.num_skip_start_steps} warm-up "
        f"steps, Wan2.1 T2V 14B's coefficients): {sum(plan)} of "
        f"{len(plan)} steps skipped, "
        + "".join("s" if s else "c" for s in plan)
        + f"; {computed} computed")
    want = dict(dict.fromkeys(launches, 0),
                flash_attention_fwd=2 * nl * computed)
    vid = arrays["reason_edit"]
    check_video("infer", vid, (1, 3, 1 + geo.source_frames, geo.height,
                               geo.width))
    log(f"[infer] {wall:.3f} s (weights drawn, decode, 50-step CFG edit, "
        f"encode); peak {peak_gb} GB; launches {launches}; B1 calls by "
        f"(batch, Lq, Lk, mask): {shapes}")
    check_launches("infer CLI", launches, want)
    if {k[0] for k in shapes} != {2}:
        fail(f"the infer CLI's B1 calls are not all at batch 2: {shapes}")
    files = sorted(p.name for p in out_dir.glob("*"))
    want_files = [f"gen_{clip.stem}{s}" for s in (
        ".mp4", "_compare.mp4", "_info.txt", "_reason_edit.mp4")]
    if files != want_files:
        fail(f"infer files {files}")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    record = {"card": card, "seconds": wall, "peak_memory_gb": peak_gb,
              "launches": launches,
              "teacache_plan": "".join("s" if s else "c" for s in plan),
              "computed_steps": computed, "files": files}
    log("[infer] " + json.dumps(record))
    return record


def profile_dit_step(label, dit, grid, cond, ground, seed):
    """One DiT forward at ``grid`` (the chain-of-frames RoPE of ``cond``
    source and ``ground`` reasoning latent frames) on random bf16 inputs
    under torch.profiler; prints the breakdown and returns (wall ms, busy
    ms)."""
    import torch
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    cfg, dev = dit.cfg, next(dit.parameters()).device
    _, ph, pw = cfg.patch_size
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1, cfg.in_dim, grid[0], grid[1] * ph, grid[2] * pw,
                    generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, TEXT_TOKENS, cfg.text_dim, generator=g,
                      device=dev).to(torch.bfloat16)
    cos, sin = (torch.as_tensor(a, device=dev) for a in make_rope_for_geometry(
        cfg, grid, f_src=cond, f_ground=ground))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        prof = profile_kernels(lambda: dit(x, t, ctx, cos, sin))
    report_profile(f"{label} at {grid[0] * grid[1] * grid[2]} tokens", *prof)
    return {"wall_ms": prof[0], "busy_ms": prof[1]}


def quantized_linears(dit):
    """The linears of ``dit`` that store fp8 weights."""
    import torch
    from videocof_torch.utils.fp8 import is_fp8
    return [m for m in dit.modules()
            if isinstance(m, torch.nn.Linear) and is_fp8(m)]


def fp8_14b_phase(card, cfg14, geo, gen, video, prompt, want_shape,
                  counters, lora_paths, latents_bf16):
    """fp8 weights and runtime LoRA on the Wan2.1 14B: the unmerged draw of
    `factory.load_pipeline("", random_init=True, dit_cfg=cfg14)`, one DiT
    forward on a small latent in bf16, then `quantize_dit_fp8` on the card
    (the DiT's bytes before and after; a block's fp8 weights and scales
    equal bit for bit to the CPU's quantization of its bf16 weights, and
    its dequantized weights to the plain formula); the same forward in fp8
    within JAX's bound (mean |err| < FP8_ERR_REL x mean |base| +
    FP8_ERR_ABS); the edit's two LoRA files attached as runtime adapters
    (`load_runtime_lora`, no leftover); the 4-step edit of ``video``
    (output, 2 x layers x steps of B1 and nothing else, stage walls, peak),
    its final latents against the bf16 merged edit's (``latents_bf16``,
    relative L2, printed); and the dequantization's and the adapters'
    fusion's share of a DiT step (CUDA events). Returns the phase's
    record."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.models import lora
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.utils import fp8
    launch_counts, reset_launch_counts = counters
    dev, bf16 = gen.device, torch.bfloat16
    t0 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=cfg14,
                                 seed=SEED)
    dit = pipe.dit
    before = fp8.fp8_bytes(dit)
    lin = dit.blocks[0].self_attn.q
    w_cpu = lin.weight.detach().cpu()
    # one forward on a small latent (3 x 8 x 8 tokens) in bf16 and in fp8
    grid = (3, 8, 8)
    _, ph, pw = cfg14.patch_size
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    x = torch.randn(1, cfg14.in_dim, grid[0], grid[1] * ph, grid[2] * pw,
                    generator=g, device=dev).to(bf16)
    ctx = torch.randn(1, TEXT_TOKENS, cfg14.text_dim, generator=g,
                      device=dev).to(bf16)
    cos, sin = (torch.as_tensor(a, device=dev)
                for a in make_rope_for_geometry(cfg14, grid))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        base = dit(x, t, ctx, cos, sin).float()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fp8.quantize_dit_fp8(dit)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t1
    after = fp8.fp8_bytes(dit)
    q_cpu, s_cpu = fp8.quantize_weight(w_cpu)
    same_q = (torch.equal(lin.weight.view(torch.uint8).cpu(),
                          q_cpu.view(torch.uint8))
              and torch.equal(lin.weight_scale.cpu(), s_cpu))
    same_deq = torch.equal(fp8.dequantize(lin).cpu(),
                           (q_cpu.float() * s_cpu).to(bf16))
    with torch.no_grad():
        out = dit(x, t, ctx, cos, sin).float()
    err = (out - base).abs().mean().item()
    base_mean = base.abs().mean().item()
    bound = FP8_ERR_REL * base_mean + FP8_ERR_ABS
    fwd_ok = bool(torch.isfinite(out).all()) and err < bound
    n_q = len(quantized_linears(dit))
    log(f"[fp8 14B] built in {t1 - t0:.1f} s, quantized {n_q} linears on the "
        f"card in {quant_s:.2f} s: DiT {before / 1e9:.3f} GB -> "
        f"{after / 1e9:.3f} GB ({after / before:.3f}x); block 0's q weight "
        f"and scale equal to the CPU's quantization bit for bit: "
        f"{'ok' if same_q else 'FAIL'}; dequantized equal to (q.float() * "
        f"scale).to(bf16) bit for bit: {'ok' if same_deq else 'FAIL'}")
    log(f"[fp8 14B] one DiT forward ({grid[0] * grid[1] * grid[2]} tokens), "
        f"fp8 against bf16: mean |err| {err:.4e}, mean |bf16| "
        f"{base_mean:.4e}, bound {bound:.4e} (JAX's test): "
        f"{'ok' if fwd_ok else 'FAIL'}")
    if not (same_q and same_deq):
        fail("fp8 quantization on the card differs from the CPU's")
    if not fwd_ok:
        fail("the fp8 DiT's forward strays from the bf16 one")
    del base, out, x, ctx, cos, sin
    runtime, leftover = lora.load_runtime_lora(
        [(p, 1.0) for p in lora_paths], cfg14)
    if runtime is None or leftover:
        fail(f"the LoRA files gave runtime {runtime is not None}, leftover "
             f"{sorted(leftover)}")
    pipe.set_runtime_lora(runtime)
    ranks = {r.down.shape[0] for b in runtime[0].blocks for m in b.values()
             for r in m.values()}
    log(f"[fp8 14B] runtime adapters from {len(lora_paths)} files: ranks "
        f"{sorted(ranks)} (concatenated), scale {runtime[1]}")
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe(video, prompt, source_frames=geo.source_frames,
               reasoning_frames=geo.reasoning_frames,
               num_inference_steps=geo.num_inference_steps,
               guidance_scale=geo.guidance_scale, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope, cot=geo.cot,
               seed=geo.seed, timings=timings, output_latents=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_video("fp8 14B", res.videos, want_shape)
    want = dict(dict.fromkeys(launches, 0), flash_attention_fwd=(
        2 * cfg14.num_layers * geo.num_inference_steps))
    check_launches("fp8 14B edit", launches, want)
    rel = float(np.linalg.norm(res.latents - latents_bf16)
                / np.linalg.norm(latents_bf16))
    log("[fp8 14B] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[fp8 14B] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb} GB; launches {launches}; final latents against the bf16 "
        f"merged edit's (phase 8): relative L2 {rel:.4e}")
    # the dequantization's and the adapters' fusion's share of a step (each
    # result dropped at once, as a step drops it)
    lins, ad = quantized_linears(dit), runtime[0]

    def dequantize_all():
        for m in lins:
            fp8.dequantize(m)

    def fuse_all():
        for b, a in zip(dit.blocks, ad.blocks):
            lora.fuse_block_adapters(b, a, 1.0)
    deq_ms = cuda_ms(dequantize_all, runs=3)
    fuse_ms = cuda_ms(fuse_all, runs=3)
    step_ms = 1e3 * statistics.median(
        timings[f"step{i}"] for i in range(geo.num_inference_steps))
    log(f"[fp8 14B] dequantizing every fp8 weight once: {deq_ms:.2f} ms "
        f"({deq_ms / step_ms:.1%} of a {step_ms:.1f} ms step); the blocks' "
        f"adapters fused over fp8 (dequantization included, what a step "
        f"runs): {fuse_ms:.2f} ms ({fuse_ms / step_ms:.1%})")
    record = {"card": card, "dit_bytes_bf16": before, "dit_bytes_fp8": after,
              "quantize_s": quant_s, "forward_mean_abs_err": err,
              "forward_bound": bound, "seconds_per_edit": wall,
              "stages_s": timings, "peak_memory_gb": peak_gb,
              "launches": launches, "rel_l2_vs_bf16_merged": rel,
              "dequant_ms": deq_ms, "fuse_ms": fuse_ms, "step_ms": step_ms}
    log("[fp8 14B] " + json.dumps(record))
    del pipe, dit, runtime, ad, lins, res
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    return record


def a14b_pipeline(gen):
    """The Wan2.2 A14B on the card at full width and depth: umT5-XXL and
    the Wan2.1 VAE from ``gen``, then the two WAN22_T2V_A14B experts from
    seeds SEED + 1 (base) and SEED + 2 (high noise), each quantized to fp8
    as soon as it is drawn, so at most one bf16 expert is ever resident.
    Returns (the `Wan22Pipeline`, build seconds, the build's peak GB)."""
    import torch
    from videocof_torch.configs import (T5Config, WAN22_T2V_A14B,
                                        WanVAEConfig)
    from videocof_torch.models.t5_encoder import init_t5_encoder
    from videocof_torch.models.wan_dit import init_wan_dit
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.pipeline import Wan22Pipeline
    from videocof_torch.utils.fp8 import quantize_dit_fp8
    dev, bf16 = gen.device, torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t5 = init_t5_encoder(T5Config(), gen, bf16, dev)
    vae = init_wan_vae(WanVAEConfig(), gen, bf16, dev)
    experts = []
    for seed in (SEED + 1, SEED + 2):
        g = torch.Generator(device=dev).manual_seed(seed)
        experts.append(quantize_dit_fp8(init_wan_dit(WAN22_T2V_A14B, g, bf16,
                                                     dev)))
        torch.cuda.empty_cache()
    pipe = Wan22Pipeline(experts[0], vae, t5, dtype=bf16, dit_2=experts[1])
    torch.cuda.synchronize()
    return (pipe, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9)


def a14b_tokens(pipe, geo, frames, reasoning_frames=None):
    """DiT tokens of ``frames`` source frames (with ``reasoning_frames``:
    the chain-of-frames latents, source twice and the reasoning frames) at
    the geometry's size."""
    from videocof_torch.pipeline import latent_frame_count
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    _, ph, pw = pipe.dit.cfg.patch_size
    n = latent_frame_count(frames, tc)
    if reasoning_frames is not None:
        n = 2 * n + latent_frame_count(reasoning_frames, tc)
    return n * (geo.height // sc // ph) * (geo.width // sc // pw)


@contextlib.contextmanager
def expert_forwards(pipe):
    """Count each expert's DiT forwards (a pre-hook on its first block)."""
    calls = {"dit": 0, "dit_2": 0}
    hooks = [getattr(pipe, n).blocks[0].register_forward_pre_hook(
        lambda *_, n=n: calls.__setitem__(n, calls[n] + 1)) for n in calls]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def a14b_edit_phase(card, geo, gen, video, prompt, want_shape, counters):
    """The Wan2.2 A14B dual-expert chain-of-frames edit (`a14b_pipeline`):
    the 480x832 33 + 4-frame edit of ``video`` in A14B_STEPS Flow-UniPC
    steps at shift A14B_SHIFT, guidance 1; ``split_idx`` (the leading
    high-noise steps, 0 < split < steps), each expert's forwards, exactly
    2 x layers x steps B1 calls (self and cross at the 40 heads) and
    nothing else, stage walls, and the peak below the card's memory.
    Returns (the pipeline, the phase's record)."""
    import torch
    from videocof_torch.pipeline import latent_frame_count
    from videocof_torch.schedulers import get_scheduler
    launch_counts, reset_launch_counts = counters
    pipe, build_s, build_peak = a14b_pipeline(gen)
    dcfg = pipe.dit.cfg
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    sched = get_scheduler(geo.sampler)
    sched.set_timesteps(A14B_STEPS, shift=A14B_SHIFT)
    split = pipe._split_idx(sched)
    log(f"[A14B edit] two fp8 experts, umT5-XXL and the VAE built in "
        f"{build_s:.1f} s, peak {build_peak:.2f} GB while building; "
        f"timesteps {[round(float(t), 1) for t in sched.timesteps]} at shift "
        f"{A14B_SHIFT}, boundary {pipe.boundary * pipe.num_train_timesteps}: "
        f"split_idx {split}")
    if not 0 < split < A14B_STEPS:
        fail(f"split_idx {split}: the edit would run one expert only")
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen, expert_forwards(pipe) as calls:
        out = pipe(video, prompt, source_frames=geo.source_frames,
                   reasoning_frames=geo.reasoning_frames,
                   num_inference_steps=A14B_STEPS, guidance_scale=1.0,
                   shift=A14B_SHIFT, sampler=geo.sampler,
                   repeat_rope=geo.repeat_rope, seed=geo.seed,
                   timings=timings)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = b1_shapes(seen)
    check_video("A14B edit", out.videos, want_shape)
    per = dcfg.num_layers * A14B_STEPS
    check_launches("A14B edit", launches, dict(
        dict.fromkeys(launches, 0), flash_attention_fwd=2 * per))
    L = a14b_tokens(pipe, geo, geo.source_frames, geo.reasoning_frames)
    want_shapes = {(1, L, L, None): per, (1, L, TEXT_TOKENS, None): per}
    log("[A14B edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[A14B edit] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb:.2f} GB of {total_gb:.2f} GB; DiT forwards: base expert "
        f"{calls['dit']}, high-noise expert {calls['dit_2']}; B1 calls by "
        f"(batch, Lq, Lk, mask): {shapes}")
    if calls != {"dit": A14B_STEPS - split, "dit_2": split}:
        fail(f"the experts ran {calls}, expected {split} high-noise and "
             f"{A14B_STEPS - split} base forwards")
    if shapes != want_shapes:
        fail(f"the A14B edit's B1 calls {shapes} != {want_shapes}")
    if not peak_gb < total_gb:
        fail(f"the A14B edit peaked at {peak_gb} GB")
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    _, ph, pw = dcfg.patch_size
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    prof = profile_dit_step(
        "one fp8 A14B expert step", pipe.dit,
        (2 * cond + ground, geo.height // sc // ph, geo.width // sc // pw),
        cond, ground, SEED + 15)
    record = {"card": card, "split_idx": split, "forwards": calls,
              "build_s": build_s, "build_peak_gb": build_peak,
              "seconds_per_edit": wall, "stages_s": timings,
              "peak_memory_gb": peak_gb, "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "profiled_step": prof}
    log("[A14B edit] " + json.dumps(record))
    return pipe, record


def a14b_t2v_phase(card, pipe, geo, prompt, counters):
    """A14B text-to-video (`Wan22Pipeline.text_to_video`) at 480x832 with
    T2V_FRAMES frames (JAX's default: 21 latent frames, 32,760 tokens) in
    A14B_STEPS steps, guidance T2V_GUIDANCE against the default negative
    prompt and T2V_GUIDANCE_2 on the high-noise steps, batched CFG (batch
    2): the output, each expert's forwards, exactly 2 x layers x steps B1
    calls at batch 2 and nothing else, stage walls and peak. Returns the
    phase's record."""
    import torch
    launch_counts, reset_launch_counts = counters
    dcfg = pipe.dit.cfg
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen, expert_forwards(pipe) as calls:
        out = pipe.text_to_video(
            prompt, negative_prompt=geo.negative_prompt, height=geo.height,
            width=geo.width, num_frames=T2V_FRAMES,
            num_inference_steps=A14B_STEPS, guidance_scale=T2V_GUIDANCE,
            guidance_scale_2=T2V_GUIDANCE_2, shift=A14B_SHIFT, seed=geo.seed,
            timings=timings)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = b1_shapes(seen)
    check_video("A14B t2v", out.videos, (1, 3, T2V_FRAMES, geo.height,
                                         geo.width))
    per = dcfg.num_layers * A14B_STEPS
    check_launches("A14B t2v", launches, dict(
        dict.fromkeys(launches, 0), flash_attention_fwd=2 * per))
    L = a14b_tokens(pipe, geo, T2V_FRAMES)
    want_shapes = {(2, L, L, None): per, (2, L, TEXT_TOKENS, None): per}
    log("[A14B t2v] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[A14B t2v] {T2V_FRAMES} frames, {L} tokens: {wall:.3f} s; peak "
        f"device memory {peak_gb:.2f} GB; forwards {calls}; B1 calls by "
        f"(batch, Lq, Lk, mask): {shapes}")
    if shapes != want_shapes:
        fail(f"the A14B t2v's B1 calls {shapes} != {want_shapes}")
    record = {"card": card, "tokens": L, "seconds": wall,
              "stages_s": timings, "peak_memory_gb": peak_gb,
              "launches": launches, "forwards": calls,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"A14B t2v self": shapes.get((2, L, L, None), 0),
                              "A14B t2v cross": shapes.get(
                                  (2, L, TEXT_TOKENS, None), 0)}}
    log("[A14B t2v] " + json.dumps(record))
    return record


def ti2v_phase(card, geo, prompt, counters):
    """The TI2V-5B with the Wan2.2 VAE: `factory.load_pipeline("",
    random_init=True, dit_cfg=WAN22_TI2V_5B, vae_cfg=Wan22VAEConfig())` in
    bf16 edits a 33 + 4-frame clip at TI2V_HW (19 latent frames of 44 x 80,
    16,720 tokens) in 4 steps at shift A14B_SHIFT: output, 2 x layers x
    steps B1 calls at the 24 heads and nothing else, stage walls, peak. Then
    the streaming Wan2.2 VAE against the whole-sequence one, with the DiT
    and umT5 freed: in bf16 on the source clip (encode) and the edit's last
    9 latent frames (decode to uint8): seconds, peak above the start, mu's
    relative L2 and the uint8 difference; and, as for Wan2.1 (phase 12),
    against the whole-sequence VAE in fp32 (TF32 off) on the clip's first
    9 frames (3 latent frames: the 33-frame fp32 decode would not fit
    beside its activations): the streamed VAE in fp32 within
    VAE_FP32_REL_TOL relative L2 (mu, frames), the streamed one in bf16 no
    further than VAE_STREAM_FACTOR x the whole one. Returns (the phase's
    record)."""
    import copy
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.configs import WAN22_TI2V_5B, Wan22VAEConfig
    from videocof_torch.models import wan_vae22_streaming as stream
    from videocof_torch.pipeline import latent_frame_count
    launch_counts, reset_launch_counts = counters
    height, width = TI2V_HW
    t0 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=WAN22_TI2V_5B,
                                 vae_cfg=Wan22VAEConfig(), seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    vcfg, dcfg = pipe.vae.cfg, pipe.dit.cfg
    tc, sc = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    video = np.random.default_rng(SEED).integers(
        0, 256, (1, 3, geo.source_frames, height, width), dtype=np.uint8)
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = dcfg.patch_size
    L = (2 * cond + ground) * (height // sc // ph) * (width // sc // pw)
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        out = pipe(video, prompt, source_frames=geo.source_frames,
                   reasoning_frames=geo.reasoning_frames,
                   num_inference_steps=geo.num_inference_steps,
                   shift=A14B_SHIFT, sampler=geo.sampler,
                   repeat_rope=geo.repeat_rope, seed=geo.seed,
                   timings=timings, output_latents=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = b1_shapes(seen)
    check_video("TI2V-5B edit", out.videos, (
        1, 3, 1 + (ground - 1) * tc + geo.source_frames, height, width))
    per = dcfg.num_layers * geo.num_inference_steps
    check_launches("TI2V-5B edit", launches, dict(
        dict.fromkeys(launches, 0), flash_attention_fwd=2 * per))
    want_shapes = {(1, L, L, None): per, (1, L, TEXT_TOKENS, None): per}
    log(f"[TI2V-5B] built in {build_s:.1f} s; {2 * cond + ground} latent "
        f"frames of {height // sc} x {width // sc}, {L} tokens, "
        f"{dcfg.num_heads} heads of {dcfg.head_dim}")
    log("[TI2V-5B] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[TI2V-5B] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb:.2f} GB; launches {launches}; B1 calls by (batch, Lq, Lk, "
        f"mask): {shapes}")
    if shapes != want_shapes:
        fail(f"the TI2V-5B edit's B1 calls {shapes} != {want_shapes}")
    prof = profile_dit_step(
        "one TI2V-5B step", pipe.dit,
        (2 * cond + ground, height // sc // ph, width // sc // pw), cond,
        ground, SEED + 17)
    record = {"card": card, "tokens": L, "build_s": build_s,
              "seconds_per_edit": wall, "stages_s": timings,
              "peak_memory_gb": peak_gb, "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"5B self": shapes.get((1, L, L, None), 0),
                              "5B cross": shapes.get(
                                  (1, L, TEXT_TOKENS, None), 0)},
              "profiled_step": prof}
    # the VAE alone: the DiT and umT5 leave the card
    vae, dtype, dev = pipe.vae, pipe.dtype, pipe.device
    enc, dec = pipe.vae_encode_chunk, pipe.vae_decode_chunk
    x = pipe._prepare_video(video)
    z = torch.as_tensor(out.latents[:, :, -cond:], device=dev)
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()

    def run(fn, runs=2):
        for _ in range(runs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with torch.no_grad():
                res = fn()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        return res, s, (torch.cuda.max_memory_allocated() - start) / 1e9

    def to_u8(y):
        return torch.round(y.float() * 127.5 + 127.5).to(torch.uint8)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def levels(a, b):
        d = (a.int() - b.int()).abs()
        return {"mean": d.float().mean().item(), "max": d.max().item(),
                "share_differing": (d > 0).float().mean().item()}

    rows = {
        "encode whole": run(lambda: vae.encode(x)[0]),
        "encode streaming": run(lambda: stream.encode_streaming(
            vae, x, chunk_latent=enc)[0]),
        "decode whole": run(lambda: to_u8(vae.decode(z.to(dtype)))),
        "decode streaming": run(lambda: stream.decode_streaming_u8(
            vae, z, chunk_latent=dec, compute_dtype=dtype)),
    }
    mu_rel = rel(rows["encode streaming"][0], rows["encode whole"][0])
    u8 = levels(rows["decode streaming"][0], rows["decode whole"][0])
    for k, (_, s, p) in rows.items():
        log(f"[TI2V-5B vae] {k} ({geo.source_frames} frames, {dtype}): "
            f"{s:.3f} s, peak {p:.2f} GB above what was allocated")
    log(f"[TI2V-5B vae] streaming against whole ({dtype}): mu relative L2 "
        f"{mu_rel:.3e}; uint8 frames {u8}")
    walls = {k: {"seconds": s, "peak_gb_above_start": p}
             for k, (_, s, p) in rows.items()}
    del rows
    torch.cuda.empty_cache()
    # against the whole-sequence VAE in fp32 on the clip's first 9 frames
    x9, z3 = x[:, :, :9], z[:, :, :3]
    x9_32 = torch.as_tensor(video[:, :, :9], device=dev).float() * (2 / 255) - 1
    small = {
        "encode whole": run(lambda: vae.encode(x9)[0], 1),
        "encode streaming": run(lambda: stream.encode_streaming(
            vae, x9, chunk_latent=enc)[0], 1),
        "decode whole": run(lambda: to_u8(vae.decode(z3.to(dtype))), 1),
        "decode streaming": run(lambda: stream.decode_streaming_u8(
            vae, z3, chunk_latent=dec, compute_dtype=dtype), 1)}
    ref_vae = copy.deepcopy(vae).float()
    ref = {"encode whole": run(lambda: ref_vae.encode(x9_32)[0], 1),
           "encode streaming": run(lambda: stream.encode_streaming(
               ref_vae, x9_32, chunk_latent=enc)[0], 1),
           "decode whole": run(lambda: ref_vae.decode(z3.float()), 1),
           "decode streaming": run(lambda: stream.decode_streaming(
               ref_vae, z3.float(), chunk_latent=dec), 1)}
    del ref_vae
    mu32, y32 = ref["encode whole"][0], ref["decode whole"][0]
    fp32 = {"mu_rel_l2": rel(ref["encode streaming"][0], mu32),
            "frames_rel_l2": rel(ref["decode streaming"][0], y32)}
    err = {way: {"mu_rel_l2_vs_fp32": rel(small[f"encode {way}"][0], mu32),
                 "u8_vs_fp32": levels(small[f"decode {way}"][0],
                                      to_u8(y32))["mean"]}
           for way in ("whole", "streaming")}
    ok = True
    for key, v in fp32.items():
        good = v <= VAE_FP32_REL_TOL
        ok = ok and good
        log(f"[TI2V-5B vae] fp32 streaming against fp32 whole (9 frames), "
            f"{key} {v:.3e} (tol {VAE_FP32_REL_TOL}): "
            f"{'ok' if good else 'FAIL'}")
    for key in ("mu_rel_l2_vs_fp32", "u8_vs_fp32"):
        w, st = err["whole"][key], err["streaming"][key]
        good = st <= VAE_STREAM_FACTOR * w
        ok = ok and good
        log(f"[TI2V-5B vae] {dtype} against the whole-sequence VAE in fp32 "
            f"(9 frames), {key}: whole {w:.3e}, streaming {st:.3e} (tol "
            f"{VAE_STREAM_FACTOR} x whole): {'ok' if good else 'FAIL'}")
    if not ok:
        fail("the streaming Wan2.2 VAE strays from the whole-sequence VAE")
    record["vae"] = {"mu_rel_l2_streaming_vs_whole": mu_rel,
                     "u8_streaming_vs_whole": u8, "fp32_9_frames": fp32,
                     "vs_fp32_whole_9_frames": err, **walls}
    log("[TI2V-5B] " + json.dumps(record))
    return record


def wan22_entries_phase(card, geo, gen, prompt, counters):
    """The entries on a Wan2.2 checkpoint directory: a published-layout
    A14B MoE directory (`save_wan_checkpoint_dir`: two WAN22_T2V_A14B
    experts at full width and ENTRY22_LAYERS layers each, the Wan2.1 VAE,
    umT5-XXL) read back by `fast_infer.main([... "--quantize", "fp8"])`
    (the 4-step edit of a cv2 clip at shift A14B_SHIFT) and by
    `infer.main([... "--t2v", "--quantize", "fp8", "--guidance_scale_2",
    ...])` (its defaults: 50 steps, CFG 5; 65 frames); each must build a
    `Wan22Pipeline` whose experts hold fp8 weights, write its files and
    launch B1 2 x layers x steps times (batch 2 under CFG) and nothing
    else. The directory has no tokenizer files, so the factory is handed
    ``require_real_tokenizer=False`` (the hash tokenizer). Returns the
    phase's record."""
    import torch
    from videocof_torch.cli import fast_infer, infer
    from videocof_torch.configs import T5Config, WAN22_T2V_A14B, WanVAEConfig
    from videocof_torch.models.t5_encoder import init_t5_encoder
    from videocof_torch.models.wan_dit import init_wan_dit
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.pipeline import Wan22Pipeline
    from videocof_torch.utils import checkpoint, video_io
    from videocof_torch.utils.fp8 import is_fp8
    launch_counts, reset_launch_counts = counters
    dev, bf16 = gen.device, torch.bfloat16
    # the directory has no tokenizer files: look for none anywhere else
    os.environ["HF_HUB_OFFLINE"] = "1"
    cfg = WAN22_T2V_A14B.replace(num_layers=ENTRY22_LAYERS)
    root = SCRATCH / "wan22_a14b"
    t0 = time.perf_counter()
    t5 = init_t5_encoder(T5Config(), gen, bf16, dev)
    vae = init_wan_vae(WanVAEConfig(), gen, bf16, dev)
    d1, d2 = (init_wan_dit(cfg, torch.Generator(device=dev).manual_seed(s),
                           bf16, dev) for s in (SEED + 3, SEED + 4))
    nbytes = checkpoint.save_wan_checkpoint_dir(str(root), d1, vae, t5,
                                                dit_2=d2)
    write_s = time.perf_counter() - t0
    del t5, vae, d1, d2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[entry 2.2] a Wan2.2 A14B directory ({ENTRY22_LAYERS} layers per "
        f"expert, full width) written in {write_s:.1f} s, {nbytes / 1e9:.2f} "
        f"GB: {sorted(p.name for p in root.iterdir())}")
    clip = write_clip("entry 2.2", geo)
    records = {}
    runs = {
        "fast_infer": (fast_infer, [
            "--video_path", str(clip), "--prompt", prompt,
            "--source_frames", str(geo.source_frames), "--reasoning_frames",
            str(geo.reasoning_frames), "--num_inference_steps",
            str(geo.num_inference_steps), "--repeat_rope"],
            2 * ENTRY22_LAYERS * geo.num_inference_steps, 1),
        "infer": (infer, ["--t2v", "--prompt", prompt, "--guidance_scale_2",
                          str(T2V_GUIDANCE_2)],
                  2 * ENTRY22_LAYERS * 50, 2),
    }
    for name, (cli, extra, want_b1, batch) in runs.items():
        out_dir = SCRATCH / f"{name}_out"
        argv = ["--model_name", str(root), "--output_dir", str(out_dir),
                "--quantize", "fp8", "--shift", str(A14B_SHIFT), "--height",
                str(geo.height), "--width", str(geo.width), "--seed",
                str(SEED)] + extra
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_loads(require_real_tokenizer=False) as built, \
                b1_calls() as seen:
            arrays = cli.main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(built) != 1 or len(arrays) != 1:
            fail(f"{name} built {len(built)} pipelines and wrote "
                 f"{len(arrays)} items")
        pipe = built.pop()[1]
        fp8_ok = isinstance(pipe, Wan22Pipeline) and all(
            is_fp8(d.blocks[0].self_attn.q) and is_fp8(d.blocks[-1].ffn.fc2)
            for d in (pipe.dit, pipe.dit_2))
        del pipe
        files = sorted(p.name for p in out_dir.glob("*"))
        shapes = b1_shapes(seen)
        # the item's own video (not the reason+edit or side-by-side ones)
        mp4 = out_dir / next(f for f in files if f.endswith(".mp4") and not
                             f.endswith(("_compare.mp4", "_reason_edit.mp4")))
        info = video_io.video_info(str(mp4))
        log(f"[entry 2.2] {name}.main({' '.join(argv[4:])}): {wall:.3f} s, "
            f"peak {peak_gb:.2f} GB; a Wan22Pipeline with fp8 experts: "
            f"{'ok' if fp8_ok else 'FAIL'}; files {files}; {mp4.name}: "
            f"{info[0]} frames of {info[1]}x{info[2]}; launches {launches}; "
            f"B1 calls by (batch, Lq, Lk, mask): {shapes}")
        if not fp8_ok:
            fail(f"{name} did not build a Wan22Pipeline with fp8 experts")
        check_launches(f"{name} on Wan2.2", launches, dict(
            dict.fromkeys(launches, 0), flash_attention_fwd=want_b1))
        if {k[0] for k in shapes} != {batch}:
            fail(f"{name}'s B1 calls are not all at batch {batch}: {shapes}")
        if not files or info[1:3] != (geo.height, geo.width):
            fail(f"{name} wrote {files}, {info}")
        records[name] = {"seconds": wall, "peak_memory_gb": peak_gb,
                         "launches": launches, "files": files}
    shutil.rmtree(SCRATCH, ignore_errors=True)
    record = {"card": card, "write_s": write_s, "bytes": nbytes, **records}
    log("[entry 2.2] " + json.dumps(record))
    return record


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from videocof_torch.configs import (GenerationConfig, T5Config,
                                        WAN21_T2V_14B, WAN21_T2V_1_3B,
                                        WAN22_T2V_A14B, WAN22_TI2V_5B,
                                        Wan22VAEConfig, WanVAEConfig)
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
    log("[env] " + json.dumps(environment()))
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
    N, D, Lt = dcfg.num_heads, dcfg.head_dim, TEXT_TOKENS
    log(f"[geometry] {latent_frames} latent frames, {L} DiT tokens, "
        f"{N} heads of {D}")
    # the 4x edit's tokens, and the ragged batch's two rows (the 4-step
    # edit's clip and a RAGGED_FRAMES one)
    per_frame = (geo.height // sc // ph) * (geo.width // sc // pw)
    L4 = (2 * latent_frame_count(EXTRAP_FRAMES, tc) + ground) * per_frame
    ragged = (L, (2 * latent_frame_count(RAGGED_FRAMES, tc) + ground)
              * per_frame)
    log(f"[geometry] 4x edit ({EXTRAP_FRAMES} frames): {L4} DiT tokens; "
        f"ragged batch ({geo.source_frames} and {RAGGED_FRAMES} frames): "
        f"{ragged} tokens")
    # B1's shapes on the 4x edit and the ragged batch: (batch, Lq, Lk),
    # the valid keys of each row (None: no mask)
    new_b1 = {"4x self": ((1, L4, L4), None),
              "4x cross": ((1, L4, Lt), None),
              "ragged self": ((2, ragged[1], ragged[1]), ragged)}
    # B1's shapes on the Wan2.2 paths: (batch, Lq, Lk), heads
    v22 = Wan22VAEConfig()
    L5 = ((2 * latent_frame_count(geo.source_frames, tc) + ground)
          * (TI2V_HW[0] // v22.spatial_compression_ratio // ph)
          * (TI2V_HW[1] // v22.spatial_compression_ratio // pw))
    Lt2v = latent_frame_count(T2V_FRAMES, tc) * per_frame
    b1_22 = {"5B self": ((1, L5, L5), WAN22_TI2V_5B.num_heads),
             "5B cross": ((1, L5, Lt), WAN22_TI2V_5B.num_heads),
             "A14B t2v self": ((2, Lt2v, Lt2v), WAN22_T2V_A14B.num_heads),
             "A14B t2v cross": ((2, Lt2v, Lt), WAN22_T2V_A14B.num_heads)}
    log(f"[geometry] TI2V-5B edit at {TI2V_HW[0]}x{TI2V_HW[1]}: {L5} DiT "
        f"tokens; A14B text-to-video, {T2V_FRAMES} frames: {Lt2v} tokens")

    def ragged_mask(lengths, Lk):
        if lengths is None:
            return None
        return (torch.arange(Lk, device=dev)[None]
                < torch.tensor(lengths, device=dev)[:, None])

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
    # B1 at the 14B's 40 heads of 128, at the self and cross shapes of its
    # edit (the plain version chunks its rows: its logits stay near 1 GiB)
    N14 = WAN21_T2V_14B.num_heads
    err14 = {}
    for shape_name, (B, Lq, Lk) in (("self", (1, L, L)), ("cross", (1, L, Lt))):
        q, k, v = qkv(B, Lq, Lk, N14, D)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err14[shape_name] = compare(
            f"B1 {shape_name}-attention at the 14B's {N14} heads "
            f"{(B, Lq, Lk, N14, D)} bfloat16", out,
            fa.flash_attention_reference(q, k, v))
        note("flash_attention_fwd", err14[shape_name])
        del q, k, v, out
    # B1 at the 4x edit's and the ragged batch's shapes (the plain version
    # takes its q rows in chunks, so it holds the kernel against all keys
    # at 107,640 tokens too)
    err_new = {}
    for label, ((B, Lq, Lk), lengths) in new_b1.items():
        q, k, v = qkv(B, Lq, Lk, N, D)
        mask = ragged_mask(lengths, Lk)
        out = fa.flash_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        err_new[label] = compare(
            f"B1 {label} {(B, Lq, Lk, N, D)} bfloat16"
            + (f", row keys {lengths}" if lengths else ""), out,
            fa.flash_attention_reference(q, k, v, kv_mask=mask))
        note("flash_attention_fwd", err_new[label])
        del q, k, v, out, mask
        torch.cuda.empty_cache()
    # B1 at the Wan2.2 paths' shapes: the TI2V-5B's 24 heads at its 704x1280
    # edit (16,720 tokens), the A14B's 40 heads at text-to-video's 81
    # frames under batched CFG (batch 2, 32,760 tokens)
    err22 = {}
    for label, ((B, Lq, Lk), Nh) in b1_22.items():
        q, k, v = qkv(B, Lq, Lk, Nh, D)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err22[label] = compare(f"B1 {label} {(B, Lq, Lk, Nh, D)} bfloat16",
                               out, fa.flash_attention_reference(q, k, v))
        note("flash_attention_fwd", err22[label])
        del q, k, v, out
        torch.cuda.empty_cache()
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

    # B1 at the 14B's 40 heads: kernel, plain version, SDPA and the bound
    timing14 = {}
    for shape_name, (B, Lq, Lk), plain_runs in (("self", (1, L, L), 3),
                                                ("cross", (1, L, Lt), 10)):
        q, k, v = qkv(B, Lq, Lk, N14, D)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        work = kernel_work(B, Lq, Lk, N14, D)["flash_attention_fwd"]
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), runs=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v),
                           runs=plain_runs, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt), runs=10)
        bound_ms, bound_by = bound(*work)
        shape = f"B={B} Lq={Lq} Lk={Lk} N={N14} D={D} bf16"
        timing14[shape_name] = dict(
            shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
            tflops=work[0] / ms / 1e9,
            max_abs_err=err14[shape_name][0],
            max_rel_l2_err=err14[shape_name][1])
        log(f"[timing] flash_attention_fwd {shape_name} at the 14B's heads "
            f"{shape}: kernel_ms {ms:.4f} bound_ms {bound_ms:.4f} "
            f"({bound_by}) plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} (share of bound {bound_ms / ms:.1%}; "
            f"{work[0] / ms / 1e9:.1f} TFLOP/s, library "
            f"{work[0] / library_ms / 1e9:.1f})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # B1 at the 4x edit's and the ragged batch's shapes; the ragged shape's
    # bound twice: the work the kernel does (both rows at full length) and
    # the work the rows need (each at its own length: what packing would
    # do); SDPA's memory-efficient backend takes the key mask
    from torch.nn.attention import SDPBackend, sdpa_kernel
    timing_new = {}
    for label, ((B, Lq, Lk), lengths) in new_b1.items():
        q, k, v = qkv(B, Lq, Lk, N, D)
        mask = ragged_mask(lengths, Lk)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_mask=mask),
                     runs=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, kv_mask=mask), runs=1 if Lk > 1000 else 5, warmup=0)
        if mask is None:
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt), runs=10)
        else:
            bias = mask[:, None, None, :]
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias), runs=10)
        flops, nbytes = kernel_work(B, Lq, Lk, N, D)["flash_attention_fwd"]
        mask_bytes = 0 if mask is None else mask.numel()
        row = dict(shape=f"B={B} Lq={Lq} Lk={Lk} N={N} D={D} bf16"
                   + (f" row keys {list(lengths)}" if lengths else ""),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   max_abs_err=err_new[label][0],
                   max_rel_l2_err=err_new[label][1])
        padded_ms, _ = bound(flops, nbytes + mask_bytes)
        if lengths:   # the rows' own work is what this data needs
            works = [kernel_work(1, n, n, N, D)["flash_attention_fwd"]
                     for n in lengths]
            flops = sum(w[0] for w in works)
            nbytes = sum(w[1] for w in works)
            row["bound_ms_padded"] = padded_ms
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes + mask_bytes)
        timing_new[label] = row
        log(f"[timing] flash_attention_fwd {label} {row['shape']}: kernel_ms "
            f"{ms:.4f} bound_ms {row['bound_ms']:.4f} ({row['bound_by']})"
            + (f", bound of the padded work {padded_ms:.4f}" if lengths
               else "")
            + f" plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (share "
            f"of bound {row['bound_ms'] / ms:.1%}; {flops / ms / 1e9:.1f} "
            f"TFLOP/s of the rows' work, library "
            f"{flops / library_ms / 1e9:.1f})")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()

    # B1 at the Wan2.2 paths' shapes: kernel, plain version, SDPA, bound
    timing22 = {}
    for label, ((B, Lq, Lk), Nh) in b1_22.items():
        q, k, v = qkv(B, Lq, Lk, Nh, D)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        work = kernel_work(B, Lq, Lk, Nh, D)["flash_attention_fwd"]
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), runs=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v),
                           runs=1 if Lk > 1000 else 5, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt), runs=10)
        bound_ms, bound_by = bound(*work)
        timing22[label] = dict(
            shape=f"B={B} Lq={Lq} Lk={Lk} N={Nh} D={D} bf16", ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, tflops=work[0] / ms / 1e9,
            max_abs_err=err22[label][0], max_rel_l2_err=err22[label][1])
        log(f"[timing] flash_attention_fwd {label} "
            f"{timing22[label]['shape']}: kernel_ms {ms:.4f} bound_ms "
            f"{bound_ms:.4f} ({bound_by}) plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} (share of bound {bound_ms / ms:.1%}"
            f"; {work[0] / ms / 1e9:.1f} TFLOP/s, library "
            f"{work[0] / library_ms / 1e9:.1f})")
        del q, k, v, qt, kt, vt
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

    # ------------------------------------------------ 7. the entry at 1.3B
    shutil.rmtree(SCRATCH, ignore_errors=True)
    read_gbps = round_trip_phase(dit)
    del trainer, dit, vae, t5, samples
    gc.collect()
    torch.cuda.empty_cache()
    counters = (launch_counts, reset_launch_counts)
    entry = entry_phase(card, dcfg, geo, gen, prompt, want_shape,
                        want_launches, counters)
    log("[entry] " + json.dumps(dict(entry, dit_read_gb_per_s=read_gbps)))

    # ------------------------------------------------------ 8. the 14B edit
    launches14, latents14, lora14 = edit_14b_phase(
        card, WAN21_T2V_14B, geo, gen, video, prompt, want_shape,
        want_launches, counters)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------- 9-12. the long and ragged paths
    # on random 1.3B weights drawn by the factory from the seed
    from videocof_torch import factory
    t0 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, seed=SEED)
    torch.cuda.synchronize()
    log(f"[1.3B] factory.load_pipeline(random_init=True): "
        f"{time.perf_counter() - t0:.1f} s")
    video4, rec_4x = extrapolation_phase(card, pipe, geo, gen, prompt,
                                         counters, want_launches)
    rec_ragged, latents0 = ragged_phase(
        card, pipe, geo, prompt, [video, video4[:, :, :RAGGED_FRAMES]],
        counters, want_launches)
    del video4
    rec_paired = paired_phase(card, pipe, geo, video, prompt, counters,
                              want_launches)
    rec_vae = vae_phase(card, pipe, video, latents0, cond)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------- 13. the standard CLI
    rec_infer = infer_phase(card, geo, prompt, counters)

    # ------------------------------- 14. fp8 and runtime LoRA on the 14B
    rec_fp8 = fp8_14b_phase(card, WAN21_T2V_14B, geo, gen, video, prompt,
                            want_shape, counters, lora14, latents14)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------- 15-16. the Wan2.2 A14B, edit, t2v
    pipe, rec_a14b = a14b_edit_phase(card, geo, gen, video, prompt,
                                     want_shape, counters)
    rec_t2v = a14b_t2v_phase(card, pipe, geo, prompt, counters)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------ 17. the TI2V-5B with the Wan2.2 VAE
    rec_5b = ti2v_phase(card, geo, prompt, counters)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------- 18. the entries on Wan2.2
    rec_entry22 = wan22_entries_phase(card, geo, gen, prompt, counters)

    # ----------------------------------------------------------- 19. report
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
    b1_14b = {"launches_14b": launches14["flash_attention_fwd"],
              "launches_14b_on": "14B edit",
              "launches_14b_fp8": rec_fp8["launches"]["flash_attention_fwd"],
              "launches_a14b_edit": rec_a14b["launches"][
                  "flash_attention_fwd"],
              "heads_40": timing14}
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
            **(b1_14b if kname == "flash_attention_fwd" else {}),
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
    # B1 at the 4x edit's and the ragged batch's shapes, with the launches
    # at each shape counted on its path (phases 9 and 10)
    for label, (on, rec) in (("4x self", ("4x edit", rec_4x)),
                             ("4x cross", ("4x edit", rec_4x)),
                             ("ragged self", ("ragged batch", rec_ragged))):
        rows.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"videocof_torch/csrc/{sources['flash_attention_fwd']}",
            "replaces": "videocof_tpu/ops/flash_attention.py:41",
            "tpu_kernel": replaces["flash_attention_fwd"][1],
            "launches": rec["b1_launches"][label], "launches_on": on,
            "shape_label": label,
            **timing_new[label]})
    # B1 at the Wan2.2 paths' shapes, with the launches counted on them
    # (phases 16 and 17)
    for label, (on, rec) in (("5B self", ("TI2V-5B edit", rec_5b)),
                             ("5B cross", ("TI2V-5B edit", rec_5b)),
                             ("A14B t2v self", ("A14B t2v", rec_t2v)),
                             ("A14B t2v cross", ("A14B t2v", rec_t2v))):
        rows.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"videocof_torch/csrc/{sources['flash_attention_fwd']}",
            "replaces": "videocof_tpu/ops/flash_attention.py:41",
            "tpu_kernel": replaces["flash_attention_fwd"][1],
            "launches": rec["b1_launches"][label], "launches_on": on,
            "shape_label": label, **timing22[label]})
    log("[wan2.2] " + json.dumps({"fp8_14b": rec_fp8, "a14b_edit": rec_a14b,
                                  "a14b_t2v": rec_t2v, "ti2v_5b": rec_5b,
                                  "entries": rec_entry22}))
    log(f"[smoke] phases 1-18 in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
