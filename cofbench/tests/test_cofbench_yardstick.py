"""The yardstick's counts against hand-worked tiny shapes, the profiler
reader on a hand-made trace, and shares over 100% reported as they are."""

from __future__ import annotations

import pytest
import torch

from cofbench import yardstick
from cofbench.families import wan_yardstick
from cofbench.tests import tiny
from cofbench.trace import Kernel, Trace, kernel_class, read_events
from cofbench.window import Window

CFG = {"dim": 8, "ffn_dim": 16, "num_heads": 2, "num_layers": 3,
       "in_dim": 4, "out_dim": 4, "text_dim": 6, "freq_dim": 4,
       "patch_size": [1, 2, 2]}


def test_attention_work_and_bound():
    # B1 Lq2 Lk3 N1 D4: 24 products of QK^T and 24 of PV, 2 FLOP each;
    # q and o 2x4, k and v 3x4 values of 2 bytes
    assert yardstick.attention_work(1, 2, 3, 1, 4) == (96.0, 80.0)
    assert yardstick.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert yardstick.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_dit_flops_by_hand():
    L, Lt = 10, 5
    block = (2 * L * 64 * 4 + 2 * L * 64 * 2 + 2 * Lt * 64 * 2
             + 2 * L * 8 * 16 * 2)
    io = 2 * L * 8 * 4 * (4 + 4)
    text = 2 * Lt * 8 * (6 + 8)
    time = 2 * 8 * (4 + 8 + 48)
    assert wan_yardstick.dit_linear_flops(CFG, L, Lt) == 3 * block + io \
        + text + time
    attn = 4 * L * L * 8 + 4 * L * Lt * 8
    assert wan_yardstick.dit_step_flops(CFG, L, Lt) == 3 * (block + attn) + io
    assert len(wan_yardstick.attention_calls(CFG, L, Lt)) == 6


def test_dit_step_flops_agrees_with_the_programs_count():
    from videocof_torch.configs import WAN21_T2V_14B
    from videocof_torch.utils.profiling import dit_matmul_flops
    cfg = {k: getattr(WAN21_T2V_14B, k) for k in (
        "dim", "ffn_dim", "num_layers", "in_dim", "out_dim")}
    cfg["patch_size"] = list(WAN21_T2V_14B.patch_size)
    assert wan_yardstick.dit_step_flops(cfg, 29640, 512) == dit_matmul_flops(
        WAN21_T2V_14B, 29640, 512)


def test_vae_flops_count_convolutions_from_shapes():
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.empty(1, 3, 5, 8, 8, device="meta")
    w = torch.empty(4, 3, 3, 3, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        torch.nn.functional.conv3d(x, w, padding=1)
    # 5x8x8 outputs of 4 channels, 3x27 products each, 2 FLOP a product
    assert counter.get_total_flops() == 2 * 5 * 64 * 4 * 81
    f = wan_yardstick.vae_flops(tiny.CONFIG, tiny.mix())
    assert f["encode"] > 0 and f["decode"] > 0
    assert wan_yardstick.vae_flops(tiny.CONFIG, tiny.mix(source_frames=9))[
        "encode"] > f["encode"]


def test_kernel_classes():
    assert kernel_class("void flash_fwd_kernel<bf16, 128>") == "attention"
    assert kernel_class("nvjet_tst_128x256_64x4") == "gemm"
    assert kernel_class("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert kernel_class("sm90_xmma_fprop_implicit_gemm_f32") == "conv"
    assert kernel_class("cutlass__5x_cudnn::Kernel<fprop>") == "conv"
    assert kernel_class("at::native::vectorized_elementwise_kernel") == \
        "other"


def test_trace_reader_assigns_spans_and_unions_busy_time():
    ev = [
        {"cat": "user_annotation", "name": "cof.window", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "cof.dit", "ts": 10, "dur": 40},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12,
         "dur": 1, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60,
         "dur": 1, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "nvjet_a", "ts": 20, "dur": 20,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "elementwise", "ts": 30, "dur": 20,
         "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
    ]
    tr = read_events(ev, (0, 100))
    assert [k.span for k in tr.kernels] == ["cof.dit", "cof.window"]
    assert tr.busy_us == 40.0 and tr.window_us == 100.0
    # idle: 0-20 inside cof.dit's host span at its middle (10), 50-70 and
    # 80-100 inside the window only
    assert tr.gaps == {"cof.window": 40.0, "cof.dit": 20.0}
    assert tr.device_us("gemm", span="cof.dit") == 20.0


def _window(kernel_us):
    """One traced 1.3B-shaped edit whose kernels took ``kernel_us`` each."""
    import json
    from cofbench.families.wan_mix import Mix
    from cofbench.run import ROOT
    config = json.loads((ROOT / "cofbench/configs/wan21-t2v-1.3b.json")
                        .read_text())
    mix = Mix.load(ROOT / "cofbench/traffic/cof_edit.json")
    kernels = [Kernel("flash_fwd_kernel", 0, kernel_us, "cof.dit"),
               Kernel("nvjet_x", 0, kernel_us, "cof.dit")]
    return Window(config, mix, seconds=kernel_us * 1e-6, edits=1,
                  trace=Trace(kernels, kernel_us, kernel_us),
                  flops={"dit": 1e15})


def test_shares_over_100_percent_are_reported_as_they_are():
    from cofbench.metrics import attn_roofline, gemm_roofline, mfu
    w = _window(1.0)       # a microsecond for a whole edit's work
    for reader in (attn_roofline, gemm_roofline, mfu):
        assert reader.read(w) > 100.0
    w = _window(1e9)
    for reader in (attn_roofline, gemm_roofline, mfu):
        assert 0.0 < reader.read(w) < 100.0
