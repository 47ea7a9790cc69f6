"""The DiT's matrix products' share of the bf16 peak: the FLOP of the
DiT's linears in the traced edits (`yardstick.dit_linear_flops`), over the
device time of the GEMM kernels launched inside the DiT's span times 989
TFLOP/s, in percent."""

from cofbench import yardstick


def read(w):
    if w.trace is None or not w.edits:
        return None
    gemm_us = w.trace.device_us("gemm", span="cof.dit")
    if gemm_us <= 0.0:
        return None
    cfg = w.config["dit"]
    flops = w.edits * w.mix.steps * yardstick.dit_linear_flops(
        cfg, w.mix.tokens(cfg["patch_size"]), w.mix.text_len)
    return 100.0 * flops / (gemm_us * 1e-6 * yardstick.PEAK_BF16_FLOPS)
