"""The denoiser's matrix products' share of the bf16 peak: the FLOP of the
linears of the traced units' forwards (as the family counts them), over
the device time of the GEMM kernels launched inside the ``cof.dit`` span
times 989 TFLOP/s, in percent."""

from cofbench import yardstick


def read(w):
    if w.trace is None or not w.edits:
        return None
    gemm_us = w.trace.device_us("gemm", span="cof.dit")
    if gemm_us <= 0.0:
        return None
    fam = w.family
    flops = w.edits * fam.forwards(w.config, w.mix) * fam.linear_flops(
        w.config, w.mix)
    return 100.0 * flops / (gemm_us * 1e-6 * yardstick.PEAK_BF16_FLOPS)
