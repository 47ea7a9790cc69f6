"""Device milliseconds per denoiser forward in kernels launched inside
the ``cof.dit`` span that are neither attention, GEMM nor convolution
kernels: the elementwise work, norms, RoPE and copies."""


def read(w):
    if w.trace is None or not w.edits:
        return None
    dit_us = w.trace.device_us(span="cof.dit")
    if dit_us <= 0.0:
        return None
    return w.trace.device_us("other", span="cof.dit") / 1e3 / (
        w.edits * w.family.forwards(w.config, w.mix))
