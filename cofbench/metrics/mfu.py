"""Model FLOP of the units completed in the traced window (as the family
counts them from shapes: for Wan the DiT's forwards and the VAE's encode
and decodes, the text encoder left out), over the window's seconds times
the H100's bf16 peak, in percent."""

from cofbench.yardstick import PEAK_BF16_FLOPS


def read(w):
    if w.trace is None or w.trace.busy_us <= 0.0 or not w.edits:
        return None
    return 100.0 * w.edits * sum(w.flops.values()) / (
        w.seconds * PEAK_BF16_FLOPS)
