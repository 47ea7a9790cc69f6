"""Model FLOP of the edits completed in the traced window (the DiT's
forwards and the VAE's encode and decodes, from shapes: `yardstick`), over
the window's seconds times the H100's bf16 peak, in percent. The text
encoder's FLOP are left out."""

from cofbench.yardstick import PEAK_BF16_FLOPS


def read(w):
    if w.trace is None or w.trace.busy_us <= 0.0 or not w.edits:
        return None
    return 100.0 * w.edits * sum(w.flops.values()) / (
        w.seconds * PEAK_BF16_FLOPS)
