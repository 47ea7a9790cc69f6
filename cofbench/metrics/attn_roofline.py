"""The attention kernels' share of their roofline: the sum of the bounds
of the attention calls of the traced units' forwards (as the family gives
them at the cell's shapes; q, k, v read once and o written once, against
989 TFLOP/s and 3.35 TB/s), over the summed device time of the port's
attention kernels (`trace.ATTENTION_KERNELS`), in percent."""

from cofbench import yardstick


def read(w):
    if w.trace is None or not w.edits:
        return None
    kernel_us = w.trace.device_us("attention")
    if kernel_us <= 0.0:
        return None
    fam = w.family
    bound = sum(yardstick.bound_s(*yardstick.attention_work(*c))
                for c in fam.attention_calls(w.config, w.mix))
    return 100.0 * w.edits * fam.forwards(w.config, w.mix) * bound / (
        kernel_us * 1e-6)
