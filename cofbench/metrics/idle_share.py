"""The share of the traced window in which no kernel, copy or memset ran
on the device (the union of their intervals), in percent."""


def read(w):
    if w.trace is None or w.trace.busy_us <= 0.0:
        return None
    return 100.0 * (1.0 - w.trace.busy_us / w.trace.window_us)
