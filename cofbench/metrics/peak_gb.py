"""Peak device memory over the window, in GB: `max_memory_allocated`
after a reset at the window's start."""


def read(w):
    return w.peak_bytes / 1e9 if w.peak_bytes else None
