"""Seconds from the process's start to the window's start: imports,
weights drawn, the pipeline built, the LoRA files merged, the kernels
built and the cell's shapes warmed up."""


def read(w):
    return w.setup_s
