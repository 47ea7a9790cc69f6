"""Seconds per DiT step: the mean of the pipeline's ``step<i>`` stage
walls (`WanPipeline.__call__(timings=)`, the device synchronised at each
stage's end) over the traced window's steps."""


def read(w):
    steps = [v for t in w.timings for k, v in t.items()
             if k.startswith("step") and not k.endswith("skipped")]
    return sum(steps) / len(steps) if steps else None
