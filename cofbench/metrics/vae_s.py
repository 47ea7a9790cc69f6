"""Seconds of VAE work per edit: the pipeline's ``encode+latents`` and
``decode`` stage walls, averaged over the traced window's edits."""


def read(w):
    vals = [t["encode+latents"] + t["decode"] for t in w.timings
            if "encode+latents" in t and "decode" in t]
    return sum(vals) / len(vals) if vals else None
