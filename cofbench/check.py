"""How ``correct`` is decided: the sampled edit's products against the
plain reference's (`reference.edit.check_products`), stage by stage, each
number held to the limit that ``cofbench/limits/<cell>.json`` gives it."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np


def rel(got, want) -> float:
    """||got - want|| / ||want||; inf where the shapes differ."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    if got.shape != want.shape:
        return float("inf")
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def numbers(prog: dict, ref: dict, source: int) -> Dict[str, float]:
    """The program's products (``context``: its prompt embeddings;
    ``latents``: its final latents; ``frames``: its served frames, [0, 1]
    floats) against the reference's:

    ``text_rel_l2``: relative L2 distance of the prompt embeddings (umT5).
    ``source_rel_l2``: of the ``source`` frozen latent frames, the VAE's
    encode of the clip. ``latent_rel_l2``: of the latents after them, the
    reasoning and edit frames the sampler made, against the reference's
    trajectory from the program's source latents and embeddings (the DiT,
    RoPE, B1 and the sampler). ``frame_rms``: root mean square of the
    served frames on their uint8 levels minus the reference's decode of
    the program's final latents, in levels (the VAE's decode). Where
    ``ref`` holds ``whole``, the reference's own edit, also
    ``edit_rel_l2``: of the latents after the source frames against it
    (the whole edit, umT5 and the VAE's encode included)."""
    lat = np.asarray(prog["latents"], np.float64)
    got = np.rint(np.asarray(prog["frames"], np.float64) * 255.0)
    want = np.asarray(ref["frames"], np.float64)
    out = {
        "text_rel_l2": rel(prog["context"], ref["context"]),
        "source_rel_l2": rel(lat[:, :, :source], ref["source"]),
        "latent_rel_l2": rel(lat[:, :, source:],
                              np.asarray(ref["latents"])[:, :, source:]),
        "frame_rms": (float(np.sqrt(np.mean((got - want) ** 2)))
                      if got.shape == want.shape else float("inf")),
    }
    if "whole" in ref:
        out["edit_rel_l2"] = rel(lat[:, :, source:],
                                 np.asarray(ref["whole"])[:, :, source:])
    return out


def limits(cell: str, root: Path) -> Dict[str, float]:
    """The limits of ``cell``'s numbers under the checkout ``root``."""
    path = root / "cofbench" / "limits" / f"{cell}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def judge(found: Dict[str, float], limit: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every number finite and within its limit, {name: {value, limit}});
    a number without a limit fails."""
    out, ok = {}, True
    for name, value in found.items():
        lim = limit.get(name)
        out[name] = {"value": value, "limit": lim}
        ok = ok and lim is not None and np.isfinite(value) and value <= lim
    return ok, out


def well_formed(frames, shape) -> bool:
    """An answer of the expected shape, finite, in [0, 1]."""
    a = np.asarray(frames)
    return (a.shape == tuple(shape) and bool(np.isfinite(a).all())
            and a.min() >= 0.0 and a.max() <= 1.0)
