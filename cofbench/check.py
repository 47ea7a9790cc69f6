"""How ``correct`` is decided: the sampled unit's products against the
plain reference's, stage by stage, as the cell's family gives the numbers
(its ``check``), each number held to the limit that
``cofbench/limits/<cell>.json`` gives it; and every answer well formed."""

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
