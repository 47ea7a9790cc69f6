"""The seeded streams every run draws from ``--seed``: a 63-bit sub-seed
for each named stream, and the normal draw of a weight layout on the
device in the type it is served in (a few calls a model, one a 2**30
elements, then scaled view by view). Each family draws its weights and its
units' inputs from these (`cofbench/families/`)."""

from __future__ import annotations

import hashlib
from typing import Dict

import torch


# elements a draw call fills (below 2**31, so no kernel needs 64-bit indexing)
DRAW_CHUNK = 1 << 30


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    text = ":".join(str(s) for s in (seed,) + names)
    return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=8)
                          .digest(), "big") >> 1


def draw(entries, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """{key: tensor} of a layout: normal draws over one buffer, each key a
    view of it, scaled and shifted to its mean and deviation."""
    total = sum(_numel(shape) for _, shape, _, _ in entries)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=dtype, device=device)
    for at in range(0, total, DRAW_CHUNK):
        buf[at:at + DRAW_CHUNK].normal_(generator=gen)
    out, at = {}, 0
    for key, shape, mean, std in entries:
        n = _numel(shape)
        view = buf[at:at + n].view(shape)
        view.mul_(std)
        if mean:
            view.add_(mean)
        out[key] = view
        at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
