"""Everything a run feeds the program and the reference, made from
``--seed``: weights in the published layouts (`layouts`), drawn on the
device in the type they are served in by a few normal draws a model (one
a 2**30 elements), then scaled view by view; LoRA factors; and each
edit's source clip, noise and instruction (`traffic`)."""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from . import layouts

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


def dit_weights(config: dict, seed: int, device, dtype):
    return draw(layouts.dit(config["dit"]), sub_seed(seed, "dit"), device,
                dtype)


def vae_weights(config: dict, seed: int, device, dtype):
    return draw(layouts.vae(config["vae"]), sub_seed(seed, "vae"), device,
                dtype)


def t5_weights(config: dict, seed: int, device, dtype):
    return draw(layouts.t5(config["text_encoder"]), sub_seed(seed, "t5"),
                device, dtype)


def lora_files(config: dict, seed: int, device, dtype):
    """[(LoRA state dict, multiplier)] of the configuration's ``lora`` list,
    in order; a kohya file carries its ``alpha`` per module."""
    files = []
    for spec in config.get("lora", ()):
        sd = draw(layouts.lora(config["dit"], spec["format"], spec["rank"]),
                  sub_seed(seed, "lora", spec["name"]), device, dtype)
        if spec["format"] == "kohya":
            for key in [k for k in sd if k.endswith(".lora_down.weight")]:
                sd[key[:-len(".lora_down.weight")] + ".alpha"] = torch.tensor(
                    float(spec["alpha"]))
        files.append((sd, float(spec["multiplier"])))
    return files
