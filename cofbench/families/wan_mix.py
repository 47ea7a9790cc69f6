"""The Wan family's generator of chain-of-frames edits. A traffic mix is a
JSON file under ``cofbench/traffic/`` that gives the clip geometry, the
sampler settings and the instruction templates; edit ``i`` of a run with
seed ``s`` draws its source clip (uint8), its latent noise and its
instruction from streams of ``(s, i)`` alone, so a reference can draw the
same edit again."""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from cofbench.inputs import sub_seed


def latent_frames(pixel_frames: int, ratio: int = 4) -> int:
    return 1 if pixel_frames <= 1 else (pixel_frames - 1) // ratio + 1


@dataclass(frozen=True)
class Mix:
    name: str
    height: int
    width: int
    source_frames: int
    reasoning_frames: int
    steps: int
    shift: float
    guidance_scale: float
    sampler: str
    riflex_k: Optional[int]
    riflex_frames: Optional[int]
    text_len: int
    tasks: dict
    words: dict

    @classmethod
    def load(cls, path: Path) -> "Mix":
        raw = json.loads(Path(path).read_text())
        return cls(name=Path(path).stem, height=raw["height"],
                   width=raw["width"], source_frames=raw["source_frames"],
                   reasoning_frames=raw["reasoning_frames"],
                   steps=raw["steps"], shift=raw["shift"],
                   guidance_scale=raw["guidance_scale"],
                   sampler=raw["sampler"], riflex_k=raw.get("riflex_k"),
                   riflex_frames=raw.get("riflex_frames"),
                   text_len=raw["text_len"], tasks=raw["tasks"],
                   words=raw["words"])

    def latent_grid(self, spatial: int = 8, temporal: int = 4):
        """(source, ground, total) latent frames and the latent H, W."""
        src = latent_frames(self.source_frames, temporal)
        ground = latent_frames(self.reasoning_frames, temporal)
        return (src, ground, 2 * src + ground, self.height // spatial,
                self.width // spatial)

    def tokens(self, patch=(1, 2, 2)) -> int:
        _, _, frames, h, w = self.latent_grid()
        return (frames // patch[0]) * (h // patch[1]) * (w // patch[2])

    def instruction(self, seed: int, index: int) -> str:
        rng = random.Random(sub_seed(seed, "prompt", index))
        task = rng.choice(sorted(self.tasks))
        template = rng.choice(self.tasks[task])
        fields = {k: rng.choice(v) for k, v in sorted(self.words.items())}
        return template.format(**fields)

    def edit(self, seed: int, index: int, z_dim: int, device) -> dict:
        """Edit ``index``'s inputs: ``clip`` uint8 [1, 3, T, H, W] on the
        device, ``noise`` float32 [1, z, ground + source latents, h, w] on
        the device, and ``prompt``."""
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "clip", index))
        clip = torch.randint(0, 256, (1, 3, self.source_frames, self.height,
                                      self.width), generator=gen,
                             device=device, dtype=torch.uint8)
        src, ground, _, h, w = self.latent_grid()
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "noise", index))
        noise = torch.randn((1, z_dim, src + ground, h, w), generator=gen,
                            device=device, dtype=torch.float32)
        return {"clip": clip, "noise": noise,
                "prompt": self.instruction(seed, index)}
