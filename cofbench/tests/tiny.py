"""Tiny configurations and tiny mixes for the harness's CPU tests: the
port's test presets (WAN_TINY, VAE_TINY, T5_TINY) in the benchmark's
configuration format, a 5 + 4-frame 32 x 32 chain-of-frames edit, and a
9 + 4-frame one with RIFLEx held by the one-step check, as the 4x cell
is."""

from __future__ import annotations

import json
from pathlib import Path

from cofbench.families.wan_mix import Mix

ROOT = Path(__file__).resolve().parents[1]
CELL = "tiny.cof_edit"
# the tiny cell's limits, between the sound bf16 runs of the CPU rehearsal
# (at most 0.0067, 0.0124, 0.0037, 1.10 levels and 0.0053 on five seeds)
# and the fp8 controls (at least 0.053, 0.129, 0.033, 9.29 levels and
# 0.042)
LIMITS = {"text_rel_l2": 0.02, "source_rel_l2": 0.04,
          "latent_rel_l2": 0.012, "frame_rms": 3.0, "edit_rel_l2": 0.015}

# the one-step cell: limits between the sound bf16 runs of the CPU rehearsal
# (at most 0.0068, 0.0144, 0.0066, 1.4e-8 and 1.19 levels on six seeds)
# and the controls (at least 0.050, 0.104, 0.049, 0.031 and 10.1 levels)
STEP_CELL = "tiny.cof4x_edit"
STEP_LIMITS = {"text_rel_l2": 0.02, "source_rel_l2": 0.04,
               "step_rel_l2": 0.02, "sampler_rel_l2": 1e-4, "frame_rms": 3.5}
STEP_MIX = dict(source_frames=9, riflex_k=2, riflex_frames=8)

DIT = {"_class_name": "WanModel", "model_type": "t2v", "dim": 96,
       "ffn_dim": 256, "freq_dim": 32, "in_dim": 4, "out_dim": 4,
       "num_heads": 4, "num_layers": 2, "text_len": 16, "eps": 1e-06,
       "patch_size": [1, 2, 2], "text_dim": 64, "cross_attn_norm": True,
       "qk_norm": True}
VAE = {"dim": 8, "z_dim": 4, "dim_mult": [1, 2, 2, 2], "num_res_blocks": 1,
       "temporal_downsample": [False, True, True],
       "latent_mean": [0.1, -0.2, 0.3, 0.0],
       "latent_std": [1.5, 0.8, 1.2, 1.0]}
T5 = {"vocab": 128, "dim": 64, "dim_attn": 64, "dim_ffn": 96,
      "num_heads": 4, "num_layers": 2, "num_buckets": 8, "rel_max_dist": 128}
CONFIG = {"name": "tiny", "precision": "bf16", "family": "wan", "dit": DIT,
          "vae": VAE, "text_encoder": T5,
          "lora": [{"name": "fusionx", "format": "kohya", "rank": 4,
                    "alpha": 2.0, "multiplier": 1.0},
                   {"name": "videocof", "format": "peft", "rank": 4,
                    "multiplier": 0.5}]}


def mix_dict(**over) -> dict:
    raw = json.loads((ROOT / "traffic" / "cof_edit.json").read_text())
    raw.update(dict(height=32, width=32, source_frames=5, reasoning_frames=4,
                    text_len=16), **over)
    return raw


def mix(**over) -> Mix:
    raw = mix_dict(**over)
    return Mix(name="tiny", **{k: raw.get(k) for k in (
        "height", "width", "source_frames", "reasoning_frames", "steps",
        "shift", "guidance_scale", "sampler", "riflex_k", "riflex_frames",
        "text_len", "tasks", "words")})
