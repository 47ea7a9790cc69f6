"""Fast 4-step VideoCoF edit CLI, the port's twin of the reference's
`fast_infer.py` and of `videocof_tpu/cli/fast_infer.py`: 4 Flow-UniPC steps
at shift 3, no CFG, the FusionX acceleration LoRA optional.

Usage (on a CUDA device):
    python -m videocof_torch.cli.fast_infer --video_path in.mp4 \
        --prompt "remove the dog" --output_dir out/ \
        --model_name /path/to/Wan2.1-T2V-14B \
        --videocof_path videocof.safetensors --enable_acceleration_lora \
        --repeat_rope
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np

from ..configs import GenerationConfig
from ._common import (add_common_args, build_pipeline_from_args, check_ported,
                      collect_items, run_items, shard_pending)

# fast-path defaults (reference `fast_infer.py:152-167`)
NUM_INFERENCE_STEPS = 4
GUIDANCE_SCALE = 1.0
NEGATIVE_PROMPT = GenerationConfig().negative_prompt


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Fast 4-step VideoCoF edit (single video or JSON list)")
    add_common_args(p)
    p.add_argument("--enable_acceleration_lora", action="store_true",
                   help="Merge the FusionX acceleration LoRA")
    p.add_argument("--acceleration_lora_path", type=str, default=None)
    p.add_argument("--num_inference_steps", type=int,
                   default=NUM_INFERENCE_STEPS)
    p.add_argument("--guidance_scale", type=float, default=GUIDANCE_SCALE)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None
         ) -> Dict[str, Dict[str, np.ndarray]]:
    """Run the CLI (``argv``: the arguments, default ``sys.argv[1:]``);
    returns {file name: the arrays written} of the items edited here."""
    args = parse_args(argv)
    check_ported(args)
    items = collect_items(args)
    subset, rank, world = shard_pending(items, args.output_dir)
    print(f"[proc {rank}/{world}] {len(subset)} pending items",
          file=sys.stderr)
    if not subset:
        return {}
    if args.enable_acceleration_lora:
        from ..factory import FUSIONX_LORA
        args.acceleration_lora = (args.acceleration_lora_path or
                                  os.path.join(args.model_name or "",
                                               FUSIONX_LORA))
    pipe = build_pipeline_from_args(args)
    return run_items(pipe, args, subset, rank,
                     num_inference_steps=args.num_inference_steps,
                     guidance_scale=args.guidance_scale,
                     negative_prompt=NEGATIVE_PROMPT)


if __name__ == "__main__":
    main()
