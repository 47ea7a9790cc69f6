"""Standard 50-step VideoCoF edit CLI, the port's twin of the reference's
`inference.py` and of `videocof_tpu/cli/infer.py`: 50 Flow-UniPC steps at
shift 3, classifier-free guidance 5 against the default negative prompt,
TeaCache on by default.

Usage (on a CUDA device):
    python -m videocof_torch.cli.infer --video_path in.mp4 \
        --prompt "remove the dog" --output_dir out/ \
        --model_name /path/to/Wan2.1-T2V-14B \
        --videocof_path videocof.safetensors --repeat_rope
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np

from ..configs import GenerationConfig
from ..models.teacache import get_teacache_coefficients
from ._common import (add_common_args, build_pipeline_from_args, check_ported,
                      collect_items, run_items, shard_pending)

# standard-path defaults (reference `inference.py:99-126`)
NUM_INFERENCE_STEPS = 50
GUIDANCE_SCALE = 5.0
NEGATIVE_PROMPT = GenerationConfig().negative_prompt


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Standard 50-step VideoCoF inference")
    add_common_args(p)
    p.add_argument("--num_inference_steps", type=int,
                   default=NUM_INFERENCE_STEPS)
    p.add_argument("--guidance_scale", type=float, default=GUIDANCE_SCALE)
    p.add_argument("--enable_teacache", action="store_true", default=True)
    p.add_argument("--disable_teacache", dest="enable_teacache",
                   action="store_false")
    p.add_argument("--teacache_threshold", type=float, default=0.10)
    p.add_argument("--num_skip_start_steps", type=int, default=5)
    p.add_argument("--cfg_skip_ratio", type=float, default=0.0)
    return p.parse_args(argv)


def generation_kwargs(args) -> Dict:
    """TeaCache (the coefficients of ``--model_name``'s family, Wan2.1 T2V
    14B's without one) and cfg-skip, as the pipeline takes them."""
    kw = {}
    if args.enable_teacache:
        coeffs = get_teacache_coefficients(args.model_name or "wan2.1-t2v-14b")
        if coeffs:
            kw.update(enable_teacache=True,
                      teacache_threshold=args.teacache_threshold,
                      teacache_skip_start_steps=args.num_skip_start_steps,
                      teacache_coefficients=coeffs)
    if args.cfg_skip_ratio:
        kw["cfg_skip_ratio"] = args.cfg_skip_ratio
    return kw


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
    pipe = build_pipeline_from_args(args)
    return run_items(pipe, args, subset, rank,
                     num_inference_steps=args.num_inference_steps,
                     guidance_scale=args.guidance_scale,
                     negative_prompt=NEGATIVE_PROMPT,
                     gen_kwargs=generation_kwargs(args))


if __name__ == "__main__":
    main()
