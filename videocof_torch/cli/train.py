"""Chain-of-frames training CLI, the port's twin of
`videocof_tpu/cli/train.py` (the trainer the reference never released,
`README.md:199`): LoRA or full fine-tuning of the Wan DiT on VideoCoF-style
triplet JSONs with the chain-of-frames objective, on one CUDA device.

Usage:
    python -m videocof_torch.cli.train --train_json data/train.json \
        --model_name /path/to/Wan2.1-T2V-14B --checkpoint_dir ckpt/ \
        --lora_rank 32 --steps 10000 --export_lora videocof.safetensors
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import Optional, Sequence

import torch

from .. import factory
from ..data.dataset import CoTTripletDataset
from ..models.lora import lora_adapters_to_state_dict
from ..training.trainer import CoFTrainer, TrainerConfig
from ..utils.checkpoint import save_dit_safetensors, write_safetensors


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Chain-of-frames trainer")
    p.add_argument("--train_json", type=str, required=True)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--source_frames", type=int, default=33)
    p.add_argument("--target_frames", type=int, default=33)
    p.add_argument("--reasoning_frames", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--grad_clip", type=float, default=0.05)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_seq", type=int, default=1)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--export_safetensors", type=str, default=None,
                   help="Write final DiT weights in the torch key layout")
    p.add_argument("--lora_rank", type=int, default=None,
                   help="Train rank-r LoRA adapters over a frozen base "
                        "(the reference's 14B regime) instead of full FT")
    p.add_argument("--export_lora", type=str, default=None,
                   help="Write trained adapters as a kohya-format "
                        "safetensors file (loadable by merge_lora and the "
                        "reference's lora_utils)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> CoFTrainer:
    """Run the CLI (``argv``: the arguments, default ``sys.argv[1:]``);
    returns the trainer, whose ``state`` is the trained state. The trainer
    runs where `factory.load_pipeline` put the models (CUDA; it raises
    without a GPU)."""
    args = parse_args(argv)
    pipe = factory.load_pipeline(args.model_name or "",
                                 random_init=args.random_init)
    ds = CoTTripletDataset(
        args.train_json, data_root=args.data_root, height=args.height,
        width=args.width, source_frames=args.source_frames,
        target_frames=args.target_frames,
        reasoning_frames=args.reasoning_frames, seed=args.seed)

    def sample_iter():
        for i in itertools.count():
            yield ds[i % len(ds)]

    tcfg = TrainerConfig(
        height=args.height, width=args.width,
        source_frames=args.source_frames, target_frames=args.target_frames,
        reasoning_frames=args.reasoning_frames, batch_size=args.batch_size,
        total_steps=args.steps, learning_rate=args.lr,
        grad_clip=args.grad_clip, mesh_data=args.mesh_data,
        mesh_seq=args.mesh_seq, checkpoint_dir=args.checkpoint_dir,
        save_every=args.save_every, seed=args.seed,
        lora_rank=args.lora_rank)
    trainer = CoFTrainer(pipe.dit, pipe.vae, pipe.t5, pipe.tokenizer, tcfg,
                         device=pipe.device)
    state = trainer.train(sample_iter())
    print(f"[train] done at step {state.step}", file=sys.stderr)

    if args.export_lora and args.lora_rank:
        sd = lora_adapters_to_state_dict(state.adapters)
        write_safetensors(args.export_lora,
                          {k: torch.from_numpy(v) for k, v in sd.items()})
        print(f"[train] exported LoRA {args.export_lora}", file=sys.stderr)

    if args.export_safetensors and not args.lora_rank:
        save_dit_safetensors(args.export_safetensors, state.params,
                             pipe.dit.cfg)
        print(f"[train] exported {args.export_safetensors}", file=sys.stderr)
    return trainer


if __name__ == "__main__":
    main()
