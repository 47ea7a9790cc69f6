"""Chain-of-frames training CLI, the port's twin of
`videocof_tpu/cli/train.py` (the trainer the reference never released,
`README.md:199`): LoRA or full fine-tuning of the Wan DiT on VideoCoF-style
triplet JSONs with the chain-of-frames objective, on one CUDA device or
data- and sequence-parallel over several.

Usage:
    python -m videocof_torch.cli.train --train_json data/train.json \
        --model_name /path/to/Wan2.1-T2V-14B --checkpoint_dir ckpt/ \
        --lora_rank 32 --steps 10000 --export_lora videocof.safetensors

    # over 4 ranks: 2 data-parallel x 2 sequence-parallel
    python -m torch.distributed.run --nproc_per_node=4 \
        -m videocof_torch.cli.train ... --mesh_data 2 --mesh_seq 2

Under ``torch.distributed.run`` (``WORLD_SIZE`` > 1) each rank joins the
world through `serving.multihost.init_distributed` on ``--dist_backend``
(NCCL, one card a rank; gloo serves ranks that share a card) and runs on
``cuda:<LOCAL_RANK mod the card count>``, its current device; ``--mesh_data * --mesh_seq`` is
the world size, and only rank 0 logs and writes.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from typing import Optional, Sequence

import torch

from .. import factory
from ..data.dataset import CoTTripletDataset
from ..models.lora import lora_adapters_to_state_dict
from ..training.trainer import CoFTrainer, TrainerConfig
from ..parallel import rank_device
from ..serving.multihost import init_distributed
from ..utils.checkpoint import (export_dit_state_dict, whole_state,
                                write_safetensors)


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
    p.add_argument("--dist_backend", choices=("nccl", "gloo"),
                   default="nccl",
                   help="torch.distributed backend of a multi-rank run "
                        "(gloo for ranks that share one card)")
    p.add_argument("--offload_t5", action="store_true",
                   help="Keep umT5 in host memory, on the card only while "
                        "it encodes a batch's prompts")
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
    placed = {}
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if not torch.distributed.is_initialized():
            init_distributed(backend=args.dist_backend)
        # raises without CUDA, as the factory does at one rank
        placed["device"] = rank_device()
        # NCCL's communicators and the allocator on this rank's card
        torch.cuda.set_device(placed["device"])
    main_rank = (not torch.distributed.is_initialized()
                 or torch.distributed.get_rank() == 0)
    if args.offload_t5:
        placed["offload_t5"] = True
    pipe = factory.load_pipeline(args.model_name or "",
                                 random_init=args.random_init, **placed)
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
                         device=pipe.device, offload_t5=pipe.offload_t5)
    state = trainer.train(sample_iter())
    if main_rank:
        print(f"[train] done at step {state.step}", file=sys.stderr)

    if args.export_lora and args.lora_rank and main_rank:
        sd = lora_adapters_to_state_dict(state.adapters)
        write_safetensors(args.export_lora,
                          {k: torch.from_numpy(v) for k, v in sd.items()})
        print(f"[train] exported LoRA {args.export_lora}", file=sys.stderr)

    if args.export_safetensors and not args.lora_rank:
        # an FSDP-sharded fine-tune gathers its weights on every rank first
        sd = whole_state(state.params.state_dict())
        if main_rank:
            write_safetensors(args.export_safetensors,
                              export_dit_state_dict(sd, pipe.dit.cfg))
            print(f"[train] exported {args.export_safetensors}",
                  file=sys.stderr)
    return trainer


if __name__ == "__main__":
    main()
