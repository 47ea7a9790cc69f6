"""Chain-of-frames trainer on one device.

Counterpart of `videocof_tpu/training/trainer.py`: dataset triplets ->
frozen-VAE latents in the CoF layout [src | ground | tgt] -> frozen-umT5 text
embeddings -> masked flow-matching loss (source frames stay clean, as in the
edit) -> one training step (LoRA adapters over a frozen base, or full
fine-tuning), with block remat -> a train-state checkpoint every
``save_every`` steps (`utils.checkpoint.save_train_state`). Not ported yet:
the mesh (data and sequence parallelism), which raises.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.tokenizer import WanTokenizer
from ..models.t5_encoder import T5Encoder
from ..models.wan_dit import WanDiT, make_rope_for_geometry
from ..models.wan_vae import WanVAE
from ..pipeline.wan_pipeline import _resolve_device, latent_frame_count
from ..utils import checkpoint
from .timestep_sampler import DiscreteSampling
from .train_step import (StageTimer, adamw, make_lora_train_step,
                         make_train_step)


@dataclass
class TrainerConfig:
    height: int = 480
    width: int = 832
    source_frames: int = 33
    target_frames: int = 33
    reasoning_frames: int = 4
    batch_size: int = 1
    total_steps: int = 1000
    learning_rate: float = 1e-5
    weight_decay: float = 1e-3
    grad_clip: float = 0.05          # reference ZeRO configs clip at 0.05
    mesh_data: int = 1
    mesh_seq: int = 1
    log_every: int = 10
    save_every: int = 500
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    # LoRA mode (the reference's own 14B training regime): train only rank-r
    # adapters over a frozen base; None = full fine-tuning
    lora_rank: Optional[int] = None


class CoFTrainer:
    """``CoFTrainer(dit, vae, t5, tokenizer, tcfg, device=None)``: the
    models move to ``device`` (CUDA unless ``device="cpu"``; raises without
    a GPU), VAE and T5 frozen. ``train(sample_iter)`` runs the loop."""

    def __init__(self, dit: WanDiT, vae: WanVAE, t5: T5Encoder,
                 tokenizer: Optional[WanTokenizer], tcfg: TrainerConfig,
                 device=None):
        if tcfg.mesh_data * tcfg.mesh_seq > 1:
            raise NotImplementedError("data/sequence parallel training is "
                                      "not ported")
        self.device = _resolve_device(device)
        self.dit = dit.to(self.device)
        self.vae = vae.to(self.device).requires_grad_(False)
        self.t5 = t5.to(self.device).requires_grad_(False)
        self.tokenizer = tokenizer or WanTokenizer(vocab_size=t5.cfg.vocab)
        self.tcfg = tcfg
        self.losses: List[float] = []

        tx = adamw(tcfg.learning_rate, tcfg.weight_decay, tcfg.grad_clip)
        if tcfg.lora_rank:
            init_fn, self.step_fn = make_lora_train_step(
                self.dit, tx, rank=tcfg.lora_rank)
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed + 1)
            self.state = init_fn(gen)
        else:
            init_fn, self.step_fn = make_train_step(self.dit, tx)
            self.state = init_fn()
        self.sampler = DiscreteSampling(group_num=max(1, tcfg.mesh_data))
        # timesteps and noise; successive `train` calls continue its stream
        self.generator = torch.Generator(device=self.device).manual_seed(
            tcfg.seed)

        # static CoF geometry
        tc = vae.cfg.temporal_compression_ratio
        self.f_src = latent_frame_count(tcfg.source_frames, tc)
        self.f_ground = latent_frame_count(tcfg.reasoning_frames, tc)
        self.f_tgt = latent_frame_count(tcfg.target_frames, tc)
        self.f_total = self.f_src + self.f_ground + self.f_tgt

    # ----------------------------------------------------------- preparation
    @torch.no_grad()
    def prepare_batch(self, samples) -> Dict[str, Any]:
        """List of dataset dicts (``pixel_src``, ``pixel_ground``,
        ``pixel_tgt`` [3, T, H, W] in [-1, 1], ``text``) -> device batch:
        latents ``x0`` (mu of each segment, encoded separately so each
        starts causally), ``context`` (umT5, zeroed past each prompt),
        the CoF RoPE tables and the frame mask (source = 0)."""
        pix = np.stack([np.concatenate(
            [s["pixel_src"], s["pixel_ground"], s["pixel_tgt"]], axis=1)
            for s in samples])                     # [B, 3, T_pix, H, W]
        pix = torch.as_tensor(pix, device=self.device)
        vdtype = next(self.vae.parameters()).dtype
        src_px = self.tcfg.source_frames
        grd_px = self.tcfg.reasoning_frames
        parts = [self.vae.encode(pix[:, :, lo:hi].to(vdtype))[0]
                 for lo, hi in ((0, src_px), (src_px, src_px + grd_px),
                                (src_px + grd_px, pix.shape[2]))]
        x0 = torch.cat(parts, dim=2).float()       # [B, C, f_total, h, w]

        ids, mask = self.tokenizer([s["text"] for s in samples],
                                   max_length=self.dit.cfg.text_len)
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        ctx = self.t5(ids, mask).float() * mask[..., None].float()

        ph, pw = self.dit.cfg.patch_size[1:]
        cos, sin = make_rope_for_geometry(
            self.dit.cfg, (self.f_total, x0.shape[3] // ph, x0.shape[4] // pw),
            f_src=self.f_src, f_ground=self.f_ground)
        frame_mask = torch.ones(self.f_total, device=self.device)
        frame_mask[: self.f_src] = 0.0             # source stays clean
        return {
            "x0": x0,
            "context": ctx,
            "rope_cos": torch.as_tensor(cos, device=self.device),
            "rope_sin": torch.as_tensor(sin, device=self.device),
            "frame_mask": frame_mask,
        }

    # ------------------------------------------------------------------ loop
    def train(self, sample_iter: Iterator, total_steps: Optional[int] = None,
              timings: Optional[List[Dict[str, float]]] = None):
        """Run ``total_steps`` steps (``tcfg.total_steps`` by default) and
        return the state. Losses go to ``self.losses``. With a
        ``checkpoint_dir``, the state is saved after every step whose count
        (``state.step``, which a restored state carries on) is a multiple
        of ``save_every``. A list passed as
        ``timings`` receives one dict of stage walls per step: "prepare",
        "forward+backward", "optimizer" (the device is synchronized at each
        stage boundary only then)."""
        tcfg = self.tcfg
        total_steps = total_steps or tcfg.total_steps
        t_start = time.time()
        for step in range(total_steps):
            stages = None if timings is None else {}
            clock = StageTimer(stages, self.device)
            batch = self.prepare_batch(
                [next(sample_iter) for _ in range(tcfg.batch_size)])
            batch["timesteps"] = self.sampler.sample(self.generator,
                                                     tcfg.batch_size)
            clock.tick("prepare")
            self.state, loss = self.step_fn(self.state, batch,
                                            generator=self.generator,
                                            timings=stages)
            self.losses.append(float(loss))
            if timings is not None:
                timings.append(stages)
            if step % tcfg.log_every == 0:
                print(f"[train] step {step} loss {self.losses[-1]:.4f} "
                      f"({time.time() - t_start:.0f}s)", file=sys.stderr,
                      flush=True)
            if (tcfg.checkpoint_dir and tcfg.save_every
                    and self.state.step % tcfg.save_every == 0):
                checkpoint.save_train_state(tcfg.checkpoint_dir, self.state)
                print(f"[train] checkpoint @ step {self.state.step}",
                      file=sys.stderr)
        return self.state
